"""The port's training I/O against the JAX package's: the data pipeline's
batches (bit-equal), checkpoints read across in both directions
(bit-equal leaves, and the same file bytes for the same state), the
checkpoint module's own msgpack codec against the ``msgpack`` package
(here only: the port never imports it), and the train launcher on the
CPU.  The ``cuda``-marked test runs one train step on the card (K2's
forward and backward kernels, no plain version) against the CPU plain
path, and skips without a GPU.
"""
import numpy as np
import pytest
import torch

try:    # the GPU machine has no JAX: only the cuda test runs there
    import jax
    import msgpack
    from repro.data import pipeline as JP
    from repro.training import checkpoint as JCK
    from repro.training import optim as JO
except ImportError:
    jax = None
from repro_torch import bridge, runtime
from repro_torch.data import pipeline as PP
from repro_torch.training import checkpoint as PCK
from repro_torch.training import optim as PO

torch.set_num_threads(1)


def _need_jax():
    if jax is None:
        pytest.skip("the JAX references need JAX (absent on the GPU machine)")


@pytest.mark.parametrize("kind", ["synthetic", "text"])
def test_batches_bit_equal_to_jax(kind, tmp_path):
    _need_jax()
    path = tmp_path / "corpus.txt"
    path.write_text("TConstFormer: constant-time attention. " * 40 +
                    "café — λ\n")
    kw = dict(vocab_size=301, seq_len=33, batch_size=3, seed=5, kind=kind,
              text_path=str(path) if kind == "text" else "")
    want = list(JP.batches(JP.DataConfig(**kw), epoch=1, steps=3))
    got = list(PP.batches(PP.DataConfig(**kw), epoch=1, steps=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["tokens"].dtype == w["tokens"].dtype
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return PCK._record(x)["data"]
    return np.asarray(x).tobytes()


def _jax_state():
    """A JAX train state with every kind of leaf the format holds: f32
    params, an int32 step, bf16 moments, a factored ``{vr, vc}``."""
    from torch_parity import train_pair
    jparams = train_pair("tconst")[1]
    cfg = JO.AdamWConfig(state_dtype="bfloat16", factored=True)
    st = JO.init_opt_state(jparams, cfg)
    leaves, tdef = jax.tree_util.tree_flatten(st)
    rs = np.random.RandomState(0)
    leaves = [jax.numpy.asarray(rs.randn(*l.shape).astype(np.float32)
                                ).astype(l.dtype) if l.ndim else
              jax.numpy.int32(7) for l in leaves]
    return jparams, cfg, jax.tree_util.tree_unflatten(tdef, leaves)


def _port_reference(cfg):
    from torch_parity import train_pair
    params = train_pair("tconst")[3]
    return params, PO.init_opt_state(params, PO.AdamWConfig(
        state_dtype=cfg.state_dtype, factored=cfg.factored))


def _restore(cfg, path):
    """The train state at ``path`` restored into the port's structure."""
    params, opt = _port_reference(cfg)
    return PCK.restore_pytree({"params": params, "opt": opt._asdict()},
                              path)


def test_jax_checkpoint_restores_into_the_port_bit_equal(tmp_path):
    _need_jax()
    jparams, cfg, jopt = _jax_state()
    path = JCK.save_train_state(jparams, jopt, 7, str(tmp_path))
    want = jax.tree_util.tree_leaves({"params": jparams,
                                      "opt": jopt._asdict()})
    got = PO.tree_leaves(_restore(cfg, path))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert _bits(g) == _bits(w)


def test_port_checkpoint_restores_into_jax_bit_equal(tmp_path):
    _need_jax()
    jparams, cfg, jopt = _jax_state()
    jpath = JCK.save_train_state(jparams, jopt, 7, str(tmp_path / "jax"))
    state = _restore(cfg, jpath)
    path = PCK.save_train_state(state["params"], PO.OptState(**state["opt"]),
                                7, str(tmp_path / "port"))
    assert path.endswith("ckpt_00000007.msgpack")
    # the same state gives the same file
    assert open(path, "rb").read() == open(jpath, "rb").read()
    back = JCK.restore_pytree({"params": jparams, "opt": jopt._asdict()},
                              path)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves({"params": jparams,
                                               "opt": jopt._asdict()})):
        assert g.dtype == w.dtype and _bits(g) == _bits(w)


def test_codec_matches_the_msgpack_package():
    _need_jax()
    obj = {
        "fixmap": {"a": 1, "b": [1, 2, 3]},
        "map16": {f"k{i}": i for i in range(20)},
        "strs": ["", "x" * 31, "y" * 40, "z" * 300, "λ" * 40000],
        "bins": [b"", b"\x00" * 255, b"\x01" * 300, b"\x02" * 70000],
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                 -2 ** 31, -2 ** 31 - 1, -2 ** 63],
        "array16": list(range(20)),
        "nested": [[], {}, [[1], {"x": b"y"}]],
        "rec": {"dtype": "float32", "shape": [2, 3],
                "data": np.arange(6, dtype=np.float32).tobytes()},
    }
    packed = msgpack.packb(obj)
    assert PCK.packb(obj) == packed
    assert PCK.unpackb(packed) == msgpack.unpackb(packed)
    assert PCK.unpackb(PCK.packb(obj)) == obj
    for other in (None, True, 1.5):      # outside the format's subset
        with pytest.raises(TypeError):
            PCK.packb(other)
        with pytest.raises(ValueError):
            PCK.unpackb(msgpack.packb(other))


def test_opt_state_bridges_both_ways():
    """JAX's optimizer state (int32 step, bf16 moments, a factored
    ``{vr, vc}``) into the port and back: the same values (bf16 comes back
    as its exact float32 values)."""
    _need_jax()
    _, _, jopt = _jax_state()
    port = bridge.opt_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jopt))
    assert port.step.dtype == torch.int32 and int(port.step) == 7
    back = bridge.opt_state_to_jax(port)
    want = jax.tree_util.tree_leaves(jopt._asdict())
    got = PO.tree_leaves(back)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32)
                                      if w.dtype == jax.numpy.bfloat16
                                      else np.asarray(w))
    assert set(port.v["blocks"]["layers"][0]["attn"]["wq"]) == {"vr", "vc"}


def test_train_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    rc = train.main(["--arch", "tconst-41m", "--reduced", "--steps", "3",
                     "--batch", "2", "--seq", "16", "--log-every", "1",
                     "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    steps = [line for line in out.splitlines() if "loss=" in line]
    assert len(steps) == 3 and all("gnorm=" in s and "tok/s=" in s
                                   for s in steps)
    assert "mode=tconst device=cpu" in out
    blob = PCK.unpackb((tmp_path / "ckpt_00000003.msgpack").read_bytes())
    assert blob["opt/step"]["dtype"] == "int32"
    assert np.frombuffer(blob["opt/step"]["data"], np.int32)[0] == 3
    assert "params/blocks/layers/0/attn/wq" in blob


@pytest.mark.cuda
def test_cuda_train_step_runs_the_kernels_and_matches_the_cpu():
    """One f32 train step of reduced tconst-41m (tconst and tlin) and its
    base transformer on the card: K2's forward and backward kernels run,
    no plain version; loss and gradients within 1e-4 (relative to each
    leaf's largest |entry|) of the CPU plain path on the same params."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    from repro_torch.config import get_config, reduced
    from repro_torch.models.api import build_model
    from repro_torch.training.train_step import loss_and_grads
    toks = np.random.RandomState(0).randint(0, 512, size=(2, 32))
    for mode in ("tconst", "tlin", "full"):
        cfg = reduced(get_config("tconst-41m"), dtype="float32").replace(
            attention_mode=mode)
        cpu = build_model(cfg, device="cpu")
        params = bridge.stack_params(cpu.init(0))
        want_loss, want = loss_and_grads(cpu, params, {
            "tokens": torch.from_numpy(toks)})
        card = build_model(cfg, device="cuda")
        runtime.reset_counters()
        loss, grads = loss_and_grads(
            card, PO.tree_map(lambda p: p.cuda(), params),
            {"tokens": torch.from_numpy(toks).cuda()})
        torch.cuda.synchronize()
        counts = runtime.read_counters()
        for name in ("flash_attention", "flash_attention_bwd"):
            assert counts[name]["kernel"] > 0 and counts[name]["plain"] == 0
        assert abs(float(loss) - float(want_loss)) <= 1e-4
        for g, w in zip(PO.tree_leaves(grads), PO.tree_leaves(want)):
            scale = max(float(w.abs().max()), 1e-12)
            assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale
