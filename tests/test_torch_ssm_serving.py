"""The port's serving stack on the SSM family (reduced mamba2-130m, f32).

* Greedy session streams from the port's ``SlotScheduler`` equal the JAX
  ``SlotScheduler``'s on the same (bridged) weights, staggered admission
  of 3 prompts on 2 slots (prompt lengths whose chunk is 1, 2 and 8).
* Frozen rows (inactive or EOS-finished) keep their ``ssm`` / ``conv``
  state bit-identical; EOS freezes a session; no row ever resyncs.
* The four layouts hold the recurrent state dense and serve the same
  streams; ``--layout`` gives the JAX launcher's verdict.
* ``repro_torch.launch.serve --arch mamba2_130m`` matches its solo runs.
* A ``cuda``-marked test holds both K4 entries against their plain
  versions on the card (skipped without one).
"""
import numpy as np
import pytest
import torch

try:    # the GPU machine has no JAX: only the cuda test runs there
    from parity import make_prompts, serve_streams
    from torch_parity import port_streams, ssm_pair
except ImportError:
    ssm_pair = None
from repro_torch.kernels import ssd_scan as SS
from repro_torch.launch import serve
from repro_torch.models.api import build_decode, build_model, decode_chunk
from repro_torch.models.layouts import LayoutSpec
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)
PROMPT_LENS = (21, 34, 16)          # chunks 1, 2 and 8 (ssm_chunk 8)
LAYOUTS = ("dense", "int8", "paged", "paged_int8")


@pytest.fixture(scope="module")
def ssm():
    """(JAX cfg, JAX params, the port's cfg, bridged params)."""
    if ssm_pair is None:
        pytest.skip("the JAX references need JAX (absent on the GPU "
                    "machine)")
    return ssm_pair()


def test_scheduler_streams_equal_jax_scheduler(ssm):
    jcfg, jparams, cfg, params = ssm
    prompts = make_prompts(jcfg, PROMPT_LENS)
    ref, _ = serve_streams(jcfg, jparams, prompts, gen=14)
    got, sched = port_streams(cfg, params, prompts, gen=14)
    assert got == ref
    assert set(sched.resyncs.values()) == {0}   # no periodic sync
    assert not sched._paged


@pytest.mark.parametrize("kind", LAYOUTS)
def test_every_layout_holds_the_state_dense_and_serves_the_same(ssm, kind):
    _, _, cfg, params = ssm
    prompts = make_prompts(cfg, PROMPT_LENS, seed=6)
    ref, _ = port_streams(cfg, params, prompts, gen=10)
    spec = LayoutSpec(kind=kind, page_size=16, pool_pages=8) \
        if kind.startswith("paged") else kind
    got, sched = port_streams(cfg, params, prompts, spec, gen=10)
    assert got == ref
    assert sorted(sched.state.kv) == ["conv", "ssm"]
    assert sched.state.kv["ssm"].dtype == torch.float32
    assert not sched._paged


def _snapshot(state, slot):
    return {n: t.select(state.axes[n], slot).clone()
            for n, t in state.merged().items()}


def test_frozen_rows_keep_their_state_bit_identical(ssm):
    """Inactive and EOS-finished rows: ssm, conv and len unchanged."""
    _, _, cfg, params = ssm
    dec = build_decode(cfg, device="cpu")
    p = dec.prepare_params(params)
    state = dec.init_state(3, 64)
    for slot, prompt in enumerate(make_prompts(cfg, (13, 9, 16), seed=12)):
        _, state = dec.prefill_into_slot(p, state, slot, prompt)
    state.bookkeeping["done"][1] = True          # EOS-finished row
    before = [_snapshot(state, s) for s in (1, 2)]
    live_before = _snapshot(state, 0)
    token = torch.tensor([3, 4, 5], dtype=torch.int32)
    toks, state, resyncs = decode_chunk(
        dec, p, state, token, [None] * 3, np.zeros(3),
        active=np.array([True, True, False]), n_steps=5,
        eos=np.full(3, -1, np.int32))
    assert not resyncs.any()
    for slot, snap in zip((1, 2), before):
        after = _snapshot(state, slot)
        for name, t in snap.items():
            assert torch.equal(t, after[name]), (slot, name)
    assert toks[1].eq(4).all() and toks[2].eq(5).all()
    after = _snapshot(state, 0)
    assert not torch.equal(after["ssm"], live_before["ssm"])
    assert after["len"].item() == live_before["len"].item() + 5


def test_masked_writes_equal_copy_and_select(ssm):
    """The in-place step with masked writes equals stepping every row and
    selecting the old rows back (the JAX way)."""
    _, _, cfg, params = ssm
    dec = build_decode(cfg, device="cpu")
    p = dec.prepare_params(params)
    toks = make_prompts(cfg, (13, 13, 13), seed=16)
    token = torch.tensor([7, 8, 9], dtype=torch.int32)
    live = torch.tensor([True, False, True])
    _, masked = dec.prefill(p, {"tokens": np.stack(toks)}, 64)
    _, full = dec.prefill(p, {"tokens": np.stack(toks)}, 64)
    _, before = dec.prefill(p, {"tokens": np.stack(toks)}, 64)
    lm, _ = dec.raw_step(p, masked, token, live=live)
    lf, _ = dec.raw_step(p, full, token)
    selected = full.where_rows(live, before)
    for name, t in masked.merged().items():
        assert torch.equal(t, selected.merged()[name]), name
    assert torch.equal(lm[live], lf[live])


def test_eos_freezes_a_session(ssm):
    _, _, cfg, params = ssm
    prompts = make_prompts(cfg, (13,), seed=14)
    free, _ = port_streams(cfg, params, prompts, gen=12)
    eos = free[0][4]
    got, sched = port_streams(cfg, params, prompts, gen=12, eos_id=eos)
    assert got[0] == free[0][:free[0].index(eos) + 1]
    assert not sched.active.any()


def test_engine_records_hit_steps_only(ssm):
    _, _, cfg, params = ssm
    prompts = np.stack(make_prompts(cfg, (13, 13), seed=8))
    api = build_model(cfg, device="cpu")
    eng = Engine(api, params, max_len=64, device="cpu")
    fast = eng.generate({"tokens": prompts}, 10)
    slow = eng.generate({"tokens": prompts}, 10, record_stats=True)
    np.testing.assert_array_equal(fast, slow)
    assert sum(s.kind == "hit" for s in eng.stats) == 9
    assert not any(s.kind == "miss" for s in eng.stats)


# sessions 2 x (prompt 64 / 69 + gen 64 + 64) -> max_len 197 -> 13 pages of
# 16 per slot, 26 in the full pool of 2 slots; the uniform batch needs 48
@pytest.mark.parametrize("flags,accepted", [
    (["--sessions", "2", "--pool-pages", "26"], True),
    (["--sessions", "2", "--pool-pages", "27"], False),
    (["--pool-pages", "10"], False),
    (["--layout", "int8"], True)])
def test_layout_flags_validated_like_jax_on_ssm(flags, accepted, capsys):
    from repro.config import get_config as jax_get_config
    from repro.launch import serve as jax_serve
    argv = ["--arch", "mamba2_130m", "--layout", "paged", "--page-size",
            "16"] + flags

    def verdict(fn):
        try:
            fn()
        except SystemExit as e:
            assert e.code == 2
            return False
        return True

    ap = serve.build_parser()
    args = ap.parse_args(argv)
    max_len = serve.sessions_max_len(args) if args.sessions \
        else serve.batch_max_len(args)
    jax_ok = verdict(lambda: jax_serve.validate_layout_args(
        ap, jax_get_config(args.arch), args, max_len))
    assert verdict(lambda: serve.parse_args(argv)) == jax_ok == accepted
    err = capsys.readouterr().err
    assert accepted or "--pool-pages" in err


def test_serve_sessions_cli_matches_solo_runs(capsys):
    rc = serve.main(["--arch", "mamba2_130m", "--reduced", "--sessions", "3",
                     "--slots", "2", "--gen", "12", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("matches solo run: True") == 3, out
    assert "0 resyncs" in out


def test_serve_batch_and_profile_step_on_cpu(capsys):
    from repro_torch.launch import profile_step
    assert serve.main(["--arch", "mamba2_130m", "--reduced", "--batch", "2",
                       "--prompt-len", "12", "--gen", "6",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill (admission of the batch)" in out
    assert "cache-hit steps" in out and "cache-miss" not in out
    assert profile_step.main(["--arch", "mamba2_130m", "--reduced",
                              "--batch", "1", "--prompt-len", "12",
                              "--steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[profile] hit: wall" in out and "[profile] admit: wall" in out
    assert "resync" not in out


@pytest.mark.cuda
def test_cuda_ssd_kernels_vs_plain():
    """Both K4 launches against the plain mirror of their ragged tiling
    (each launch on the mirror's inputs), f32 tolerance 1e-4 of the
    output's scale (bf16 y: 2e-2): L 1, 29 (one short chunk), 605 and 1024
    (ragged and whole), B 1 and 4, with and without an initial state, a
    chunk below 64, bf16 inputs, and the mixer's strided slices."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (their plain versions are tested above)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [  # B, L, H, P, N, Q, init, dtype
        (1, 1, 4, 64, 128, 64, True, torch.float32),
        (4, 1, 3, 16, 16, 64, False, torch.float32),
        (1, 29, 3, 16, 16, 64, False, torch.float32),
        (4, 29, 24, 64, 128, 64, True, torch.float32),
        (1, 605, 24, 64, 128, 64, False, torch.float32),
        (4, 605, 8, 32, 64, 64, True, torch.float32),
        (1, 1024, 24, 64, 128, 64, True, torch.float32),
        (4, 1024, 24, 64, 128, 64, False, torch.float32),
        (2, 130, 4, 64, 128, 32, True, torch.float32),
        (1, 605, 24, 64, 128, 64, True, torch.bfloat16),
        (4, 1024, 24, 64, 128, 64, False, torch.bfloat16)]
    for B, L, H, P, N, Q, init, dtype in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        # x, b, c as the mixer slices them from one conv output
        xbc = rnd(B, L, H * P + 2 * N).to(dtype)
        x = xbc[..., :H * P].reshape(B, L, H, P)
        b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt = torch.nn.functional.softplus(rnd(B, L, H) - 3.0)
        a = -torch.arange(1, H + 1, device=dev, dtype=torch.float32)
        s0 = rnd(B, H, P, N) if init else None
        y, st = SS.ssd_intra_chunk_cuda(x, dt, a, b, c, Q)
        yr, str_ = SS.ssd_intra_chunk_tiled_plain(x, dt, a, b, c, Q)
        y2, f = SS.ssd_chunk_scan_cuda(yr, str_, dt, a, c, Q, s0)
        y2r, fr = SS.ssd_chunk_scan_tiled_plain(yr, str_, dt, a, c, Q, s0,
                                                dtype)
        torch.cuda.synchronize()
        assert y2.dtype == dtype and f.dtype == torch.float32
        ytol = 1e-4 if dtype == torch.float32 else 2e-2
        for got, ref, tol in ((y, yr, 1e-4), (st, str_, 1e-4),
                              (y2, y2r, ytol), (f, fr, 1e-4)):
            scale = max(1.0, ref.float().abs().max().item())
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= tol * scale, (B, L, H, P, N, Q, init, dtype, err)
