"""The port's serving stack on the attention LMs (reduced smollm, the
paper's base transformer, ``tconst-41m`` in ``full`` mode, and the MoE
family: reduced deepseek and mixtral; f32, CPU).

* Greedy ``SlotScheduler`` streams equal the JAX scheduler's on the same
  (bridged) weights on dense, int8, paged and paged_int8; on the paged
  layouts the pool (7 pages of 16 for 3 slots x 8 pages) is under-sized,
  so an admission waits for pages a finished session frees.  DeepSeek's
  ``dense_k`` / ``dense_v`` go through every layout beside ``k`` / ``v``
  (one page table; int8 quantize-on-write; ``kv_bytes``,
  ``assigned_kv_bytes``, ``with_slot``, ``where_rows``).
* ``prefill_into_slot`` takes ``max_len`` from the state's K/V buffers;
  the SSM family's admission is unchanged (no positional buffer).
* Frozen rows (inactive or EOS-finished) keep their K/V and ``len``
  bit-identical; the KV bytes grow with ``max_len`` (paper Fig 8g).
* ``repro_torch.launch.serve --arch smollm-360m --sessions`` (and
  ``--arch deepseek_moe_16b`` / ``mixtral_8x22b --reduced``) matches its
  solo runs.
* ``cuda``-marked tests serve reduced smollm and reduced deepseek on each
  layout on the card against the CPU plain path (skipped without one).
"""
import numpy as np
import pytest
import torch

try:    # the GPU machine has no JAX: only the cuda test runs there
    from parity import make_prompts, serve_streams
    from repro.models import layouts as JLT
    from torch_parity import lm_pair, port_streams, ssm_pair
except ImportError:
    lm_pair = None
from repro_torch import runtime
from repro_torch.config import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import layouts as PLT
from repro_torch.models import lm as LM
from repro_torch.models.api import build_decode, build_model, decode_chunk
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)
PROMPT_LENS = (21, 34, 17)
LAYOUTS = ("dense", "int8", "paged", "paged_int8")


def _need_jax():
    if lm_pair is None:
        pytest.skip("the JAX references need JAX (absent on the GPU "
                    "machine)")


def _spec(mod, kind, pool=None):
    return mod.LayoutSpec(kind=kind, page_size=16, pool_pages=pool)


@pytest.mark.parametrize("name,kind", [
    ("smollm", "dense"), ("smollm", "int8"), ("smollm", "paged"),
    ("smollm", "paged_int8"), ("full", "paged_int8"), ("gemma3", "paged"),
    ("deepseek", "dense"), ("deepseek", "paged_int8"), ("mixtral", "paged")])
def test_scheduler_streams_equal_jax_scheduler(name, kind):
    _need_jax()
    jcfg, jparams, cfg, params = lm_pair(name)
    prompts = make_prompts(jcfg, PROMPT_LENS)
    pool = 7 if kind.startswith("paged") else None
    ref, _ = serve_streams(jcfg, jparams, prompts, _spec(JLT, kind, pool),
                           gen=14, slots=3)
    got, sched = port_streams(cfg, params, prompts, _spec(PLT, kind, pool),
                              gen=14, slots=3)
    assert got == ref
    assert set(sched.resyncs.values()) == {0}     # no periodic sync
    assert sched._paged == kind.startswith("paged")
    if sched._paged:
        assert sched.page_waits >= 1, "no admission waited for pages"
        assert sorted(sched.free_pages) == list(range(7))


@pytest.mark.parametrize("kind", LAYOUTS)
def test_prefill_into_slot_takes_max_len_from_the_state(kind):
    """The admitted row is as long as the state's K/V buffers (not the
    prompt): the slot holds the batch-1 prefill at the state's max_len,
    the other slots stay empty."""
    cfg = reduced(get_config("smollm_360m"), dtype="float32")
    params = LM.init_lm(cfg, 1)
    dec = build_decode(cfg, _spec(PLT, kind), device="cpu")
    state = dec.init_state(3, 40)
    prompt = np.arange(1, 14, dtype=np.int32)
    lg, state = dec.prefill_into_slot(params, state, 1, prompt)
    ref_lg, ref = LM.lm_prefill(params, torch.as_tensor(prompt)[None], cfg,
                                40)
    assert torch.equal(lg, ref_lg[0])
    merged = state.merged()
    assert merged["len"].tolist() == [0, 13, 0]
    for f in ("k", "v"):
        assert merged[f].shape[2] == 40
        got = merged[f][:, 1]
        if "int8" in kind:
            q, s = PLT.quantize_int8(ref[f][:, 0])
            assert torch.equal(got, PLT.dequantize_int8(q, s, torch.float32))
        else:
            assert torch.equal(got, ref[f][:, 0])
        assert not merged[f][:, 0].any() and not merged[f][:, 2].any()


def test_ssm_admission_is_unchanged():
    """The SSM state has no positional buffer: the admission is the
    batch-1 prefill at the prompt's own length, bit for bit."""
    _need_jax()
    _, _, cfg, params = ssm_pair(tiny=True)
    dec = build_decode(cfg, device="cpu")
    state = dec.init_state(2, 64)
    prompt = np.arange(1, 12, dtype=np.int32)
    assert dec._max_len(state, 11) == 11
    lg, state = dec.prefill_into_slot(params, state, 0, prompt)
    ref_lg, ref = LM.lm_prefill(params, torch.as_tensor(prompt)[None], cfg,
                                11)
    assert torch.equal(lg, ref_lg[0])
    for f in ("ssm", "conv"):
        assert torch.equal(state.kv[f][:, 0], ref[f][:, 0])


def _snapshot(state, slot):
    return {n: t.select(state.axes[n], slot).clone()
            for n, t in state.merged().items()}


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_frozen_rows_keep_their_cache_bit_identical(kind):
    """Inactive and EOS-finished rows: K/V and len unchanged; the live
    row's K/V grows by one slot a step."""
    cfg = reduced(get_config("tconst_41m"), dtype="float32",
                  attention_mode="full")
    dec = build_decode(cfg, _spec(PLT, kind), device="cpu")
    p = dec.prepare_params(LM.init_lm(cfg, 2))
    state = dec.init_state(3, 48)
    rng = np.random.RandomState(12)
    for slot, n in enumerate((13, 9, 16)):
        _, state = dec.prefill_into_slot(
            p, state, slot, rng.randint(1, cfg.vocab_size, size=n))
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
    assert after["len"].item() == 18
    assert torch.equal(after["k"][:, :13], live_before["k"][:, :13])
    assert after["k"][:, 13:18].abs().sum(-1).gt(0).all()
    assert not after["k"][:, 18:].any()


def test_kv_bytes_grow_with_max_len_for_the_base_tconst_constant():
    """Paper Fig 8g: the base transformer's KV bytes are linear in
    max_len (layers x 2 x KV x hd x max_len x 4 B a slot in f32);
    tconst's are constant."""
    base = reduced(get_config("tconst_41m"), dtype="float32",
                   attention_mode="full")
    tconst = reduced(get_config("tconst_41m"), dtype="float32")
    per_slot = base.n_layers * 2 * base.n_kv_heads * \
        base.resolved_head_dim * 4
    sizes = {}
    for cfg in (base, tconst):
        api = build_model(cfg, device="cpu")
        for max_len in (64, 128):
            eng = Engine(api, api.init(0), max_len=max_len, device="cpu")
            sizes[cfg.attention_mode, max_len] = eng.cache_bytes(2)
    assert sizes["full", 64] == 2 * 64 * per_slot
    assert sizes["full", 128] == 2 * 128 * per_slot
    assert sizes["tconst", 64] == sizes["tconst", 128]


def test_engine_records_hit_steps_only_and_matches_chunked():
    cfg = reduced(get_config("smollm_360m"), dtype="float32")
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    prompts = np.random.RandomState(8).randint(1, cfg.vocab_size,
                                               size=(2, 13))
    eng = Engine(api, params, max_len=64, device="cpu",
                 layout=_spec(PLT, "paged"))
    fast = eng.generate({"tokens": prompts}, 10)
    slow = eng.generate({"tokens": prompts}, 10, record_stats=True)
    np.testing.assert_array_equal(fast, slow)
    assert sum(s.kind == "hit" for s in eng.stats) == 9
    assert not any(s.kind == "miss" for s in eng.stats)
    with pytest.raises(ValueError, match="under-sized"):
        build_decode(cfg, _spec(PLT, "paged", 3), device="cpu").prefill(
            eng.params, {"tokens": prompts}, 64)


@pytest.mark.parametrize("flags", [[], ["--layout", "paged", "--page-size",
                                        "16", "--pool-pages", "12"]])
def test_serve_sessions_cli_matches_solo_runs(flags, capsys):
    rc = serve.main(["--arch", "smollm-360m", "--reduced", "--sessions", "3",
                     "--slots", "2", "--gen", "12", "--prompt-len", "20",
                     "--device", "cpu"] + flags)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("matches solo run: True") == 3, out
    assert "0 resyncs" in out and "mode=full" in out


def test_profile_step_mode_full_on_cpu(capsys):
    from repro_torch.launch import profile_step
    assert profile_step.main(["--mode", "full", "--reduced", "--batch", "1",
                              "--prompt-len", "12", "--steps", "2",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[profile] hit: wall" in out and "[profile] admit: wall" in out
    assert "resync" not in out


@pytest.mark.parametrize("arch", ["smollm-360m", "tconst-41m"])
def test_dense_lms_build_on_cuda_by_default(arch):
    """``build_model`` of smollm-360m and of the base transformer runs on
    cuda unless the CPU is asked for; with no GPU that is an error."""
    cfg = get_config(arch, attention_mode="full")
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    api = build_model(cfg, device="cpu")
    assert api.device.type == "cpu" and type(api.decode).__name__ == \
        "DenseDecode"


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mixtral_8x22b"])
def test_moe_family_builds_on_cuda_by_default(arch):
    """The MoE family's ``build_model`` runs on cuda unless the CPU is
    asked for (no GPU: an error), and serves through ``DenseDecode``."""
    cfg = get_config(arch)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    api = build_model(cfg, device="cpu")
    assert api.device.type == "cpu" and type(api.decode).__name__ == \
        "DenseDecode"


@pytest.mark.parametrize("kind", LAYOUTS)
def test_moe_dense_fields_through_layouts(kind):
    """Reduced deepseek (one dense layer, one MoE layer): ``dense_k`` /
    ``dense_v`` ride every layout beside ``k`` / ``v`` -- int8 fields and
    pages on the one page table, ``kv_bytes`` of the physical buffers,
    ``assigned_kv_bytes`` of the admitted slot's pages -- and
    ``with_slot`` writes the admitted row's prefill into both, leaving the
    other slots empty; ``where_rows`` keeps the unselected slot."""
    cfg = reduced(get_config("deepseek_moe_16b"), dtype="float32")
    params = LM.init_lm(cfg, 1)
    dec = build_decode(cfg, _spec(PLT, kind, 5 if "paged" in kind else
                                  None), device="cpu")
    state = dec.init_state(2, 40)
    names = {f.replace("__q", "").replace("__scale", "") for f in state.kv}
    assert names == {"k", "v", "dense_k", "dense_v"}
    KV, hd, max_len = cfg.n_kv_heads, cfg.resolved_head_dim, 40
    per_vec = KV * (hd + 4) if "int8" in kind else KV * hd * 4
    if "paged" in kind:
        slots_bytes = (5 + 1) * 16 * per_vec      # the pool + trash page
        state.bookkeeping[PLT.PAGE_TABLE][1, :2] = torch.tensor([3, 0])
    else:
        slots_bytes = 2 * max_len * per_vec
    assert state.kv_bytes() == 2 * cfg.n_layers * slots_bytes
    prompt = np.arange(1, 18, dtype=np.int32)
    before = state.merged()
    _, state = dec.prefill_into_slot(params, state, 1, prompt)
    _, ref = LM.lm_prefill(params, torch.as_tensor(prompt)[None], cfg,
                           max_len)
    merged = state.merged()
    for f in ("k", "v", "dense_k", "dense_v"):
        got = merged[f][:, 1]
        want = ref[f][:, 0]
        if "int8" in kind:
            want = PLT.dequantize_int8(*PLT.quantize_int8(want),
                                       torch.float32)
        assert torch.equal(got[:, :17], want[:, :17]), f
        assert not merged[f][:, 0].any(), f
    if "paged" in kind:
        # slot 1 holds pages 3 and 0 of 16 tokens: two pages of each field
        assert state.assigned_kv_bytes() == 2 * cfg.n_layers * 2 * 16 * \
            per_vec
    old = dec.init_state(2, 40)
    old.bookkeeping.update({n: v.clone() for n, v in
                            state.bookkeeping.items()})
    mixed = state.where_rows(torch.tensor([False, True]), old)
    for f, v in mixed.merged().items():
        if f in ("k", "v", "dense_k", "dense_v"):
            assert torch.equal(v[:, 1], merged[f][:, 1]), f
            assert torch.equal(v[:, 0], before[f][:, 0]), f


@pytest.mark.parametrize("arch,flags", [
    ("deepseek_moe_16b", []),
    ("deepseek_moe_16b", ["--layout", "paged_int8", "--page-size", "16",
                          "--pool-pages", "6"]),
    ("mixtral_8x22b", ["--layout", "paged", "--page-size", "16",
                       "--pool-pages", "6"])])
def test_serve_sessions_cli_moe_matches_solo_runs(arch, flags, capsys):
    rc = serve.main(["--arch", arch, "--reduced", "--sessions", "3",
                     "--slots", "2", "--gen", "12", "--prompt-len", "20",
                     "--device", "cpu"] + flags)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("matches solo run: True") == 3, out
    assert "0 resyncs" in out and f"arch={get_config(arch).name}" in out


def test_profile_step_moe_on_cpu(capsys):
    from repro_torch.launch import profile_step
    assert profile_step.main(["--arch", "deepseek_moe_16b", "--reduced",
                              "--batch", "2", "--prompt-len", "12",
                              "--steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[profile] hit: wall" in out and "[profile] admit: wall" in out
    assert "resync" not in out


def _cuda_layouts_vs_plain(arch):
    """Reduced ``arch`` (f32) on each layout: two admissions and 8 steps
    on the card against the CPU plain path fed the same tokens, logits
    within 1e-3; the card ran K2 and the layout's decode kernel (every
    layer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (their plain versions are tested above)")
    cfg = reduced(get_config(arch), dtype="float32")
    params = LM.init_lm(cfg, 0, device="cuda")
    kernels = {"dense": "decode_attention", "int8": "decode_attention_int8",
               "paged": "paged_decode_attention",
               "paged_int8": "paged_decode_attention_int8"}
    prompts = [np.random.RandomState(s).randint(1, cfg.vocab_size, size=n)
               for s, n in ((0, 37), (1, 70))]
    for kind in LAYOUTS:
        decs = {d: build_decode(cfg, _spec(PLT, kind), device=d)
                for d in ("cpu", "cuda")}
        ps = {d: dec.prepare_params(params) for d, dec in decs.items()}
        sts = {d: dec.init_state(2, 128) for d, dec in decs.items()}
        runtime.reset_counters()
        for slot, p in enumerate(prompts):
            lg = {d: dec.prefill_into_slot(ps[d], sts[d], slot, p)[0]
                  for d, dec in decs.items()}
            assert (lg["cuda"].cpu() - lg["cpu"]).abs().max() < 1e-3, kind
        token = torch.tensor([3, 4], dtype=torch.int32)
        for _ in range(8):
            lg = {d: dec.raw_step(ps[d], sts[d], token.to(d))[0]
                  for d, dec in decs.items()}
            torch.cuda.synchronize()
            err = (lg["cuda"].cpu() - lg["cpu"]).abs().max().item()
            assert err < 1e-3, (kind, err)
            token = lg["cpu"].argmax(-1).to(torch.int32)
        counts = runtime.read_counters()
        assert counts["flash_attention"]["kernel"] == 2 * cfg.n_layers
        assert counts[kernels[kind]]["kernel"] == 8 * cfg.n_layers, kind


@pytest.mark.cuda
def test_cuda_lm_layouts_vs_plain():
    """Reduced smollm on each layout, card against the CPU plain path."""
    _cuda_layouts_vs_plain("smollm_360m")


@pytest.mark.cuda
def test_cuda_moe_layouts_vs_plain():
    """Reduced deepseek (a dense layer with ``dense_k`` / ``dense_v``, an
    MoE layer with a shared expert; weights drawn on the card) on each
    layout, card against the CPU plain path on the same weights."""
    _cuda_layouts_vs_plain("deepseek_moe_16b")
