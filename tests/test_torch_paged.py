"""K3 (paged decode attention) and K1's int8 variant against the JAX
kernels, and the paged layout served end to end.

* K3's plain version against ``paged_decode_attention_pallas`` in
  interpret mode and ``paged_decode_attention_xla``, over GQA groups of
  1, 2 and 4, pages of 8 and 16, ragged and zero ``valid_len``, trash
  entries in the table, a window, a softcap and int8 pools (f32, atol
  2e-5: float association only).
* K1-int8's plain version against ``decode_attention_pallas(k_scale=...,
  v_scale=..., interpret=True)``.
* The CUDA kernels against their plain versions (``cuda`` marker; skips
  without a GPU).
* The paged layout-native step against its dense oracle (2e-5, the JAX
  package's own tolerance, ``tests/test_layout_native.py``), and the
  port's greedy ``SlotScheduler`` streams against the JAX ones for tlin on
  the dense and paged layouts with an under-sized pool; page-allocator
  units mirroring ``tests/test_prefix_sharing.py``.
"""
import numpy as np
import pytest
import torch

try:    # the GPU machine has no JAX: only the cuda test runs there
    import jax.numpy as jnp
    from parity import family, make_prompts, serve_streams
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro.kernels.paged_decode_attention import (
        paged_decode_attention_pallas, paged_decode_attention_xla)
    from repro.models import layouts as JLT
    from torch_parity import jax_to_numpy, port_streams
except ImportError:
    jnp = None
from repro_torch import bridge
from repro_torch import config as PC
from repro_torch import runtime
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as PD
from repro_torch.models import layouts as PLT
from repro_torch.models.api import build_decode
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session

torch.set_num_threads(1)
ATOL = 2e-5
PROMPT_LENS = (21, 34, 17)


def _need_jax():
    if jnp is None:
        pytest.skip("the JAX references need JAX (absent on the GPU machine)")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def paged_inputs(B, KV, G, D, page, pps, valid_len, quant, seed=0):
    """q, pools (+ scale pools), a shuffled page table whose unassigned
    tail entries point at the trash page, valid_len -- numpy."""
    rng = np.random.RandomState(seed)
    P = B * pps
    q = rng.randn(B, KV * G, D).astype(np.float32)
    if quant:
        pk = rng.randint(-127, 128, (P + 1, page, KV, D)).astype(np.int8)
        pv = rng.randint(-127, 128, (P + 1, page, KV, D)).astype(np.int8)
        ks = (rng.rand(P + 1, page, KV, 1) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.rand(P + 1, page, KV, 1) * 0.02 + 1e-3).astype(np.float32)
    else:
        pk = rng.randn(P + 1, page, KV, D).astype(np.float32)
        pv = rng.randn(P + 1, page, KV, D).astype(np.float32)
        ks = vs = None
    pt = rng.permutation(P).reshape(B, pps).astype(np.int32)
    vl = np.asarray(valid_len, np.int32)
    for b in range(B):                   # pages past valid_len: trash
        pt[b, -(-int(vl[b]) // page):] = P
    return q, pk, pv, ks, vs, pt, vl


# ---------------------------------------------------------------------------
# K3: paged decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G,page,window,cap,quant", [
    (1, 8, 0, 0.0, False), (2, 16, 0, 0.0, False), (4, 8, 5, 0.0, False),
    (2, 8, 0, 30.0, False), (1, 16, 20, 0.0, True), (2, 8, 0, 0.0, True),
    (4, 16, 3, 20.0, True)])
def test_paged_plain_vs_pallas_and_xla(G, page, window, cap, quant):
    _need_jax()
    B, KV, D, pps = 4, 2, 16, 4
    # zero, partial last page, exactly one page, the full table
    vl = [0, page + 3, page, page * pps]
    q, pk, pv, ks, vs, pt, vl = paged_inputs(B, KV, G, D, page, pps, vl,
                                             quant)
    kw = dict(softcap=cap, window=window)
    jkw = dict(kw)
    if quant:
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    args = [jnp.asarray(a) for a in (q, pk, pv, pt, vl)]
    ref = np.asarray(paged_decode_attention_pallas(*args, interpret=True,
                                                   **jkw))
    xla = np.asarray(paged_decode_attention_xla(*args, **jkw))
    got = PD.paged_decode_attention_plain(
        _t(q), _t(pk), _t(pv), _t(pt), _t(vl), cap, window,
        None if ks is None else _t(ks), None if vs is None else _t(vs))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), xla, atol=ATOL)
    assert not got[0].any(), "valid_len 0 gives zeros"


def test_paged_plain_equals_dense_decode_on_gathered_rows():
    """Gathering a row's pages and attending them densely is what K3's
    plain version does; hold it to K1's plain version on the gathered
    rows with the equivalent slot range."""
    q, pk, pv, _, _, pt, vl = paged_inputs(3, 2, 2, 16, 8, 5, [7, 0, 40],
                                           False, seed=3)
    got = PD.paged_decode_attention_plain(_t(q), _t(pk), _t(pv), _t(pt),
                                          _t(vl), window=6)
    k = PD.gather_pages(_t(pk), _t(pt))
    v = PD.gather_pages(_t(pv), _t(pt))
    hi = _t(vl)
    ref = DA.decode_attention_plain(_t(q), k, v, (hi - 6).clamp(min=0), hi)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# K1-int8: decode attention over int8 K/V with per-vector scales
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G,S,cap,window", [(1, 16, 0.0, 0), (2, 24, 0.0, 0),
                                            (4, 16, 25.0, 6)])
def test_decode_int8_plain_vs_pallas(G, S, cap, window):
    _need_jax()
    rng = np.random.RandomState(G + S)
    B, KV, D = 3, 2, 16
    q = rng.randn(B, KV * G, D).astype(np.float32)
    k = rng.randint(-127, 128, (B, S, KV, D)).astype(np.int8)
    v = rng.randint(-127, 128, (B, S, KV, D)).astype(np.int8)
    ks = (rng.rand(B, S, KV, 1) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.rand(B, S, KV, 1) * 0.02 + 1e-3).astype(np.float32)
    vl = np.array([0, S // 2 + 1, S], np.int32)
    ref = np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl),
        softcap=cap, window=window, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), interpret=True))
    hi = _t(vl)
    lo = (hi - window).clamp(min=0) if window else torch.zeros_like(hi)
    got = ops.decode_attention_int8(_t(q), _t(k), _t(v), _t(ks), _t(vs), lo,
                                    hi, cap)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_new_dispatch_takes_plain_on_cpu_and_counts_it():
    runtime.reset_counters()
    q, pk, pv, ks, vs, pt, vl = paged_inputs(2, 2, 2, 16, 8, 3, [5, 24],
                                             True)
    ops.paged_decode(_t(q), _t(pk), _t(pv), _t(pt), _t(vl), k_scale=_t(ks),
                     v_scale=_t(vs))
    q, pk, pv, _, _, pt, vl = paged_inputs(2, 2, 2, 16, 8, 3, [5, 24], False)
    ops.paged_decode(_t(q), _t(pk), _t(pv), _t(pt), _t(vl))
    k8 = torch.zeros((2, 8, 2, 16), dtype=torch.int8)
    s = torch.ones((2, 8, 2, 1))
    i = torch.tensor([0, 8], dtype=torch.int32)
    ops.decode_attention_int8(_t(q), k8, k8, s, s, i * 0, i)
    c = runtime.read_counters()
    for name in ("paged_decode_attention", "paged_decode_attention_int8",
                 "decode_attention_int8"):
        assert c[name] == {"kernel": 0, "plain": 1}, (name, c)


def test_new_cuda_wrappers_refuse_cpu_tensors():
    q, pk, pv, _, _, pt, vl = paged_inputs(1, 1, 1, 16, 8, 2, [4], False)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        PD.paged_decode_attention_cuda(_t(q), _t(pk), _t(pv), _t(pt),
                                       _t(vl))
    k8 = torch.zeros((1, 8, 1, 16), dtype=torch.int8)
    s = torch.ones((1, 8, 1, 1))
    i = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        DA.decode_attention_int8_cuda(_t(q), k8, k8, s, s, i * 0, i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_paged_and_int8_kernels_vs_plain(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (their plain versions are tested above)")
    dev = torch.device("cuda")
    for G, page, window, cap, quant, pps, vlist in [
            (1, 64, 0, 0.0, False, 6, None), (2, 16, 40, 0.0, False, 6, None),
            (1, 64, 0, 0.0, True, 6, None), (4, 16, 33, 30.0, True, 6, None),
            # a 16000-slot row (250 pages: many splits) beside an empty
            # row, with and without a window
            (1, 64, 0, 0.0, False, 250, [16000, 0]),
            (1, 64, 256, 0.0, True, 250, [16000, 0]),
            (2, 16, 300, 0.0, False, 1000, [0, 15999])]:
        vlist = vlist or [0, page * 3 + 5, page, page * 6]
        q, pk, pv, ks, vs, pt, vl = paged_inputs(len(vlist), 3, G, 36, page,
                                                 pps, vlist, quant)
        qt = _t(q).to(dev, dtype)
        if quant:
            pkt, pvt = _t(pk).to(dev), _t(pv).to(dev)
            kst, vst = _t(ks).to(dev), _t(vs).to(dev)
        else:
            pkt, pvt = _t(pk).to(dev, dtype), _t(pv).to(dev, dtype)
            kst = vst = None
        args = (qt, pkt, pvt, _t(pt).to(dev), _t(vl).to(dev), cap, window,
                kst, vst)
        out = PD.paged_decode_attention_cuda(*args)
        ref = PD.paged_decode_attention_plain(*args)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= tol
        if quant:
            k8 = PD.gather_pages(pkt, _t(pt).to(dev))
            v8 = PD.gather_pages(pvt, _t(pt).to(dev))
            ksd = PD.gather_pages(kst, _t(pt).to(dev))
            vsd = PD.gather_pages(vst, _t(pt).to(dev))
            hi = _t(vl).to(dev)
            lo = (hi - 7).clamp(min=0)
            out = DA.decode_attention_int8_cuda(qt, k8, v8, ksd, vsd, lo, hi,
                                                cap)
            ref = DA.decode_attention_plain(qt, k8, v8, lo, hi, cap, ksd,
                                            vsd)
            torch.cuda.synchronize()
            assert (out.float() - ref.float()).abs().max().item() <= tol


# ---------------------------------------------------------------------------
# The paged layout served
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tlin41():
    """reduced(tconst_41m) in tlin mode, f32, CPU, with the JAX family's
    weights (tests/parity.py builds them from PRNGKey(0))."""
    _need_jax()
    jcfg, _, jparams = family("tlin")
    cfg = PC.reduced(PC.get_config("tconst_41m"), dtype="float32",
                     attention_mode="tlin")
    return jcfg, jparams, cfg, bridge.params_from_jax(jax_to_numpy(jparams))


def test_paged_step_matches_dense_oracle(tlin41):
    """The paged layout-native step of a staggered two-slot decode (rows
    crossing the resync at different steps) equals the dense layout's
    within 2e-5 (the JAX package's tolerance for this comparison)."""
    _, _, cfg, params = tlin41
    prompts = make_prompts(cfg, (13, 9), seed=5)
    decs = {k: build_decode(cfg, PLT.LayoutSpec(kind=k, page_size=16),
                            device="cpu") for k in ("dense", "paged")}
    states = {}
    for k, dec in decs.items():
        st = dec.init_state(2, 96)
        for slot, p in enumerate(prompts):
            _, st = dec.prefill_into_slot(params, st, slot, p)
        states[k] = st
    token = torch.tensor([3, 4], dtype=torch.int32)
    for _ in range(12):
        logits = {}
        for k, dec in decs.items():
            rows = dec.sync_candidates(states[k])
            if rows.any():
                dec.sync_rows(params, states[k], rows)
            logits[k], _ = dec.raw_step(params, states[k], token)
        np.testing.assert_allclose(logits["paged"].numpy(),
                                   logits["dense"].numpy(), atol=2e-5)
        token = logits["dense"].argmax(-1).to(torch.int32)
    # the merged() oracle of the paged state equals the dense state
    merged = states["paged"].merged()
    for f, val in states["dense"].merged().items():
        np.testing.assert_allclose(merged[f].numpy(), val.numpy(),
                                   atol=2e-5, err_msg=f)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_tlin_scheduler_streams_equal_jax(tlin41, kind):
    """Greedy streams of the port's scheduler equal the JAX scheduler's
    for tlin; the paged pool (7 pages of 16 for 3 slots x 8 pages) is
    under-sized, so an admission waits for pages a finished session
    releases."""
    jcfg, jparams, cfg, params = tlin41
    prompts = make_prompts(jcfg, PROMPT_LENS)
    pool = 7 if kind == "paged" else None
    ref, _ = serve_streams(jcfg, jparams, prompts, JLT.LayoutSpec(
        kind=kind, page_size=16, pool_pages=pool), gen=14, slots=3)
    got, sched = port_streams(cfg, params, prompts, PLT.LayoutSpec(
        kind=kind, page_size=16, pool_pages=pool), gen=14, slots=3)
    assert got == ref
    assert all(n >= 1 for n in sched.resyncs.values())
    if kind == "paged":
        assert sched.page_waits >= 1, "no admission waited for pages"
        assert sorted(sched.free_pages) == list(range(7))


def _paged_sched(cfg, params, pool_pages, slots=1, **kw):
    spec = PLT.LayoutSpec(kind="paged", page_size=16, pool_pages=pool_pages)
    return SlotScheduler(build_decode(cfg, spec, device="cpu"), params,
                         slots=slots, max_len=128, chunk_size=4, **kw)


def test_submit_rejects_session_exceeding_pool_capacity(tlin41):
    """A session whose page need exceeds the whole pool passes a
    max_len-only check but could never be admitted: submit rejects it."""
    _, _, cfg, params = tlin41
    sched = _paged_sched(cfg, params, pool_pages=4)
    with pytest.raises(ValueError, match="could never be admitted"):
        # prompt 40 + gen 30 + chunk 4 = 74 tokens -> 5 pages > pool 4
        sched.submit(Session(np.ones(40, np.int32), max_new_tokens=30))
    assert not sched.pending


def test_run_raises_instead_of_spinning_when_stuck(tlin41):
    _, _, cfg, params = tlin41
    sched = _paged_sched(cfg, params, pool_pages=10)
    sched.submit(Session(np.ones(20, np.int32), max_new_tokens=8))
    sched.free_pages.clear()          # simulate leaked page accounting
    with pytest.raises(RuntimeError, match="scheduler stuck"):
        sched.run()


def test_head_of_line_blocking_bounded_skip_ahead(tlin41):
    """A page-blocked queue head is overtaken by sessions that fit; with a
    skip budget of 0 nothing overtakes it.  Every page comes back."""
    _, _, cfg, params = tlin41
    sched = _paged_sched(cfg, params, pool_pages=6, slots=3)
    big_a = sched.submit(Session(np.ones(40, np.int32), max_new_tokens=8))
    sched.step()                                  # A admitted: 4/6 pages
    big_b = sched.submit(Session(np.full(40, 2, np.int32),
                                 max_new_tokens=8))
    small_c = sched.submit(Session(np.full(8, 3, np.int32),
                                   max_new_tokens=4))
    sched.admit_pending()
    assert big_b.slot is None and small_c.slot is not None
    sched.run()
    for s in (big_a, big_b, small_c):
        assert s.done and len(s.tokens) == s.max_new_tokens
    assert sorted(sched.free_pages) == list(range(6))
    assert (sched.state.bookkeeping[PLT.PAGE_TABLE] == 6).all()

    fifo = _paged_sched(cfg, params, pool_pages=6, slots=3,
                        max_head_skips=0)
    fifo.submit(Session(np.ones(40, np.int32), max_new_tokens=8))
    fifo.step()
    fifo.submit(Session(np.full(40, 2, np.int32), max_new_tokens=8))
    small = fifo.submit(Session(np.full(8, 3, np.int32), max_new_tokens=4))
    fifo.admit_pending()
    assert small.slot is None
    fifo.run()
    assert small.done
