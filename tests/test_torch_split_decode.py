"""K1's and K3's split-KV design and K2's tile skipping, checked on the CPU.

* A plain PyTorch mirror of the CUDA K1's split and merge (the plan
  ``decode_attention.split_plan(S, 1)`` from the buffer's S alone, one f32
  partial per run of slots intersected with the row's ``[lo, hi)``, the
  merge below), used only here.  It must equal ``decode_attention_plain``
  and the JAX package's ``decode_attention_pallas`` (interpret mode),
  ``ref.decode_reference`` and masked-safe ``sdpa`` at 1e-6 in f32 on the
  same numpy-seeded inputs: prefix ranges (the generation window), suffix
  ranges (the context cross-attention), ranges that start or end inside a
  run, runs with no attended slot, empty rows (exact zeros), softcap,
  G = 1 / 4 and int8 codes with scales (hypothesis draws the cases too).
* A plain PyTorch mirror of the CUDA K3's split and merge (the split plan
  of ``paged_decode_attention.split_plan``, one f32 partial (m, l, acc)
  per run of pages, the merge with rescaling), used only here.  It must
  equal the unsplit plain version and the JAX package's
  ``paged_decode_attention_xla`` at 1e-6 in f32 on the same numpy-seeded
  inputs: over page counts, ``valid_len`` 0 / a partial last page / full,
  windows, runs with no attended slot, and int8 pools (hypothesis draws
  the cases too).
* K2's tile-skip predicate (``flash_attention.tile_live``) never drops a
  key tile that holds a pair ``position_mask`` attends, over the query
  tiles (16, 32, 64) and key tiles (32, 64) the kernel uses; and at the
  resync's compress shape it does skip the dead tiles.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

try:    # the GPU machine has no JAX
    import jax.numpy as jnp
    from repro.kernels import ref as REF
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro.kernels.paged_decode_attention import \
        paged_decode_attention_xla
    from repro.layers import attention as JA
except ImportError:
    jnp = None
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_decode_attention as PD

torch.set_num_threads(1)
ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def paged_case(B, KV, G, D, page, pps, valid_len, quant, seed):
    """q, pools (+ scale pools), a shuffled page table whose entries past
    each row's valid length point at the trash page, valid_len (torch,
    f32 / int8)."""
    rng = np.random.RandomState(seed)
    P = B * pps
    q = rng.randn(B, KV * G, D).astype(np.float32)
    ks = vs = None
    if quant:
        pk = rng.randint(-127, 128, (P + 1, page, KV, D)).astype(np.int8)
        pv = rng.randint(-127, 128, (P + 1, page, KV, D)).astype(np.int8)
        ks = _t((rng.rand(P + 1, page, KV, 1) * 0.02 + 1e-3)
                .astype(np.float32))
        vs = _t((rng.rand(P + 1, page, KV, 1) * 0.02 + 1e-3)
                .astype(np.float32))
    else:
        pk = rng.randn(P + 1, page, KV, D).astype(np.float32)
        pv = rng.randn(P + 1, page, KV, D).astype(np.float32)
    pt = rng.permutation(P).reshape(B, pps).astype(np.int32)
    vl = np.asarray(valid_len, np.int32)
    for b in range(B):
        pt[b, -(-int(vl[b]) // page):] = P
    return _t(q), _t(pk), _t(pv), _t(pt), _t(vl), ks, vs


def split_partials(q, pool_k, pool_v, page_table, valid_len, softcap=0.0,
                   window=0, k_scale=None, v_scale=None):
    """The CUDA K3's per-block partials, in plain PyTorch: for each (row,
    KV head, run of pages) the running max m, the sum l of exp(s - m) and
    acc = sum exp(s - m) v over the run's attended slots; an empty run
    gives (NEG_INF, 0, 0).  Returns m, l (B, KV, n_split, G) and acc
    (B, KV, n_split, G, D), f32."""
    B, H, D = q.shape
    page, KV = pool_k.shape[1], pool_k.shape[2]
    G, pps = H // KV, page_table.shape[1]
    per, n_split = PD.split_plan(pps, page)
    lo, hi = PD.attended_range(valid_len, window, pps * page)
    m = torch.full((B, KV, n_split, G), FA.NEG_INF)
    l = torch.zeros((B, KV, n_split, G))
    acc = torch.zeros((B, KV, n_split, G, D))
    qg = q.float().reshape(B, KV, G, D) * D ** -0.5
    for b in range(B):
        lb, hb = int(lo[b]), int(hi[b])
        for s in range(n_split):
            p0 = max(s * per, lb // page)
            p1 = min((s + 1) * per, -(-hb // page))
            if p0 >= p1:
                continue
            slots = torch.arange(max(lb, p0 * page), min(hb, p1 * page))
            pages = page_table[b, slots // page].long()
            k = pool_k[pages, slots % page].float()          # (n, KV, D)
            v = pool_v[pages, slots % page].float()
            if k_scale is not None:
                k = k * k_scale[pages, slots % page]
                v = v * v_scale[pages, slots % page]
            m[b, :, s], l[b, :, s], acc[b, :, s] = run_partial(qg[b], k, v,
                                                               softcap)
    return m, l, acc


def run_partial(qg, k, v, softcap):
    """One block's partial over a run's attended slots: qg (KV, G, D)
    pre-scaled queries of a row, k/v (n, KV, D) f32.  Returns the max m,
    the sum l of exp(s - m) (KV, G) and acc = sum exp(s - m) v
    (KV, G, D)."""
    sc = torch.einsum("kgd,nkd->kgn", qg, k)
    if softcap > 0.0:
        sc = torch.tanh(sc / softcap) * softcap
    mx = sc.amax(dim=-1)
    e = torch.exp(sc - mx[..., None])
    return mx, e.sum(-1), torch.einsum("kgn,nkd->kgd", e, v)


def merge_partials(m, l, acc):
    """The merging block's combine: weights exp(m - M) over the nonempty
    partials (l > 0), out = sum w acc / (sum w l + 1e-30): a row with no
    attended slot gives 0.  Returns (B, H, D) f32."""
    B, KV, _, G, D = acc.shape
    live = l > 0
    M = torch.where(live, m, torch.full_like(m, FA.NEG_INF))
    M = M.amax(dim=2, keepdim=True)
    w = torch.where(live, torch.exp(m - M), torch.zeros_like(m))
    L = (w * l).sum(dim=2)
    out = (w[..., None] * acc).sum(dim=2) / (L[..., None] + 1e-30)
    return out.reshape(B, KV * G, D)


def split_decode(*args, **kw):
    return merge_partials(*split_partials(*args, **kw))


# ---------------------------------------------------------------------------
# K3: the split plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pps,page", [(1, 64), (16, 64), (250, 64), (6, 16),
                                      (40, 8), (3, 1), (4096, 16), (0, 64)])
def test_split_plan_covers_the_table_in_bounded_runs(pps, page):
    per, n_split = PD.split_plan(pps, page)
    assert 1 <= n_split <= PD.MAX_SPLIT
    assert per * n_split >= pps, "every page lies in some run"
    assert pps == 0 or (n_split - 1) * per < pps, "no run starts past pps"
    assert per * page >= min(64, max(pps, 1) * page), "runs of >= 64 slots"


def test_split_plan_splits_the_history_row_by_page():
    """The tlin history at page 64 (pps 16): one page a run, 16 runs; a
    16000-slot row (250 pages): runs of 4 pages, 63 of them."""
    assert PD.split_plan(16, 64) == (1, 16)
    assert PD.split_plan(250, 64) == (4, 63)


# ---------------------------------------------------------------------------
# K3: the split-and-merge mirror against the unsplit plain version and JAX
# ---------------------------------------------------------------------------

SPLIT_CASES = [
    # B, KV, G, D, page, pps, valid_len, window, softcap, quant
    (4, 2, 1, 16, 8, 20, [0, 8 * 20, 53, 8], 0, 0.0, False),
    (3, 3, 4, 36, 16, 12, [16 * 12, 0, 97], 40, 0.0, False),
    (2, 1, 2, 16, 4, 40, [160, 17], 0, 25.0, False),
    (4, 2, 2, 16, 8, 20, [0, 81, 8 * 20, 9], 0, 0.0, True),
    (3, 2, 1, 36, 16, 9, [144, 5, 70], 33, 20.0, True),
    (2, 2, 2, 8, 64, 3, [130, 64], 64, 0.0, False),   # window = one page
]


@pytest.mark.parametrize("B,KV,G,D,page,pps,vl,window,cap,quant",
                         SPLIT_CASES)
def test_split_mirror_equals_plain_and_jax(B, KV, G, D, page, pps, vl,
                                           window, cap, quant):
    q, pk, pv, pt, vlt, ks, vs = paged_case(B, KV, G, D, page, pps, vl,
                                            quant, seed=B + pps)
    _, n_split = PD.split_plan(pps, page)
    assert n_split > 1, "the case must split its rows"
    got = split_decode(q, pk, pv, pt, vlt, cap, window, ks, vs)
    ref = PD.paged_decode_attention_plain(q, pk, pv, pt, vlt, cap, window,
                                          ks, vs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)
    for b, n in enumerate(vl):
        if n == 0:
            assert not got[b].any(), "valid_len 0 gives zeros"
    if jnp is None:
        pytest.skip("the JAX reference needs JAX (absent on the GPU machine)")
    kw = dict(softcap=cap, window=window)
    if quant:
        kw.update(k_scale=jnp.asarray(ks.numpy()),
                  v_scale=jnp.asarray(vs.numpy()))
    xla = paged_decode_attention_xla(
        *(jnp.asarray(a.numpy()) for a in (q, pk, pv, pt, vlt)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=ATOL)


def test_split_runs_without_attended_slots_are_empty_partials():
    """A window leaves the early runs of a long row without an attended
    slot, and a short row's later runs hold only trash: those partials
    are (NEG_INF, 0, 0) and the merge still equals the plain version."""
    q, pk, pv, pt, vl, _, _ = paged_case(2, 2, 2, 16, 8, 24, [192, 11],
                                         False, seed=7)
    m, l, acc = split_partials(q, pk, pv, pt, vl, window=20)
    per, n_split = PD.split_plan(24, 8)
    assert (per, n_split) == (8, 3)
    assert (l[0, :, :2] == 0).all() and (l[0, :, 2] > 0).all()
    assert (l[1, :, 1:] == 0).all() and (l[1, :, 0] > 0).all()
    assert (acc[l == 0] == 0).all() and (m[l == 0] == FA.NEG_INF).all()
    ref = PD.paged_decode_attention_plain(q, pk, pv, pt, vl, window=20)
    np.testing.assert_allclose(merge_partials(m, l, acc).numpy(),
                               ref.numpy(), atol=ATOL)


@settings(max_examples=25, deadline=None)
@given(pps=st.integers(1, 24), page=st.sampled_from([1, 4, 8, 16]),
       fill=st.lists(st.floats(0.0, 1.0), min_size=1, max_size=3),
       window=st.sampled_from([0, 1, 5, 16, 70]),
       G=st.sampled_from([1, 2, 4]), quant=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_split_mirror_equals_plain_property(pps, page, fill, window, G,
                                            quant, seed):
    cap = pps * page
    vl = [int(round(f * cap)) for f in fill]     # 0, partial, full
    q, pk, pv, pt, vlt, ks, vs = paged_case(len(vl), 2, G, 8, page, pps,
                                            vl, quant, seed)
    got = split_decode(q, pk, pv, pt, vlt, 0.0, window, ks, vs)
    ref = PD.paged_decode_attention_plain(q, pk, pv, pt, vlt, 0.0, window,
                                          ks, vs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# K1: the split plan of a dense row and the split-and-merge mirror
# ---------------------------------------------------------------------------


def dense_case(B, S, KV, G, D, quant, seed):
    """q, k, v (+ (B, S, KV, 1) scales) on a dense (B, S, KV, D) buffer
    (torch, f32 / int8 codes)."""
    rng = np.random.RandomState(seed)
    q = _t(rng.randn(B, KV * G, D).astype(np.float32))
    if not quant:
        return (q, _t(rng.randn(B, S, KV, D).astype(np.float32)),
                _t(rng.randn(B, S, KV, D).astype(np.float32)), None, None)
    k = _t(rng.randint(-127, 128, (B, S, KV, D)).astype(np.int8))
    v = _t(rng.randint(-127, 128, (B, S, KV, D)).astype(np.int8))
    ks = _t((rng.rand(B, S, KV, 1) * 0.02 + 1e-3).astype(np.float32))
    vs = _t((rng.rand(B, S, KV, 1) * 0.02 + 1e-3).astype(np.float32))
    return q, k, v, ks, vs


def dense_split_partials(q, k, v, lo, hi, softcap=0.0, k_scale=None,
                         v_scale=None):
    """The CUDA K1's per-block partials, in plain PyTorch: the plan from S
    alone; block s attends [s * split, (s + 1) * split) intersected with
    the row's [lo, hi) (clamped to [0, S)); an empty intersection gives
    (NEG_INF, 0, 0).  Returns m, l (B, KV, n_split, G), acc (B, KV,
    n_split, G, D), f32."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    split, n_split = DA.split_plan(S, 1)
    m = torch.full((B, KV, n_split, G), DA.NEG_INF)
    l = torch.zeros((B, KV, n_split, G))
    acc = torch.zeros((B, KV, n_split, G, D))
    qg = q.float().reshape(B, KV, G, D) * D ** -0.5
    for b in range(B):
        lb, hb = max(int(lo[b]), 0), min(int(hi[b]), S)
        for s in range(n_split):
            r0, r1 = max(s * split, lb), min((s + 1) * split, hb)
            if r0 >= r1:
                continue
            kk, vv = k[b, r0:r1].float(), v[b, r0:r1].float()
            if k_scale is not None:
                kk, vv = kk * k_scale[b, r0:r1], vv * v_scale[b, r0:r1]
            m[b, :, s], l[b, :, s], acc[b, :, s] = run_partial(qg[b], kk, vv,
                                                               softcap)
    return m, l, acc


def dense_split_decode(*args, **kw):
    return merge_partials(*dense_split_partials(*args, **kw))


def _ranges(lo, hi):
    return (torch.tensor(lo, dtype=torch.int32),
            torch.tensor(hi, dtype=torch.int32))


def _jax_sdpa(q, k, v, lo, hi, softcap=0.0, ks=None, vs=None):
    """The JAX package's masked-safe ``sdpa`` over slots [lo, hi) (int8:
    on the dequantised buffer)."""
    if ks is not None:
        k, v = k.float() * ks, v.float() * vs
    S = k.shape[1]
    slot = np.arange(S)[None]
    valid = (slot >= lo.numpy()[:, None]) & (slot < hi.numpy()[:, None])
    out = JA.sdpa(jnp.asarray(q.numpy()[:, None]), jnp.asarray(k.numpy()),
                  jnp.asarray(v.numpy()), logit_softcap=softcap,
                  kv_valid=jnp.asarray(valid))
    return np.asarray(out)[:, 0]


@pytest.mark.parametrize("S", [0, 1, 63, 64, 65, 256, 999, 4096, 4097,
                               16384, 65536, 100000])
def test_dense_split_plan_covers_the_row_in_bounded_runs(S):
    split, n_split = DA.split_plan(S, 1)
    assert 1 <= n_split <= DA.MAX_SPLIT
    assert split >= 64, "runs of >= 64 slots"
    assert split * n_split >= S, "every slot lies in some run"
    assert S == 0 or (n_split - 1) * split < S, "no run starts past S"


def test_dense_split_plan_of_the_served_shapes():
    """From S alone (never the device's lo / hi): the hit step's 256-slot
    windows in 4 runs, TLinFormer's 999-slot history in 16, a 16384-slot
    row in 64 runs of 256, and K3's plan is the same function of pages."""
    assert DA.split_plan(256, 1) == (64, 4)
    assert DA.split_plan(999, 1) == (64, 16)
    assert DA.split_plan(16384, 1) == (256, 64)
    assert DA.split_plan(65536, 1) == (1024, 64)
    assert PD.split_plan is DA.split_plan


DENSE_PREFIX = [
    # B, S, KV, G, D, hi, softcap, quant -- slots [0, hi), as the
    # generation-window self-attention and TLinFormer's history read them
    (3, 256, 2, 1, 36, [256, 89, 170], 0.0, False),
    (4, 200, 2, 4, 16, [200, 0, 1, 129], 0.0, False),
    (2, 999, 1, 1, 16, [613, 960], 0.0, False),
    (3, 130, 2, 4, 8, [130, 64, 65], 30.0, False),
    (3, 256, 2, 1, 36, [256, 0, 170], 0.0, True),
    (2, 300, 1, 4, 16, [193, 300], 25.0, True),
]


@pytest.mark.parametrize("B,S,KV,G,D,hi,cap,quant", DENSE_PREFIX)
def test_dense_split_mirror_prefix_ranges_vs_plain_and_pallas(
        B, S, KV, G, D, hi, cap, quant):
    q, k, v, ks, vs = dense_case(B, S, KV, G, D, quant, seed=S + B)
    lo, hit = _ranges([0] * B, hi)
    got = dense_split_decode(q, k, v, lo, hit, cap, ks, vs)
    ref = DA.decode_attention_plain(q, k, v, lo, hit, cap, ks, vs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)
    for b, n in enumerate(hi):
        if n == 0:
            assert not got[b].any(), "an empty row gives exact zeros"
    if jnp is None:
        pytest.skip("the JAX reference needs JAX (absent on the GPU machine)")
    kw = {}
    if quant:
        kw = dict(k_scale=jnp.asarray(ks.numpy()),
                  v_scale=jnp.asarray(vs.numpy()))
    pallas = decode_attention_pallas(
        *(jnp.asarray(a.numpy()) for a in (q, k, v, hit)), softcap=cap,
        interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL)
    if not quant:
        oracle = REF.decode_reference(
            *(jnp.asarray(a.numpy()) for a in (q, k, v, hit)), softcap=cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                                   atol=ATOL)


def test_dense_split_mirror_window_vs_pallas():
    """A window (slots [hi - w, hi)) starts inside a run: the Pallas
    kernel's ``window`` against the mirror's lo = hi - w."""
    B, S, KV, G, D, w = 3, 256, 2, 2, 16, 90
    q, k, v, _, _ = dense_case(B, S, KV, G, D, False, seed=41)
    hi = np.array([256, 100, 50], np.int32)
    lo, hit = _ranges(np.maximum(hi - w, 0).tolist(), hi.tolist())
    got = dense_split_decode(q, k, v, lo, hit)
    ref = DA.decode_attention_plain(q, k, v, lo, hit)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)
    if jnp is None:
        pytest.skip("the JAX reference needs JAX (absent on the GPU machine)")
    pallas = decode_attention_pallas(
        *(jnp.asarray(a.numpy()) for a in (q, k, v, hit)), window=w,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL)


DENSE_RANGES = [
    # B, S, KV, G, D, lo, hi, softcap, quant
    # the context cross-attention: suffixes [S - n, S), one empty
    (4, 256, 2, 1, 36, [156, 0, 256, 255], [256] * 4, 0.0, False),
    (3, 256, 1, 4, 16, [100, 192, 64], [256] * 3, 20.0, False),
    (3, 256, 2, 1, 36, [156, 0, 256], [256] * 3, 0.0, True),
    # ranges that start and end inside runs, or within one run, or empty
    (4, 999, 1, 4, 8, [70, 130, 500, 900], [90, 700, 501, 899], 0.0, False),
    (3, 400, 2, 2, 16, [1, 63, 65], [399, 129, 320], 15.0, True),
]


@pytest.mark.parametrize("B,S,KV,G,D,lo,hi,cap,quant", DENSE_RANGES)
def test_dense_split_mirror_ranges_vs_plain_and_sdpa(B, S, KV, G, D, lo, hi,
                                                     cap, quant):
    q, k, v, ks, vs = dense_case(B, S, KV, G, D, quant, seed=S + G)
    lot, hit = _ranges(lo, hi)
    _, n_split = DA.split_plan(S, 1)
    assert n_split > 1, "the case must split its rows"
    got = dense_split_decode(q, k, v, lot, hit, cap, ks, vs)
    ref = DA.decode_attention_plain(q, k, v, lot, hit, cap, ks, vs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)
    for b in range(B):
        if hi[b] <= lo[b]:
            assert not got[b].any(), "an empty range gives exact zeros"
    if jnp is None:
        pytest.skip("the JAX reference needs JAX (absent on the GPU machine)")
    np.testing.assert_allclose(
        got.numpy(), _jax_sdpa(q, k, v, lot, hit, cap, ks, vs), atol=ATOL)


def test_dense_split_runs_without_attended_slots_are_empty_partials():
    """A suffix range leaves the first runs of a row empty, a short prefix
    the last ones, an empty row all of them: those partials are
    (NEG_INF, 0, 0), an empty row merges to exact zeros, and the merge
    equals the plain version."""
    q, k, v, _, _ = dense_case(3, 256, 2, 2, 16, False, seed=43)
    lo, hi = _ranges([200, 0, 7], [256, 70, 7])
    m, l, acc = dense_split_partials(q, k, v, lo, hi)
    assert DA.split_plan(256, 1) == (64, 4)
    assert (l[0, :, :3] == 0).all() and (l[0, :, 3] > 0).all()
    assert (l[1, :, :2] > 0).all() and (l[1, :, 2:] == 0).all()
    assert (l[2] == 0).all()
    assert (acc[l == 0] == 0).all() and (m[l == 0] == DA.NEG_INF).all()
    got = merge_partials(m, l, acc)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    ref = DA.decode_attention_plain(q, k, v, lo, hi)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


@settings(max_examples=25, deadline=None)
@given(S=st.integers(1, 700), a=st.floats(0.0, 1.0), b=st.floats(0.0, 1.0),
       G=st.sampled_from([1, 2, 4]), quant=st.booleans(),
       cap=st.sampled_from([0.0, 20.0]), seed=st.integers(0, 2 ** 16))
def test_dense_split_mirror_equals_plain_property(S, a, b, G, quant, cap,
                                                  seed):
    """Any S, any [lo, hi) (empty when hi <= lo), G, int8 or f32, softcap:
    the mirror equals the plain version (and JAX's masked ``sdpa``)."""
    lo_hi = sorted(int(round(x * S)) for x in (a, b))
    lo, hi = _ranges([lo_hi[0], 0], [lo_hi[1], S])
    q, k, v, ks, vs = dense_case(2, S, 1, G, 8, quant, seed)
    got = dense_split_decode(q, k, v, lo, hi, cap, ks, vs)
    ref = DA.decode_attention_plain(q, k, v, lo, hi, cap, ks, vs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)
    if jnp is not None:
        np.testing.assert_allclose(
            got.numpy(), _jax_sdpa(q, k, v, lo, hi, cap, ks, vs), atol=ATOL)


# ---------------------------------------------------------------------------
# K2: the tile-skip predicate
# ---------------------------------------------------------------------------


def _positions(B, Lq, Lk, seed, dead_frac=0.5):
    """The resync's compress pattern: row b holds n_b live keys (the rest
    INVALID_POS) and its queries sit at n_b - Lq .. n_b - 1 (negative for
    a short history)."""
    rng = np.random.RandomState(seed)
    kp = np.broadcast_to(np.arange(Lk), (B, Lk)).astype(np.int32).copy()
    qp = np.zeros((B, Lq), np.int32)
    for b in range(B):
        n = int(rng.randint(0, int(Lk * (1 - dead_frac)) + 1))
        kp[b, n:] = FA.INVALID_POS
        qp[b] = n - Lq + np.arange(Lq)
    return _t(qp), _t(kp)


def _tiles_kept(qp, kp, causal, window, bq, bk):
    """(tiles the predicate keeps, tiles holding an attended pair, tiles)
    over every (row, query tile, key tile); asserts no attended tile is
    dropped."""
    mask = FA.position_mask(qp, kp, causal, window)
    B, Lq, Lk = mask.shape
    kept = needed = total = 0
    for b in range(B):
        for q0 in range(0, Lq, bq):
            for k0 in range(0, Lk, bk):
                live = FA.tile_live(kp[b, k0:k0 + bk], qp[b, q0:q0 + bq],
                                    causal, window)
                attended = bool(mask[b, q0:q0 + bq, k0:k0 + bk].any())
                assert live or not attended, (b, q0, k0)
                kept += live
                needed += attended
                total += 1
    return kept, needed, total


@pytest.mark.parametrize("bq,bk", [(16, 64), (32, 64), (64, 64), (32, 32)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 9),
                                           (False, 40)])
def test_tile_live_never_drops_an_attended_tile(bq, bk, causal, window):
    qp, kp = _positions(3, 100, 300, seed=bq + bk + window)
    _tiles_kept(qp, kp, causal, window, bq, bk)


def test_tile_live_skips_the_dead_tiles_of_a_compress():
    """At the compress shape (256 tail queries over 999 history slots,
    histories 512 and 100) most key tiles of a 16-query block are dead,
    and the predicate keeps exactly the tiles that hold attended keys."""
    W, Lk = 256, 999
    hist = torch.tensor([512, 100], dtype=torch.int32)
    pos = torch.arange(Lk, dtype=torch.int32)[None].expand(2, Lk)
    kp = torch.where(pos < hist[:, None], pos,
                     torch.full_like(pos, FA.INVALID_POS))
    qp = hist[:, None] - W + torch.arange(W, dtype=torch.int32)[None]
    kept, needed, total = _tiles_kept(qp, kp, True, 0, 16, 64)
    assert kept == needed
    assert kept < 0.3 * total


@settings(max_examples=30, deadline=None)
@given(Lq=st.integers(1, 70), Lk=st.integers(1, 200),
       bq=st.sampled_from([16, 32, 64]), bk=st.sampled_from([32, 64]),
       causal=st.booleans(), window=st.sampled_from([0, 1, 7, 50]),
       dead=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 16))
def test_tile_live_never_drops_an_attended_tile_property(
        Lq, Lk, bq, bk, causal, window, dead, seed):
    qp, kp = _positions(2, Lq, Lk, seed, dead_frac=dead)
    rng = np.random.RandomState(seed)
    kp = kp.clone()
    kp[torch.from_numpy(rng.rand(2, Lk) < 0.2)] = FA.INVALID_POS
    _tiles_kept(qp, kp, causal, window, bq, bk)
