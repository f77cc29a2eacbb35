"""K3's split-KV design and K2's tile skipping, checked on the CPU.

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
    from repro.kernels.paged_decode_attention import \
        paged_decode_attention_xla
except ImportError:
    jnp = None
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
            sc = torch.einsum("kgd,nkd->kgn", qg[b], k)
            if softcap > 0.0:
                sc = torch.tanh(sc / softcap) * softcap
            mx = sc.amax(dim=-1)
            e = torch.exp(sc - mx[..., None])
            m[b, :, s], l[b, :, s] = mx, e.sum(-1)
            acc[b, :, s] = torch.einsum("kgn,nkd->kgd", e, v)
    return m, l, acc


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
