"""K2's backward: the port's plain version and its ``autograd.Function``
against ``jax.vjp`` of the JAX package's ``xla_flash.flash_attention``,
and the forward's row log-sum-exp against ``xla_flash._fwd``'s.

On the CPU the dispatch takes the plain versions (f32, atol 1e-5): dead
keys, negative query positions, a fully masked row, a window, a softcap,
G 1 and G > 1, ragged Lq / Lk.  The backward's tile-skip predicate for
query tiles is held against the position mask.  A plain mirror of the
bf16 kernels' rounding points (P and dS rounded to bf16 once each, f32
sums) is held against ``jax.vjp`` in f32 and against the plain backward
within the card's bf16 tolerance.  The CUDA kernels (the forward's
``lse`` and the three-launch backward) are held against the plain
versions by the ``cuda``-marked test, which skips without a GPU.
"""
import functools

import numpy as np
import pytest
import torch

try:    # the GPU machine has no JAX: only the cuda test runs there
    import jax
    import jax.numpy as jnp
    from repro.kernels import xla_flash as XF
except ImportError:
    jax = None
from repro_torch import runtime
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

torch.set_num_threads(1)
ATOL = 1e-5
INV = FA.INVALID_POS

# name -> (B, Lq, Lk, H, KV, D, causal, window, softcap, positions)
CASES = {
    "causal_g2_dead_keys": (2, 13, 21, 4, 2, 16, True, 0, 0.0, "dead"),
    "negative_queries_masked_row": (2, 9, 12, 2, 2, 8, True, 0, 0.0,
                                    "negative"),
    "window_g1": (1, 24, 24, 3, 3, 16, True, 5, 0.0, "square"),
    "softcap_cross_g4": (2, 7, 30, 4, 1, 16, False, 0, 3.0, "dead"),
    "window_softcap_g3_ragged": (2, 11, 17, 6, 2, 32, True, 4, 2.0,
                                 "dead"),
}
# the bf16 mirror's own case: the base transformer's causal 1024 (D 36),
# reduced to one batch row and two heads
MIRROR_CASES = {
    "base_causal_1024_reduced": (1, 1024, 1024, 2, 2, 36, True, 0, 0.0,
                                 "square"),
}
BF16_TOL = 2e-2     # the card's bf16 gate: TOL x max(1, max |reference|)


def _positions(kind, B, Lq, Lk):
    rs = np.random.RandomState(7)
    if kind == "square":
        p = np.tile(np.arange(Lq, dtype=np.int32), (B, 1))
        return p, p.copy()
    kp = np.tile(np.arange(Lk, dtype=np.int32), (B, 1))
    if kind == "negative":
        # row 0: queries at -4 .. Lq-5 (the first four see no key: fully
        # masked rows); row 1: every key dead (a fully masked batch row)
        qp = np.stack([np.arange(Lq) - 4, np.arange(Lq) + 3]).astype(np.int32)
        kp[1] = INV
        return qp, kp
    qp = np.stack([np.arange(Lq) + Lk - Lq + b for b in range(B)])
    kp[rs.rand(B, Lk) < 0.3] = INV
    return qp.astype(np.int32), kp


def _inputs(name):
    B, Lq, Lk, H, KV, D, causal, window, cap, kind = {**CASES,
                                                     **MIRROR_CASES}[name]
    rs = np.random.RandomState(len(name))
    q = rs.randn(B, Lq, H, D).astype(np.float32)
    k = rs.randn(B, Lk, KV, D).astype(np.float32)
    v = rs.randn(B, Lk, KV, D).astype(np.float32)
    do = rs.randn(B, Lq, H, D).astype(np.float32)
    qp, kp = _positions(kind, B, Lq, Lk)
    return (q, k, v, qp, kp, do), (causal, window, cap)


def _bf16(a):
    """numpy f32 values rounded to bf16 (the card's inputs), still f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@functools.lru_cache(maxsize=None)
def _jax(name, bf16_inputs=False):
    """(o, lse (B, H, Lq), dq, dk, dv) of the JAX package in f32, as
    numpy; blocks of 8 so that Lq and Lk are ragged against them (128 past
    512 rows).  ``bf16_inputs``: q, k, v and do rounded to bf16 first."""
    (q, k, v, qp, kp, do), (causal, window, cap) = _inputs(name)
    if bf16_inputs:
        q, k, v, do = (_bf16(a) for a in (q, k, v, do))
    B, Lq, H = q.shape[:3]
    blk = 128 if Lq > 512 else 8

    def f(q_, k_, v_):
        return XF.flash_attention(q_, k_, v_, jnp.asarray(qp),
                                  jnp.asarray(kp), window, causal, cap, blk,
                                  blk)

    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq, dk, dv = vjp(jnp.asarray(do))
    _, res = XF._flash_fwd_rule(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(qp),
                                jnp.asarray(kp), window, causal, cap, blk,
                                blk)
    lse = np.asarray(res[-1]).reshape(B, H, Lq)
    return tuple(np.asarray(a) for a in (o, lse, dq, dk, dv))


def _need_jax():
    if jax is None:
        pytest.skip("the JAX references need JAX (absent on the GPU machine)")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_lse_matches_xla_fwd(name):
    _need_jax()
    (q, k, v, qp, kp, _), flags = _inputs(name)
    o, lse = FA.flash_attention_plain(_t(q), _t(k), _t(v), _t(qp), _t(kp),
                                      *flags, return_lse=True)
    o_j, lse_j = _jax(name)[:2]
    np.testing.assert_allclose(o.numpy(), o_j, atol=ATOL)
    # a fully masked row's lse is NEG_INF + log(1e-30) on both sides
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=1e-6, atol=ATOL)
    assert (lse.numpy() < -1e38).any() == (name ==
                                          "negative_queries_masked_row")


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bwd_matches_jax_vjp(name):
    _need_jax()
    (q, k, v, qp, kp, do), flags = _inputs(name)
    o, lse = FA.flash_attention_plain(_t(q), _t(k), _t(v), _t(qp), _t(kp),
                                      *flags, return_lse=True)
    got = FA.flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(qp), _t(kp),
                                       o, lse, _t(do), *flags)
    for g, want in zip(got, _jax(name)[2:]):
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("name", ["causal_g2_dead_keys",
                                  "window_softcap_g3_ragged"])
def test_autograd_function_matches_jax_vjp_and_counts(name):
    _need_jax()
    (q, k, v, qp, kp, do), (causal, window, cap) = _inputs(name)
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    runtime.reset_counters()
    out = ops.flash_attention(qt, kt, vt, _t(qp), _t(kp), causal, window,
                              cap)
    grads = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    counts = runtime.read_counters()
    assert counts["flash_attention"] == {"kernel": 0, "plain": 1}
    assert counts["flash_attention_bwd"] == {"kernel": 0, "plain": 1}
    want = _jax(name)
    np.testing.assert_allclose(out.detach().numpy(), want[0], atol=ATOL)
    for g, w in zip(grads, want[2:]):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


def _bwd_bf16_mirror(q, k, v, q_pos, k_pos, o, lse, do, causal, window,
                     softcap):
    """The bf16 kernels' rounding points on the plain backward's
    arithmetic: products of the bf16 inputs summed in f32, p and ds in
    f32, then P and dS rounded to bf16 once each before the products that
    take them (dV = P^T dO, dK = dS^T Q, dQ = dS K, f32 sums), the
    gradients rounded to bf16."""
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    qf = q.reshape(B, Lq, KV, G, D).float()
    kf, vf = k.float(), v.float()
    dof = do.reshape(B, Lq, KV, G, D).float()
    s = torch.einsum("blkgd,bskd->bklgs", qf, kf) * scale
    dcap = 1.0
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s, dcap = t * softcap, 1.0 - t * t
    mask = FA.position_mask(q_pos, k_pos, causal, window)[:, None, :, None]
    lse_r = lse.reshape(B, KV, G, Lq).permute(0, 1, 3, 2)[..., None]
    p = torch.where(mask, torch.exp(s - lse_r), torch.zeros_like(s))
    delta = (dof * o.reshape(B, Lq, KV, G, D).float()).sum(-1)
    delta = delta.permute(0, 2, 1, 3)[..., None]
    ds = p * (torch.einsum("blkgd,bskd->bklgs", dof, vf) - delta) * dcap
    pb, dsb = (a.to(torch.bfloat16).float() for a in (p, ds))
    dv = torch.einsum("bklgs,blkgd->bskd", pb, dof)
    dq = torch.einsum("bklgs,bskd->blkgd", dsb, kf) * scale
    dk = torch.einsum("bklgs,blkgd->bskd", dsb, qf) * scale
    return tuple(a.to(torch.bfloat16) for a in
                 (dq.reshape(B, Lq, H, D), dk, dv))


@pytest.mark.parametrize("name", ["causal_g2_dead_keys", "softcap_cross_g4",
                                  "window_softcap_g3_ragged",
                                  "base_causal_1024_reduced"])
def test_bf16_rounding_mirror_within_tol(name):
    """Rounding P and dS to bf16 (the kernels' design) keeps the gradients
    within the card's bf16 gate of both references: JAX's f32 backward
    and the plain backward, on the same bf16 inputs."""
    _need_jax()
    (q, k, v, qp, kp, do), flags = _inputs(name)
    q, k, v, do = (_t(a).to(torch.bfloat16) for a in (q, k, v, do))
    qp, kp = _t(qp), _t(kp)
    o, lse = FA.flash_attention_plain(q, k, v, qp, kp, *flags,
                                      return_lse=True)
    got = _bwd_bf16_mirror(q, k, v, qp, kp, o, lse, do, *flags)
    plain = FA.flash_attention_bwd_plain(q, k, v, qp, kp, o, lse, do,
                                         *flags)
    for grad, g, p, w in zip(("dq", "dk", "dv"), got, plain,
                             _jax(name, bf16_inputs=True)[2:]):
        assert g.dtype == torch.bfloat16
        for ref_name, ref in (("plain", p.float().numpy()), ("jax", w)):
            scale = max(1.0, float(np.abs(ref).max()))
            err = float(np.abs(g.float().numpy() - ref).max())
            assert err <= BF16_TOL * scale, (grad, ref_name, err, scale)


def test_serving_calls_take_no_autograd_path():
    (q, k, v, qp, kp, _), flags = _inputs("causal_g2_dead_keys")
    qt = _t(q).requires_grad_()
    with torch.no_grad():
        out = ops.flash_attention(qt, _t(k), _t(v), _t(qp), _t(kp), *flags)
    assert out.grad_fn is None
    out = ops.flash_attention(_t(q), _t(k), _t(v), _t(qp), _t(kp), *flags)
    assert out.grad_fn is None


def test_query_tile_live_never_drops_an_attended_tile():
    rs = np.random.RandomState(3)
    for trial in range(300):
        causal = bool(trial % 2)
        window = int(rs.choice([0, 1, 3, 9]))
        qp = rs.randint(-8, 40, size=rs.randint(1, 9)).astype(np.int32)
        kp = rs.randint(0, 40, size=rs.randint(1, 9)).astype(np.int32)
        kp[rs.rand(kp.size) < 0.3] = INV
        mask = FA.position_mask(_t(qp)[None], _t(kp)[None], causal, window)
        live = FA.query_tile_live(_t(qp), _t(kp), causal, window)
        if bool(mask.any()):
            assert live, (qp, kp, causal, window)
        if not (kp != INV).any():
            assert not live


def test_bwd_cuda_wrapper_refuses_cpu_tensors():
    (q, k, v, qp, kp, do), flags = _inputs("window_g1")
    o, lse = FA.flash_attention_plain(_t(q), _t(k), _t(v), _t(qp), _t(kp),
                                      *flags, return_lse=True)
    with pytest.raises(ValueError):
        FA.flash_attention_bwd_cuda(_t(q), _t(k), _t(v), _t(qp), _t(kp), o,
                                    lse, _t(do), *flags)


# the kernels' own edges (GPU only): D 16 / 36 / 64 / 128 (DP 16, 48, 64,
# 128), G 1 / 3 / 4, ragged tiles, dead keys, negative query positions and
# a fully masked batch row, a window, a softcap, Lq and Lk past one tile
# walk of 32 tiles (f32 tiles of 32: 1100 > 32 * 32; bf16 key tiles of 64:
# 2100 > 32 * 64), G 4 at D 128 with dead keys, and rows of 36 and 34 bytes
# (D 18 and 17: 4-byte and element copies)
CUDA_CASES = [
    # B, Lq, Lk, H, KV, D, causal, window, softcap, positions
    (2, 37, 45, 4, 2, 16, True, 0, 0.0, "dead"),
    (2, 70, 300, 12, 12, 36, True, 0, 0.0, "negative"),
    (1, 100, 100, 6, 2, 64, True, 17, 5.0, "square"),
    (2, 33, 64, 4, 1, 128, False, 0, 0.0, "dead"),
    (1, 1100, 1100, 2, 2, 36, True, 0, 0.0, "square"),
    (2, 5, 1100, 3, 3, 32, True, 64, 0.0, "dead"),
    (1, 2100, 2100, 2, 2, 36, True, 0, 0.0, "square"),
    (2, 70, 150, 8, 2, 128, True, 0, 0.0, "dead"),
    (2, 45, 77, 4, 2, 18, True, 0, 0.0, "dead"),
    (1, 40, 40, 3, 1, 17, True, 9, 4.0, "square"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, BF16_TOL)])
def test_cuda_bwd_vs_plain(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    dev = torch.device("cuda")
    for case in CUDA_CASES:
        B, Lq, Lk, H, KV, D, causal, window, cap, kind = case
        rs = np.random.RandomState(Lq + Lk)
        q, k, v, do = (torch.from_numpy(rs.randn(*s).astype(np.float32))
                       .to(dev, dtype) for s in
                       ((B, Lq, H, D), (B, Lk, KV, D), (B, Lk, KV, D),
                        (B, Lq, H, D)))
        qp, kp = (_t(a).to(dev) for a in _positions(kind, B, Lq, Lk))
        flags = (causal, window, cap)
        o, lse = FA.flash_attention_cuda(q, k, v, qp, kp, *flags,
                                         return_lse=True)
        o_p, lse_p = FA.flash_attention_plain(q, k, v, qp, kp, *flags,
                                              return_lse=True)
        torch.cuda.synchronize()
        assert (o.float() - o_p.float()).abs().max().item() <= tol, case
        assert torch.allclose(lse, lse_p, rtol=1e-5, atol=tol), case
        got = FA.flash_attention_bwd_cuda(q, k, v, qp, kp, o, lse, do,
                                          *flags)
        want = FA.flash_attention_bwd_plain(q, k, v, qp, kp, o, lse, do,
                                            *flags)
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == dtype and g.shape == w.shape
            scale = max(1.0, w.float().abs().max().item())
            err = (g.float() - w.float()).abs().max().item()
            assert err <= tol * scale, (case, name, err, scale)
