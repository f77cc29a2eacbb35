"""The port's attention kernels (K1 decode, K2 flash) against the JAX
package's kernels and oracles.

On the CPU the port's dispatch takes each kernel's plain PyTorch version;
those are held against the Pallas kernels in interpret mode (block-
divisible shapes) and against ``ref.mha_reference``, ``xla_flash`` and the
masked-safe ``sdpa`` on ragged shapes, suffix slot ranges and empty rows
(f32, atol 2e-5).  The CUDA kernels themselves are held against the plain
versions by the ``cuda``-marked sweep, which skips without a GPU.
"""
import numpy as np
import pytest
import torch

try:    # the GPU machine has no JAX: only the cuda sweep runs there
    import jax.numpy as jnp
    from repro.kernels import ref as REF
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro.kernels.flash_attention import flash_attention_fwd_pallas
    from repro.kernels.xla_flash import INVALID_POS as JAX_INVALID_POS
    from repro.kernels.xla_flash import flash_attention as xla_flash
    from repro.layers import attention as JA
except ImportError:
    jnp = None
from repro_torch import runtime
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

torch.set_num_threads(1)
ATOL = 2e-5


def _randn(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _qkv(B, Lq, Lk, H, KV, D, seed=0):
    return (_randn((B, Lq, H, D), seed), _randn((B, Lk, KV, D), seed + 1),
            _randn((B, Lk, KV, D), seed + 2))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _need_jax():
    if jnp is None:
        pytest.skip("the JAX references need JAX (absent on the GPU machine)")


def test_invalid_pos_matches_jax():
    _need_jax()
    assert FA.INVALID_POS == int(JAX_INVALID_POS)


# ---------------------------------------------------------------------------
# K1: decode attention
# ---------------------------------------------------------------------------

DECODE_SHAPES = [
    # B, H, KV, D, S, softcap, window
    (2, 4, 2, 16, 8, 0.0, 0),
    (3, 8, 8, 32, 16, 0.0, 0),
    (2, 12, 12, 36, 32, 0.0, 0),        # tconst-41m head layout, short S
    (2, 8, 2, 32, 24, 20.0, 0),
    (3, 4, 1, 16, 16, 0.0, 6),
]


@pytest.mark.parametrize("B,H,KV,D,S,cap,win", DECODE_SHAPES)
def test_decode_plain_vs_pallas(B, H, KV, D, S, cap, win):
    _need_jax()
    q, k, v = _qkv(B, 1, S, H, KV, D, seed=3)
    q = q[:, 0]
    vl = np.array([S, 1, S // 2][:B], np.int32)
    o_pl = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(vl),
                                   softcap=cap, window=win, interpret=True)
    lo = np.maximum(vl - win, 0) if win else np.zeros_like(vl)
    o = DA.decode_attention_plain(_t(q), _t(k), _t(v), _t(lo), _t(vl), cap)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_pl), atol=ATOL)


@pytest.mark.parametrize("S,n_valid", [(8, [8, 3, 0]), (32, [32, 1, 17]),
                                       (19, [0, 0, 19])])
def test_decode_plain_suffix_ranges_vs_sdpa(S, n_valid):
    """The decode step's cross-attention: the valid context slots are the
    suffix [S - n, S); an empty row gives zeros, like the masked-safe
    ``sdpa`` with ``kv_valid``."""
    _need_jax()
    B, H, KV, D = len(n_valid), 4, 2, 16
    q, k, v = _qkv(B, 1, S, H, KV, D, seed=5)
    n = np.array(n_valid, np.int32)
    kv_valid = np.arange(S)[None] >= (S - n)[:, None]
    ref = JA.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  kv_valid=jnp.asarray(kv_valid))
    o = DA.decode_attention_plain(_t(q[:, 0]), _t(k), _t(v), _t(S - n),
                                  torch.full((B,), S, dtype=torch.int32))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref)[:, 0], atol=ATOL)
    for b in np.nonzero(n == 0)[0]:
        assert not o[b].any(), "an empty slot range must give zeros"


def test_decode_plain_prefix_ranges_vs_reference():
    _need_jax()
    B, H, KV, D, S = 4, 6, 3, 8, 12
    q, k, v = _qkv(B, 1, S, H, KV, D, seed=9)
    vl = np.array([12, 5, 1, 0], np.int32)
    ref = REF.decode_reference(jnp.asarray(q[:, 0]), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(vl))
    o = DA.decode_attention_plain(_t(q[:, 0]), _t(k), _t(v),
                                  torch.zeros(B, dtype=torch.int32), _t(vl))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=ATOL)


# ---------------------------------------------------------------------------
# K2: flash attention
# ---------------------------------------------------------------------------

FLASH_SHAPES = [
    # B, Lq, Lk, H, KV, D, causal, window, softcap
    (1, 64, 64, 4, 4, 32, True, 0, 0.0),
    (2, 64, 128, 8, 2, 16, True, 32, 0.0),
    (2, 32, 64, 4, 1, 32, False, 0, 0.0),
    (1, 64, 64, 4, 2, 32, True, 0, 20.0),
]


@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,causal,win,cap", FLASH_SHAPES)
def test_flash_plain_vs_pallas(B, Lq, Lk, H, KV, D, causal, win, cap):
    _need_jax()
    q, k, v = _qkv(B, Lq, Lk, H, KV, D, seed=11)
    qp = np.broadcast_to(np.arange(Lk - Lq, Lk), (B, Lq)).astype(np.int32)
    kp = np.broadcast_to(np.arange(Lk), (B, Lk)).astype(np.int32)
    o_pl = flash_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
        jnp.asarray(kp), causal=causal, window=win, softcap=cap,
        block_q=32, block_k=32, interpret=True)
    o = FA.flash_attention_plain(_t(q), _t(k), _t(v), _t(qp.copy()),
                                 _t(kp.copy()), causal, win, cap)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_pl), atol=ATOL)


RAGGED = [
    # B, Lq, Lk, H, KV, D, causal, window
    (2, 37, 99, 4, 2, 16, True, 0),
    (1, 13, 7, 6, 3, 36, True, 0),
    (3, 50, 50, 4, 4, 8, True, 9),
    (2, 21, 40, 2, 1, 16, False, 0),
]


def _ragged_positions(B, Lq, Lk, seed):
    """Per-row positions with dead keys (INVALID_POS) and negative query
    positions -- the resync's compress pattern."""
    rng = np.random.RandomState(seed)
    kp = np.broadcast_to(np.arange(Lk), (B, Lk)).astype(np.int32).copy()
    qp = np.zeros((B, Lq), np.int32)
    for b in range(B):
        n = rng.randint(0, Lk + 1)
        kp[b, n:] = FA.INVALID_POS
        qp[b] = n - Lq + np.arange(Lq)            # may be negative
    return qp, kp


@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,causal,win", RAGGED)
def test_flash_plain_ragged_vs_reference_and_xla(B, Lq, Lk, H, KV, D,
                                                 causal, win):
    _need_jax()
    q, k, v = _qkv(B, Lq, Lk, H, KV, D, seed=13)
    qp, kp = _ragged_positions(B, Lq, Lk, seed=B + Lq)
    args = [jnp.asarray(a) for a in (q, k, v, qp, kp)]
    ref = REF.mha_reference(*args, window=win, causal=causal)
    xla = xla_flash(*args, win, causal, 0.0, 16, 32)
    o = FA.flash_attention_plain(_t(q), _t(k), _t(v), _t(qp), _t(kp),
                                 causal, win)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(xla), atol=ATOL)


def test_flash_plain_vs_sdpa_mask():
    """K2 with positions reproduces the masked-safe ``sdpa`` the JAX
    TConst paths call with a causal-and-valid boolean mask."""
    _need_jax()
    B, Lq, Lk, H, KV, D = 2, 12, 20, 4, 2, 16
    q, k, v = _qkv(B, Lq, Lk, H, KV, D, seed=17)
    qp, kp = _ragged_positions(B, Lq, Lk, seed=3)
    hist_valid = kp != FA.INVALID_POS
    mask = JA.make_mask(jnp.asarray(qp), jnp.arange(Lk)[None], "causal")
    mask = jnp.logical_and(mask, jnp.asarray(hist_valid)[:, None, :])
    ref = JA.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask)
    o = FA.flash_attention_plain(_t(q), _t(k), _t(v), _t(qp), _t(kp))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=ATOL)


def test_flash_fully_masked_rows_are_zero():
    B, Lq, Lk, H, KV, D = 1, 6, 5, 2, 2, 8
    q, k, v = _qkv(B, Lq, Lk, H, KV, D, seed=19)
    qp = np.array([[-3, -2, -1, 0, 1, 2]], np.int32)
    kp = np.array([[0, 1, 2, FA.INVALID_POS, FA.INVALID_POS]], np.int32)
    o = FA.flash_attention_plain(_t(q), _t(k), _t(v), _t(qp), _t(kp))
    assert not o[0, :3].any()
    assert o[0, 3:].abs().sum() > 0


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_dispatch_takes_plain_on_cpu_and_counts_it():
    B, H, KV, D, S = 2, 4, 2, 8, 6
    q, k, v = _qkv(B, 1, S, H, KV, D, seed=21)
    lo = torch.zeros(B, dtype=torch.int32)
    hi = torch.full((B,), S, dtype=torch.int32)
    runtime.reset_counters()
    ops.decode_attention(_t(q[:, 0]), _t(k), _t(v), lo, hi)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    ops.flash_attention(_t(q).expand(B, S, H, D), _t(k), _t(v), pos, pos)
    counts = runtime.read_counters()
    assert counts["decode_attention"] == {"kernel": 0, "plain": 1}
    assert counts["flash_attention"] == {"kernel": 0, "plain": 1}


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: the kernel wrappers take CUDA tensors or raise."""
    q, k, v = _qkv(1, 1, 4, 2, 2, 8, seed=23)
    i = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        DA.decode_attention_cuda(_t(q[:, 0]), _t(k), _t(v), i, i + 4)
    p = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        FA.flash_attention_cuda(_t(q), _t(k), _t(v), p, p.expand(1, 4))


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (GPU only)
# ---------------------------------------------------------------------------


# the tensor-core / tile-skipping kernel's own edges (GPU sweep only): a
# long mostly dead history, Lq off every query tile, head dims 128 and 35
# (odd: element copies), a window over a long row
CUDA_FLASH_EXTRA = [
    (2, 256, 4096, 4, 4, 36, True, 0),
    (1, 93, 93, 12, 12, 36, True, 0),
    (2, 61, 700, 8, 2, 128, True, 64),
    (2, 40, 300, 4, 4, 35, False, 0),
]


# the split-KV decode's own edges (GPU sweep only): ranges that start and
# end inside different runs of a 1000-slot row, a single-slot range, an
# empty row, 16384 slots at G 4, softcap, and int8 codes with scales
CUDA_DECODE_SPLIT = [
    # B, H, KV, D, S, lo, hi, softcap, int8
    (3, 12, 12, 36, 1000, [70, 0, 500], [930, 0, 501], 0.0, False),
    (2, 16, 4, 64, 16384, [0, 9000], [16000, 16384], 0.0, False),
    (2, 8, 2, 32, 700, [65, 0], [640, 700], 30.0, False),
    (3, 8, 2, 36, 1000, [0, 130, 1000], [999, 700, 1000], 0.0, True),
    (2, 12, 12, 36, 256, [0, 156], [170, 256], 20.0, True),
]


def _decode_split_inputs(B, H, KV, D, S, lo, hi, quant, dtype, dev,
                         seed=37):
    """q, k, v (int8 codes when ``quant``), their scales (or None), lo,
    hi on ``dev``."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32)).to(dev,
                                                                   dtype)
    ks = vs = None
    if quant:
        k, v = (torch.from_numpy(rng.randint(-127, 128, (B, S, KV, D))
                                 .astype(np.int8)).to(dev) for _ in "kv")
        ks, vs = (torch.from_numpy((rng.rand(B, S, KV, 1) * 0.02 + 1e-3)
                                   .astype(np.float32)).to(dev)
                  for _ in "kv")
    else:
        k, v = (torch.from_numpy(rng.randn(B, S, KV, D).astype(np.float32))
                .to(dev, dtype) for _ in "kv")
    lo, hi = (torch.tensor(x, dtype=torch.int32, device=dev)
              for x in (lo, hi))
    return q, k, v, ks, vs, lo, hi


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_vs_plain(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (their plain versions are tested above)")
    dev = torch.device("cuda")
    for B, H, KV, D, S, cap, _ in DECODE_SHAPES:
        q, k, v = (torch.from_numpy(a).to(dev, dtype)
                   for a in _qkv(B, 1, S, H, KV, D, seed=31))
        q = q[:, 0].contiguous()
        lo = torch.tensor([0, S // 3, S][:B], dtype=torch.int32, device=dev)
        hi = torch.tensor([S, S, S][:B], dtype=torch.int32, device=dev)
        out = DA.decode_attention_cuda(q, k, v, lo, hi, cap)
        ref = DA.decode_attention_plain(q, k, v, lo, hi, cap)
        assert (out.float() - ref.float()).abs().max().item() <= tol
    for B, H, KV, D, S, lo, hi, cap, quant in CUDA_DECODE_SPLIT:
        q, k, v, ks, vs, lo, hi = _decode_split_inputs(B, H, KV, D, S, lo,
                                                       hi, quant, dtype, dev)
        if quant:
            out = DA.decode_attention_int8_cuda(q, k, v, ks, vs, lo, hi, cap)
        else:
            out = DA.decode_attention_cuda(q, k, v, lo, hi, cap)
        ref = DA.decode_attention_plain(q, k, v, lo, hi, cap, ks, vs)
        assert (out.float() - ref.float()).abs().max().item() <= tol
        for b in range(B):
            if int(hi[b]) <= int(lo[b]):
                assert not out[b].any(), "an empty row gives exact zeros"
    for B, Lq, Lk, H, KV, D, causal, win in RAGGED + CUDA_FLASH_EXTRA:
        q, k, v = (torch.from_numpy(a).to(dev, dtype)
                   for a in _qkv(B, Lq, Lk, H, KV, D, seed=33))
        qp, kp = (torch.from_numpy(a).to(dev)
                  for a in _ragged_positions(B, Lq, Lk, seed=5))
        out = FA.flash_attention_cuda(q, k, v, qp, kp, causal, win)
        ref = FA.flash_attention_plain(q, k, v, qp, kp, causal, win)
        assert (out.float() - ref.float()).abs().max().item() <= tol
