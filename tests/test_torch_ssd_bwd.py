"""K4's backward: the port's plain backward and ``ops.SSDScan`` against
``jax.vjp`` of the JAX package's ``ssd_chunked``, and the backward
kernel's own formulas against autograd.

On the CPU ``ops.ssd_scan`` runs through ``ops.SSDScan`` under autograd;
its backward is autograd through the plain forward at JAX's chunk (the
halving rule), held against ``jax.vjp(ssd_chunked)`` at 1e-5 of each
gradient's scale (f32): with and without an initial state, a zero and a
nonzero final-state cotangent, and an L that the JAX chunk divides only
after halving.  ``ssd_scan_bwd_mirror`` -- the kernel's reverse scan and
per-chunk terms in plain ops -- is held against autograd through
``ssd_scan_tiled_plain`` on the card's ragged tiling, so its math is
proven before a card runs it.  The CUDA kernel (and the forward's saved
chunk-entry states) are held against the plain versions by the
``cuda``-marked tests, which skip without a GPU.  Inputs are made with
numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest
import torch

try:    # the GPU machine has no JAX: only the cuda tests run there
    import jax
    import jax.numpy as jnp
    from repro.layers import ssm as JS
except ImportError:
    jax = None
from repro_torch import runtime
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as SS

torch.set_num_threads(1)

TOL = 1e-5          # f32, relative to max(1, max |reference|)
NAMES = ("dx", "ddt", "da", "db", "dc", "dinit")


def _inputs(Bt, L, H, P, N, seed, init, dfinal):
    rng = np.random.RandomState(seed)
    x = rng.randn(Bt, L, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(Bt, L, H) - 1.0)).astype(np.float32)
    a = -np.exp(rng.randn(H)).astype(np.float32)
    b = rng.randn(Bt, L, N).astype(np.float32)
    c = rng.randn(Bt, L, N).astype(np.float32)
    s0 = rng.randn(Bt, H, P, N).astype(np.float32) if init else None
    dy = rng.randn(Bt, L, H, P).astype(np.float32)
    df = rng.randn(Bt, H, P, N).astype(np.float32) if dfinal else None
    return x, dt, a, b, c, s0, dy, df


def _t(v, dev="cpu"):
    return None if v is None else torch.from_numpy(np.array(v)).to(dev)


def _close(got, ref, tol=TOL, what=""):
    ref = np.asarray(ref, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, tol * scale)


def _jax_vjp(x, dt, a, b, c, s0, dy, df, chunk):
    """JAX's gradients of ``ssd_chunked`` at the mixer's chunk (jitted:
    one compile a shape instead of one an op)."""
    q = SS.jax_chunk(chunk, x.shape[1])
    s0 = np.zeros((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]),
                  np.float32) if s0 is None else s0
    dfin = np.zeros_like(s0) if df is None else df

    def grads(x, dt, a, b, c, s0, dy, dfin):
        _, vjp = jax.vjp(
            lambda *v: JS.ssd_chunked(*v[:5], q, init_state=v[5]),
            x, dt, a, b, c, s0)
        return vjp((dy, dfin))
    return jax.jit(grads)(*[jnp.asarray(v) for v in (x, dt, a, b, c, s0, dy,
                                                     dfin)])


# (Bt, L, H, P, N, chunk, init, dfinal): L 24 at chunk 16 and L 20 at 8
# take JAX's halving (8, 4); L 37 at 64 one odd chunk
JAX_CASES = {
    "init_dfinal": (2, 32, 3, 8, 16, 8, True, True),
    "no_init_no_dfinal": (2, 32, 3, 8, 16, 8, False, False),
    "halved_chunk_init": (1, 24, 2, 8, 8, 16, True, False),
    "halved_chunk_dfinal": (2, 20, 2, 16, 8, 8, False, True),
    "one_chunk_odd_L": (1, 37, 3, 8, 16, 64, True, True),
}


@pytest.mark.skipif(jax is None, reason="needs the JAX package")
@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_ssdscan_cpu_backward_matches_jax_vjp(name):
    Bt, L, H, P, N, chunk, init, dfinal = JAX_CASES[name]
    arrs = _inputs(Bt, L, H, P, N, seed=L + H, init=init, dfinal=dfinal)
    x, dt, a, b, c, s0, dy, df = arrs
    want = _jax_vjp(*arrs, chunk)
    ins = [_t(v).requires_grad_(True) for v in (x, dt, a, b, c)]
    s0t = None if s0 is None else _t(s0).requires_grad_(True)
    runtime.reset_counters()
    y, final = ops.ssd_scan(*ins, chunk, s0t)
    assert y.grad_fn is not None and "SSDScan" in type(y.grad_fn).__name__
    loss = (y * _t(dy)).sum()
    if df is not None:
        loss = loss + (final * _t(df)).sum()
    wrt = ins + ([s0t] if s0t is not None else [])
    got = torch.autograd.grad(loss, wrt)
    counts = runtime.read_counters()
    assert counts["ssd_scan_bwd"] == {"kernel": 0, "plain": 1}
    for n, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w, what=f"{name} {n}")


# (Bt, L, H, P, N, chunk, init, dfinal): ragged last chunks
MIRROR_CASES = {
    "ragged_init_dfinal": (2, 45, 3, 8, 16, 16, True, True),
    "ragged_no_init": (1, 70, 2, 16, 8, 32, False, False),
    "short_single_chunk": (2, 5, 2, 8, 8, 64, True, False),
}


@pytest.mark.parametrize("name", sorted(MIRROR_CASES))
def test_kernel_formulas_mirror_matches_autograd(name):
    Bt, L, H, P, N, chunk, init, dfinal = MIRROR_CASES[name]
    arrs = [_t(v) for v in _inputs(Bt, L, H, P, N, seed=L, init=init,
                                   dfinal=dfinal)]
    x, dt, a, b, c, s0, dy, df = arrs
    want = SS.ssd_scan_bwd_tiled_plain(x, dt, a, b, c, chunk, s0, dy, df)
    got = SS.ssd_scan_bwd_mirror(x, dt, a, b, c, chunk, s0, dy, df)
    for n, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, (n, g.dtype, w.dtype)
        _close(g.numpy(), w.numpy(), what=f"{name} {n}")


def test_entry_states_mirror_the_scan():
    x, dt, a, b, c, s0, _, _ = [_t(v) for v in _inputs(
        2, 45, 3, 8, 16, seed=3, init=True, dfinal=False)]
    _, states = SS.ssd_intra_chunk_tiled_plain(x, dt, a, b, c, 16)
    entry = SS.ssd_entry_states_tiled_plain(states, dt, a, 16, s0)
    assert torch.equal(entry[:, :, 0], s0)
    for n, L in ((1, 16), (2, 32)):
        _, f = SS.ssd_scan_tiled_plain(x[:, :L], dt[:, :L], a, b[:, :L],
                                       c[:, :L], 16, s0)
        _close(entry[:, :, n].numpy(), f.numpy(), what=f"entry {n}")


def test_segsum_mask_keeps_gradients_finite():
    """Strong decays overflow exp(cs_l - cs_s) above the diagonal: the
    mask is applied before the exponential, so neither the plain
    ``ssd_chunked`` nor the CPU backward of ``ops.ssd_scan`` makes a
    NaN."""
    from repro_torch.layers import ssm as S
    x, dt, a, b, c, _, dy, _ = [_t(v) for v in _inputs(
        1, 16, 2, 8, 8, seed=5, init=False, dfinal=False)]
    dt = dt * 40.0 + 5.0                       # |dt a| up to ~1e3 a row
    for fn in (lambda *v: S.ssd_chunked(*v, 16),
               lambda *v: ops.ssd_scan(*v, 16)):
        ins = [v.clone().requires_grad_(True) for v in (x, dt, a, b, c)]
        y, final = fn(*ins)
        grads = torch.autograd.grad((y * dy).sum() + final.sum(), ins)
        assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_no_autograd_keeps_the_serving_path():
    x, dt, a, b, c, _, _, _ = [_t(v) for v in _inputs(
        1, 12, 2, 8, 8, seed=9, init=False, dfinal=False)]
    with torch.no_grad():
        y, _ = ops.ssd_scan(x.requires_grad_(True), dt, a, b, c, 8)
    assert y.grad_fn is None
    y, _ = ops.ssd_scan(x.detach(), dt, a, b, c, 8)
    assert y.grad_fn is None


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (skips without a GPU)
# ---------------------------------------------------------------------------

# (Bt, L, H, P, N, chunk, init, dfinal): mamba2-130m's heads at a ragged
# L, hymba-1.5b's (H 25, N 16), one short chunk, a small batch of whole
# chunks
CUDA_CASES = [(2, 1000, 24, 64, 128, 64, True, True),
              (1, 1100, 25, 64, 16, 64, False, True),
              (2, 29, 4, 32, 32, 64, True, False),
              (4, 256, 8, 64, 64, 64, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4),
                                       ("bfloat16", 2e-2)])
def test_cuda_ssd_bwd_vs_plain(dtype, tol):
    """The forward's saved chunk-entry states against the plain scan's,
    and every gradient of the backward kernel within ``tol`` x max(1, max
    |plain|) of autograd through the plain tiled forward on the same
    inputs (bf16: x, b, c, dy in bf16; f32 arithmetic both sides)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    dev = torch.device("cuda")
    for Bt, L, H, P, N, chunk, init, dfinal in CUDA_CASES:
        arrs = _inputs(Bt, L, H, P, N, seed=L, init=init, dfinal=dfinal)
        x, dt, a, b, c, s0, dy, df = [_t(v, dev) for v in arrs]
        if dtype == "bfloat16":
            x, b, c, dy = (v.to(torch.bfloat16) for v in (x, b, c, dy))
        runtime.reset_counters()
        y, final, entry = SS.ssd_scan_train_cuda(x, dt, a, b, c, chunk, s0)
        got = SS.ssd_scan_bwd_cuda(x, dt, a, b, c, chunk, entry, dy, df)
        torch.cuda.synchronize()
        counts = runtime.read_counters()
        assert counts["ssd_scan_bwd"] == {"kernel": 1, "plain": 0}
        _, states = SS.ssd_intra_chunk_tiled_plain(x, dt, a, b, c, chunk)
        want_entry = SS.ssd_entry_states_tiled_plain(states, dt, a, chunk,
                                                     s0)
        what = f"{(Bt, L, H, P, N)} {dtype}"
        _close(entry.cpu().numpy(), want_entry.cpu().numpy(), tol,
               what=f"{what} entry")
        want = SS.ssd_scan_bwd_tiled_plain(x, dt, a, b, c, chunk, s0, dy, df)
        for n, g, w in zip(NAMES, got, want):
            assert g.dtype == w.dtype and bool(torch.isfinite(g).all()), n
            _close(g.float().cpu().numpy(), w.float().cpu().numpy(), tol,
                   what=f"{what} {n}")


@pytest.mark.cuda
def test_cuda_ssdscan_function_launches_the_kernels():
    """Under autograd on CUDA tensors ``ops.ssd_scan`` launches K4's two
    forward launches and its backward kernel, no plain version, and its
    gradients equal the plain backward's within the f32 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    dev = torch.device("cuda")
    arrs = _inputs(2, 300, 6, 64, 32, seed=1, init=True, dfinal=True)
    x, dt, a, b, c, s0, dy, df = [_t(v, dev) for v in arrs]
    ins = [v.clone().requires_grad_(True) for v in (x, dt, a, b, c, s0)]
    runtime.reset_counters()
    y, final = ops.ssd_scan(*ins[:5], 64, ins[5])
    got = torch.autograd.grad((y * dy).sum() + (final * df).sum(), ins)
    torch.cuda.synchronize()
    counts = runtime.read_counters()
    for name in ("ssd_intra_chunk", "ssd_chunk_scan", "ssd_scan_bwd"):
        assert counts[name] == {"kernel": 1, "plain": 0}, counts
    want = SS.ssd_scan_bwd_tiled_plain(x, dt, a, b, c, 64, s0, dy, df)
    for n, g, w in zip(NAMES, got, want):
        _close(g.cpu().numpy(), w.cpu().numpy(), 1e-4, what=n)
