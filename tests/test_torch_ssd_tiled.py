"""K4's ragged tiling on the CPU, against the JAX package.

On the card K4 tiles the rows at the model's ``ssm_chunk`` (64) for any
length L, the last chunk holding the rows left; JAX's mixer instead
halves the chunk until it divides L.  The plain mirror of the card's
tiling (``ssd_scan_tiled_plain`` and its two halves, one per launch) is
held against ``ssd_chunked`` and ``ssd_scan_pallas`` (interpret mode) at
the chunk JAX picks, with and without an initial state, at 1e-5 of the
output's scale (f32: the same function summed in another order).  The
CPU path of the wrapper still runs JAX's rule.  Inputs are made with
numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.layers import ssm as JS
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as SS
from repro_torch.layers import ssm as S
from torch_parity import t

torch.set_num_threads(1)

TOL = 1e-5          # f32, relative to max(1, max |reference|)


def _inputs(Bt, L, H, P, N, seed, init):
    rng = np.random.RandomState(seed)
    x = rng.randn(Bt, L, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(Bt, L, H) - 1.0)).astype(np.float32)
    a = -np.exp(rng.randn(H)).astype(np.float32)
    b = rng.randn(Bt, L, N).astype(np.float32)
    c = rng.randn(Bt, L, N).astype(np.float32)
    s0 = rng.randn(Bt, H, P, N).astype(np.float32) if init else None
    return x, dt, a, b, c, s0


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("L", [1, 29, 64, 65, 130, 197])
def test_tiled_mirror_vs_jax(L, init):
    x, dt, a, b, c, s0 = _inputs(2, L, 3, 8, 16, seed=L, init=init)
    q = SS.jax_chunk(64, L)
    jargs = [jnp.asarray(v) for v in (x, dt, a, b, c)]
    j0 = None if s0 is None else jnp.asarray(s0)
    refs = [JS.ssd_chunked(*jargs, q, init_state=j0),
            ssd_scan_pallas(*jargs, q, init_state=j0, interpret=True)]
    y, f = SS.ssd_scan_tiled_plain(t(x), t(dt), t(a), t(b), t(c), 64,
                                   None if s0 is None else t(s0))
    assert y.shape == (2, L, 3, 8) and f.shape == (2, 3, 8, 16)
    for ry, rf in refs:
        _close(y.numpy(), ry)
        _close(f.numpy(), rf)


def test_jax_chunk_rule():
    got = [SS.jax_chunk(64, L) for L in (1, 29, 64, 65, 130, 197, 600, 605,
                                         610, 615, 1024)]
    assert got == [1, 29, 64, 1, 2, 1, 8, 1, 2, 1, 64]


def test_cpu_path_keeps_jax_chunk_rule():
    """The mixer passes ``ssm_chunk`` (64); on the CPU the wrapper still
    runs JAX's chunk (1 at L 605) and its order of sums."""
    x, dt, a, b, c, _ = _inputs(1, 605, 2, 8, 16, seed=5, init=False)
    y, f = ops.ssd_scan(t(x), t(dt), t(a), t(b), t(c), 64)
    yr, fr = S.ssd_chunked(t(x), t(dt), t(a), t(b), t(c), 1)
    _close(y.numpy(), yr.numpy(), 1e-6)
    _close(f.numpy(), fr.numpy(), 1e-6)
    jy, jf = JS.ssd_chunked(*[jnp.asarray(v) for v in (x, dt, a, b, c)], 1)
    _close(y.numpy(), jy, 1e-6)
    _close(f.numpy(), jf, 1e-6)


@pytest.mark.parametrize("L", [64, 128])
def test_tiled_halves_equal_the_pallas_layout_entries(L):
    """Where 64 divides L the two halves of the mirror are the Pallas
    layout's entries (``ssd_intra_chunk_plain``, ``ssd_chunk_scan_plain``)
    with the layout permuted: launch 1's y_intra and states, launch 2's y
    and final state."""
    x, dt, a, b, c, s0 = _inputs(2, L, 3, 8, 16, seed=3, init=True)
    args = [t(v) for v in (x, dt, a, b, c)]
    yi, st = SS.ssd_intra_chunk_tiled_plain(*args, 64)
    xdt, da, bc, cc = SS.prepare(*args, 64)
    ryi, rst = SS.ssd_intra_chunk_plain(xdt, da, bc, cc)
    _close(yi.numpy(), ryi.permute(0, 2, 3, 1, 4).reshape(yi.shape).numpy(),
           1e-6)
    _close(st.numpy(), rst.numpy(), 1e-6)
    y, f = SS.ssd_chunk_scan_tiled_plain(yi, st, args[1], args[2], args[4],
                                         64, t(s0))
    ry, rf = SS.ssd_chunk_scan_plain(ryi, rst, da, cc, t(s0))
    _close(y.numpy(), ry.permute(0, 2, 3, 1, 4).reshape(y.shape).numpy(),
           1e-6)
    _close(f.numpy(), rf.numpy(), 1e-6)


@pytest.mark.parametrize("chunk", [1, 16, 64])
def test_tiled_mirror_is_the_same_function_at_any_tile(chunk):
    """Any tile gives the same scan (tile 1 is the plain recurrence):
    the ragged tail changes the order of sums, not the result."""
    x, dt, a, b, c, s0 = _inputs(2, 75, 3, 8, 16, seed=chunk, init=True)
    args = [t(v) for v in (x, dt, a, b, c)]
    y, f = SS.ssd_scan_tiled_plain(*args, chunk, t(s0))
    ry, rf = SS.ssd_scan_tiled_plain(*args, 75, t(s0))
    _close(y.numpy(), ry.numpy())
    _close(f.numpy(), rf.numpy())


def test_tiled_mirror_never_produces_nan_on_steep_decay():
    """exp(cs_l - cs_s) overflows above the diagonal when the decay is
    steep, in the ragged last chunk as in a full one."""
    x = torch.ones((1, 80, 2, 8))
    dt = torch.full((1, 80, 2), 30.0)
    a = torch.ones((2,))
    b = torch.ones((1, 80, 16))
    y, f = SS.ssd_scan_tiled_plain(x, dt, -a, b, b, 64)
    assert torch.isfinite(y).all() and torch.isfinite(f).all()


def test_tiled_mirror_keeps_the_input_dtype():
    """bf16 inputs (the bf16 model's): y comes back in bf16, the state in
    f32, equal to the f32 mirror on the same (bf16-rounded) values."""
    x, dt, a, b, c, _ = _inputs(1, 70, 2, 8, 16, seed=9, init=False)
    xb, bb, cb = (t(v).bfloat16() for v in (x, b, c))
    y, f = SS.ssd_scan_tiled_plain(xb, t(dt), t(a), bb, cb, 64)
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32
    ry, rf = SS.ssd_scan_tiled_plain(xb.float(), t(dt), t(a), bb.float(),
                                     cb.float(), 64)
    assert torch.equal(y, ry.bfloat16())
    assert torch.equal(f, rf)


def test_kernel_inputs_are_read_in_place():
    """The mixer's x, b and c are slices of one conv output: aligned
    slices go to the kernels as they are (no copy), a misaligned one is
    packed."""
    xbc = torch.zeros((2, 12, 1792), dtype=torch.bfloat16)
    x = xbc[..., :1536].reshape(2, 12, 24, 64)
    b, c = xbc[..., 1536:1664], xbc[..., 1664:]
    for v, inner in ((x, 2), (b, 1), (c, 1)):
        assert SS._rows(v, inner).data_ptr() == v.data_ptr()
    odd = xbc[..., 1:129]
    packed = SS._rows(odd, 1)
    assert packed.is_contiguous() and packed.data_ptr() != odd.data_ptr()
    assert torch.equal(packed, odd)
