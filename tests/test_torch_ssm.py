"""The port's SSM slice against the JAX package, on the CPU.

* K4's plain versions (``ssd_intra_chunk_plain`` and the chunk-scan loop)
  against ``ssd_intra_chunk_pallas`` / ``ssd_scan_pallas`` in interpret
  mode and against ``ssd_chunked``: atol 1e-5 for the intra block (one
  chunk of f32 sums), 2e-4 for the whole scan (``tests/test_kernels.py``'s
  tolerance: the chunked and the Pallas forms sum in other orders).
* The mamba2 layer: ``ssd_step``, ``causal_conv`` (with ``valid_len``) and
  ``ssm_mixer`` (chunked and stepwise) against ``repro.layers.ssm``.
* The LM: ``lm_forward``, ``lm_prefill`` logits and 6 decode steps against
  ``repro.models.lm`` on bridged weights, f32, atol 1e-4
  (``tests/test_archs.py``'s tolerance), at prompt lengths whose chunk is
  1 and 8, on ``reduced(mamba2_130m)`` and a tiny SSM config.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_intra_chunk_pallas, ssd_scan_pallas
from repro.layers import ssm as JS
from repro.models import lm as JLM
from repro_torch import runtime
from repro_torch.config import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as SS
from repro_torch.layers import ssm as S
from repro_torch.models import lm as LM
from repro_torch.models.api import build_decode, build_model
from torch_parity import ssm_pair, t

torch.set_num_threads(1)


def _scan_inputs(Bt, L, H, P, N, seed):
    """x, dt (softplus of a normal), a (negative), b, c as numpy f32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(Bt, L, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(Bt, L, H))).astype(np.float32)
    a = -np.exp(rng.randn(H)).astype(np.float32)
    b = rng.randn(Bt, L, N).astype(np.float32)
    c = rng.randn(Bt, L, N).astype(np.float32)
    return x, dt, a, b, c


# ---------------------------------------------------------------------------
# K4: the plain versions against the Pallas kernel and the chunked oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Q", [1, 2, 8, 16])
def test_intra_chunk_plain_vs_pallas(Q):
    rng = np.random.RandomState(Q)
    B, H, nc, P, N = 2, 3, 3, 8, 16
    xdt = (rng.randn(B, H, nc, Q, P) * 0.1).astype(np.float32)
    da = -np.log1p(np.exp(rng.randn(B, H, nc, Q))).astype(np.float32)
    b = rng.randn(B, nc, Q, N).astype(np.float32)
    c = rng.randn(B, nc, Q, N).astype(np.float32)
    jy, js = ssd_intra_chunk_pallas(jnp.asarray(xdt), jnp.asarray(da),
                                    jnp.asarray(b), jnp.asarray(c),
                                    interpret=True)
    y, st = SS.ssd_intra_chunk_plain(t(xdt), t(da), t(b), t(c))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("chunk,init", [(8, False), (8, True), (4, True),
                                        (1, False)])
def test_ssd_scan_vs_pallas_and_chunked(chunk, init):
    Bt, L, H, P, N = 2, 32, 3, 8, 16
    x, dt, a, b, c = _scan_inputs(Bt, L, H, P, N, seed=chunk)
    s0 = np.random.RandomState(7).randn(Bt, H, P, N).astype(np.float32) \
        if init else None
    jargs = [jnp.asarray(v) for v in (x, dt, a, b, c)]
    j0 = None if s0 is None else jnp.asarray(s0)
    y1, f1 = ssd_scan_pallas(*jargs, chunk, init_state=j0, interpret=True)
    y2, f2 = JS.ssd_chunked(*jargs, chunk, init_state=j0)
    y, f = ops.ssd_scan(t(x), t(dt), t(a), t(b), t(c), chunk,
                        None if s0 is None else t(s0))
    for ref_y, ref_f in ((y1, f1), (y2, f2)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=2e-4)
        np.testing.assert_allclose(f.numpy(), np.asarray(ref_f), atol=2e-4)
    # the port's own plain reference is the same function
    yr, fr = S.ssd_chunked(t(x), t(dt), t(a), t(b), t(c), chunk,
                           None if s0 is None else t(s0))
    np.testing.assert_allclose(yr.numpy(), np.asarray(y2), atol=2e-4)
    np.testing.assert_allclose(fr.numpy(), np.asarray(f2), atol=2e-4)


def test_ssd_step_matches_chunked_scan_and_jax():
    Bt, L, H, P, N = 2, 24, 3, 8, 16
    x, dt, a, b, c = _scan_inputs(Bt, L, H, P, N, seed=11)
    st = torch.zeros((Bt, H, P, N))
    ys = []
    for i in range(L):
        y, st = S.ssd_step(st, t(x[:, i]), t(dt[:, i]), t(a), t(b[:, i]),
                           t(c[:, i]))
        ys.append(y)
    y_chk, st_chk = ops.ssd_scan(t(x), t(dt), t(a), t(b), t(c), 8)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_chk.numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(st.numpy(), st_chk.numpy(), atol=2e-4)
    s0 = np.random.RandomState(3).randn(Bt, H, P, N).astype(np.float32)
    jy, js = JS.ssd_step(jnp.asarray(s0), jnp.asarray(x[:, 0]),
                         jnp.asarray(dt[:, 0]), jnp.asarray(a),
                         jnp.asarray(b[:, 0]), jnp.asarray(c[:, 0]))
    py, ps = S.ssd_step(t(s0), t(x[:, 0]), t(dt[:, 0]), t(a), t(b[:, 0]),
                        t(c[:, 0]))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)


def test_intra_chunk_never_produces_nan_on_steep_decay():
    """exp(cs_l - cs_s) overflows above the diagonal when the decay is
    steep: the masked entries must be zeros, not inf * 0 = NaN."""
    B, H, nc, Q, P, N = 1, 2, 1, 16, 4, 8
    xdt = torch.ones((B, H, nc, Q, P))
    da = torch.full((B, H, nc, Q), -30.0)     # cs spans -480 .. -30
    b = torch.ones((B, nc, Q, N))
    y, st = SS.ssd_intra_chunk_plain(xdt, da, b, b)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


def test_ssd_dispatch_takes_plain_on_cpu_and_counts_it():
    x, dt, a, b, c = _scan_inputs(1, 8, 2, 4, 8, seed=2)
    runtime.reset_counters()
    ops.ssd_scan(t(x), t(dt), t(a), t(b), t(c), 4)
    counts = runtime.read_counters()
    assert counts["ssd_intra_chunk"] == {"kernel": 0, "plain": 1}
    assert counts["ssd_chunk_scan"] == {"kernel": 0, "plain": 1}


def test_ssd_cuda_wrappers_refuse_cpu_tensors_and_bad_shapes():
    """No fallback: the kernel wrappers take CUDA tensors or raise; shapes
    beyond the kernels' limits raise on any device."""
    x = torch.zeros((1, 12, 2, 8))
    dt = torch.zeros((1, 12, 2))
    a = torch.zeros((2,))
    b = torch.zeros((1, 12, 16))
    with pytest.raises(ValueError, match="CUDA"):
        SS.ssd_intra_chunk_cuda(x, dt, a, b, b, 4)
    with pytest.raises(ValueError, match="CUDA"):
        SS.ssd_chunk_scan_cuda(x, torch.zeros((1, 2, 3, 8, 16)), dt, a, b, 4)
    SS.check_shapes(x, dt, a, b, b, 4)
    for shape_q, shape_p, shape_n in ((65, 8, 16), (4, 65, 16),
                                      (4, 8, 129)):
        with pytest.raises(ValueError, match="Q <= 64"):
            SS.check_shapes(torch.zeros((1, 12, 2, shape_p)), dt, a,
                            torch.zeros((1, 12, shape_n)),
                            torch.zeros((1, 12, shape_n)), shape_q)
    with pytest.raises(ValueError, match="bad shapes"):
        SS.check_shapes(x, dt[..., :1], a, b, b, 4)


# ---------------------------------------------------------------------------
# the mamba2 layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("valid", [False, True])
def test_causal_conv_vs_jax(valid):
    rng = np.random.RandomState(5)
    B, L, C, K = 2, 9, 12, 4
    xbc = rng.randn(B, L, C).astype(np.float32)
    w = rng.randn(K, C).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    prev = rng.randn(B, K - 1, C).astype(np.float32)
    vl = np.array([5, 9], np.int32) if valid else None
    jo, jp = JS.causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                            jnp.asarray(bias), jnp.asarray(prev),
                            valid_len=None if vl is None else jnp.asarray(vl))
    po, pp = S.causal_conv(t(xbc), t(w), t(bias), t(prev),
                           valid_len=None if vl is None else t(vl))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-5)


@pytest.mark.parametrize("mode", ["chunked", "stream", "step", "valid_len"])
def test_ssm_mixer_vs_jax(mode):
    jcfg, jparams, cfg, params = ssm_pair()
    jl = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["ssm"])
    pl = params["layers"][0]["ssm"]
    rng = np.random.RandomState(9)
    L = 1 if mode == "step" else 16
    x = rng.randn(2, L, cfg.d_model).astype(np.float32)
    dims = S.ssm_dims(cfg)
    st = None
    if mode in ("stream", "step"):
        st = {"ssm": rng.randn(2, dims.n_heads, dims.head_dim,
                               dims.n_state).astype(np.float32) * 0.1,
              "conv": rng.randn(2, dims.d_conv - 1,
                                dims.conv_dim).astype(np.float32)}
    vl = np.array([11, 16], np.int32) if mode == "valid_len" else None
    jo, jst = JS.ssm_mixer(
        jl, jnp.asarray(x), jcfg,
        state=None if st is None else {k: jnp.asarray(v)
                                       for k, v in st.items()},
        valid_len=None if vl is None else jnp.asarray(vl))
    po, pst = S.ssm_mixer(
        pl, t(x), cfg, state=None if st is None else {k: t(v) for k, v in
                                                      st.items()},
        valid_len=None if vl is None else t(vl))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5)
    if st is not None:
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]),
                                       atol=1e-5)


def test_mixer_from_the_initial_state_equals_the_stateless_mixer():
    """Streaming from ``init_ssm_state`` (zeros) is the stateless forward,
    and its returned state equals JAX's from the same zero state."""
    jcfg, jparams, cfg, params = ssm_pair()
    pl = params["layers"][1]["ssm"]
    x = np.random.RandomState(2).randn(2, 16, cfg.d_model).astype(np.float32)
    st0 = S.init_ssm_state(cfg, 2)
    assert st0["ssm"].dtype == torch.float32 and not st0["ssm"].any()
    assert st0["conv"].dtype == torch.float32       # the config's dtype
    out, st = S.ssm_mixer(pl, t(x), cfg, state=st0)
    ref, _ = S.ssm_mixer(pl, t(x), cfg)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
    jst0 = JS.init_ssm_state(jcfg, 2)
    jl = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"]["ssm"])
    _, jst = JS.ssm_mixer(jl, jnp.asarray(x), jcfg, state=jst0)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   atol=1e-5)


def test_port_init_draws_and_shapes_match_jax():
    jcfg, jparams, cfg, _ = ssm_pair()
    a = LM.init_lm(cfg, seed=5, device="cpu")
    b = LM.init_lm(cfg, seed=5, device="cpu")
    flat_a = jax.tree_util.tree_leaves(a)
    assert all(torch.equal(x, y) for x, y in
               zip(flat_a, jax.tree_util.tree_leaves(b)))
    assert len(a["layers"]) == cfg.n_layers
    for name, leaf in a["layers"][0]["ssm"].items():
        assert tuple(leaf.shape) == \
            tuple(jparams["layers"]["ssm"][name].shape[1:]), name
    m = a["layers"][0]["ssm"]
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert (dt >= 1e-3 * 0.999).all() and (dt <= 1e-1 * 1.001).all()
    H = S.ssm_dims(cfg).n_heads
    assert torch.allclose(m["a_log"], torch.log(torch.arange(1., H + 1)))
    assert m["d_skip"].eq(1).all() and m["norm_scale"].eq(1).all()
    assert not m["conv_b"].any()
    assert "head" in a["embed"]          # mamba2's head is untied


# ---------------------------------------------------------------------------
# the LM: forward, prefill and decode against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("n0", [13, 16])       # chunk 1 and 8 (tiny: 1, 4)
def test_lm_forward_prefill_decode_vs_jax(tiny, n0):
    jcfg, jparams, cfg, params = ssm_pair(tiny)
    toks = np.random.RandomState(n0).randint(
        1, cfg.vocab_size, size=(2, n0 + 6)).astype(np.int32)
    jl, _ = JLM.lm_forward(jparams, jnp.asarray(toks), jcfg, remat=False)
    pl, _ = LM.lm_forward(params, t(toks), cfg)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    jlg, jc = JLM.lm_prefill(jparams, jnp.asarray(toks[:, :n0]), jcfg, 64)
    plg, pc = LM.lm_prefill(params, t(toks[:, :n0]), cfg, 64)
    np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=1e-4)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                   atol=1e-4)
    for i in range(n0, n0 + 6):
        jlg, jc = JLM.lm_decode_step(jparams, jc, jnp.asarray(toks[:, i]),
                                     jcfg)
        plg, pc = LM.lm_decode_step(params, pc, t(toks[:, i]), cfg)
        np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=1e-4)
        # decode after prefill equals the teacher-forced forward
        np.testing.assert_allclose(plg.numpy(), pl[:, i].numpy(),
                                   atol=1e-4)
    assert pc["len"].tolist() == [n0 + 6] * 2


def test_decode_protocol_prefill_into_slot_equals_batch_prefill():
    """The protocol's admission writes the row a batch prefill makes into
    its slot (``len`` and the recurrent state; equal up to the batch
    size's effect on the f32 sums), leaving the other slots at zero."""
    _, _, cfg, params = ssm_pair()
    dec = build_decode(cfg, device="cpu")
    p = dec.prepare_params(params)
    toks = np.random.RandomState(4).randint(1, cfg.vocab_size, size=(2, 13))
    lg, batch = dec.prefill(p, {"tokens": toks}, 64)
    state = dec.init_state(3, 64)
    for slot, row in ((2, 0), (0, 1)):
        lgs, state = dec.prefill_into_slot(p, state, slot, toks[row])
        torch.testing.assert_close(lgs, lg[row], atol=1e-5, rtol=0)
    for k in ("ssm", "conv"):
        torch.testing.assert_close(state.kv[k][:, 2], batch.kv[k][:, 0],
                                   atol=1e-5, rtol=0)
        torch.testing.assert_close(state.kv[k][:, 0], batch.kv[k][:, 1],
                                   atol=1e-5, rtol=0)
        assert not state.kv[k][:, 1].any()
    assert state.bookkeeping["len"].tolist() == [13, 0, 13]


# the base transformer (tconst-41m in full mode) and the MoE family are
# served since the dense attention LMs and MoE were ported; the hybrid
# family is not (item 9)
@pytest.mark.parametrize("arch,over,item", [
    ("mamba2_130m", {"hybrid_parallel": True}, "item 9")])
def test_unported_lm_families_raise_with_their_item(arch, over, item):
    cfg = reduced(get_config(arch), **over)
    with pytest.raises(NotImplementedError, match=item):
        build_model(cfg, device="cpu")
