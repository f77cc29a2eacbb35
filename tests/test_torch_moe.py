"""The port's MoE layer (``repro_torch.layers.moe``) against the JAX
package's (``repro.layers.moe``), on the CPU, f32 unless stated.

* ``route_topk``: the port's (expert, position, gate) per choice, turned
  into JAX's ``combine`` (T, E, C), equals JAX's at 1e-5, with capacity
  drops (JAX's ``dispatch`` drops at least one (token, choice), so the
  choice-major drop order is tested), and the aux loss.
* bf16 router logits with forced ties: the same expert choices as
  ``lax.top_k`` (ties to the lower expert index), the same positions.
* ``moe_ffn``: output and aux loss at 1e-5 against JAX's on reduced
  deepseek (shared expert) and mixtral, with drops; split into routing
  groups at T = 12, 20 and 24; dropless (``capacity_factor = E / K``)
  against ``moe_ffn_dense_oracle`` (JAX's and the port's).
* The group size and capacity of deepseek-moe-16b's served shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JC
from repro.layers import moe as JM
from repro_torch import config as PC
from repro_torch.layers import moe as PM
from torch_parity import jax_to_numpy, port_cfg, t

torch.set_num_threads(1)


def _pair(arch):
    """(JAX cfg, JAX MoE params, the port's cfg, its params) for the
    reduced ``arch`` (4 experts, top-2, width 64), f32."""
    jcfg = JC.reduced(JC.get_config(arch), dtype="float32")
    jp = JM.init_moe(jax.random.PRNGKey(0), jcfg)
    pp = jax.tree_util.tree_map(t, jax_to_numpy(jp))
    return jcfg, jp, port_cfg(jcfg), pp


def _combine(expert, pos, gate, E, C):
    """JAX's ``combine`` (T, E, C) from the port's per-choice routing
    (K, T): gate at (t, expert, pos) of every kept choice."""
    K, T = expert.shape
    out = torch.zeros((T, E, C), dtype=torch.float32)
    kept = gate > 0
    tok = torch.arange(T).expand(K, T)
    out[tok[kept], expert[kept], pos[kept]] = gate[kept]
    return out


@pytest.mark.parametrize("T,E,K,cap", [(40, 4, 2, 8), (33, 8, 2, 4),
                                       (24, 16, 6, 8)])
def test_route_topk_vs_jax_with_drops(T, E, K, cap):
    logits = np.random.RandomState(T).randn(T, E).astype(np.float32)
    jd, jc, jaux = JM.route_topk(jnp.asarray(logits), K, cap)
    assert float(jnp.sum(jd)) < T * K, "JAX dropped no (token, choice)"
    expert, pos, gate, aux = PM.route_topk(t(logits), K, cap)
    assert expert.shape == pos.shape == gate.shape == (K, T)
    assert int((gate > 0).sum()) == int(jnp.sum(jd))
    np.testing.assert_allclose(_combine(expert, pos, gate, E, cap).numpy(),
                               np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    # a stack of groups routes each group on its own
    stack = np.stack([logits, logits[::-1].copy()])
    e2, p2, g2, a2 = PM.route_topk(t(stack), K, cap)
    for g in range(2):
        _, jcg, jag = JM.route_topk(jnp.asarray(stack[g]), K, cap)
        np.testing.assert_allclose(
            _combine(e2[g], p2[g], g2[g], E, cap).numpy(), np.asarray(jcg),
            atol=1e-5, rtol=0)
        np.testing.assert_allclose(a2[g].item(), float(jag), rtol=1e-6)


def test_route_topk_bf16_ties_go_to_the_lower_expert():
    """bf16 logits with exact ties between experts (as rounding makes
    them): the port queues the same experts in the same order as JAX's
    ``lax.top_k`` -- so the same choices keep a slot and the same drop."""
    rng = np.random.RandomState(7)
    T, E, K, cap = 24, 8, 2, 4
    base = rng.randn(T, 4).astype(np.float32)
    # experts (1, 5), (2, 6), (3, 7) and (0, 4) tie exactly, in every token
    logits = np.concatenate([base, base], axis=1)
    jl = jnp.asarray(logits, dtype=jnp.bfloat16)
    pl = torch.from_numpy(logits).to(torch.bfloat16)
    assert np.array_equal(np.asarray(jl.astype(jnp.float32)),
                          pl.float().numpy())
    jd, jc, _ = JM.route_topk(jl, K, cap)
    assert float(jnp.sum(jd)) < T * K
    expert, pos, gate, _ = PM.route_topk(pl, K, cap)
    # each token's two choices are one tied pair: the lower index first
    assert torch.equal(expert[1], expert[0] + 4)
    got = _combine(expert, pos, gate, E, cap).to(torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jc.astype(jnp.float32)))
    np.testing.assert_array_equal((got > 0).numpy(),
                                  np.asarray(jd.astype(jnp.float32)) > 0)


def _moe_pair_inputs(jcfg, B, L, seed):
    return np.random.RandomState(seed).randn(B, L, jcfg.d_model).astype(
        np.float32)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mixtral_8x22b"])
@pytest.mark.parametrize("cf", [None, 0.25])
def test_moe_ffn_vs_jax_with_drops(arch, cf):
    jcfg, jp, cfg, pp = _pair(arch)
    x = _moe_pair_inputs(jcfg, 2, 30, 1)
    jy, jaux = JM.moe_ffn(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    py, paux = PM.moe_ffn(pp, t(x), cfg, capacity_factor=cf)
    assert py.shape == x.shape and py.dtype == torch.float32
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(paux.item(), float(jaux), rtol=1e-5)
    if cf is not None:
        # the case really drops: JAX's dispatch of the one group of 60
        cap = PM._capacity(60, cfg.n_experts, cfg.n_experts_per_tok, cf)
        logits = jnp.asarray(x.reshape(60, -1)) @ jp["router"]
        jd, _, _ = JM.route_topk(logits, jcfg.n_experts_per_tok, cap)
        assert float(jnp.sum(jd)) < 60 * jcfg.n_experts_per_tok


@pytest.mark.parametrize("T,gs", [(12, 4), (20, 4), (24, 8)])
def test_moe_ffn_groups_vs_jax(T, gs):
    """A group size of 8 halves to a divisor of T: 3, 5 and 3 routing
    groups, each with its own capacity."""
    jcfg, jp, cfg, pp = _pair("deepseek_moe_16b")
    assert PM.group_size(T, 8) == gs
    x = _moe_pair_inputs(jcfg, 1, T, T)
    for cf in (None, 0.5):
        jy, jaux = JM.moe_ffn(jp, jnp.asarray(x), jcfg, capacity_factor=cf,
                              group_size=8)
        py, paux = PM.moe_ffn(pp, t(x), cfg, capacity_factor=cf, group=8)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=1e-5)
        np.testing.assert_allclose(paux.item(), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mixtral_8x22b"])
def test_dropless_moe_ffn_equals_dense_oracle(arch):
    jcfg, jp, cfg, pp = _pair(arch)
    x = _moe_pair_inputs(jcfg, 2, 9, 3)
    cf = cfg.n_experts / cfg.n_experts_per_tok
    joracle = JM.moe_ffn_dense_oracle(jp, jnp.asarray(x), jcfg)
    poracle = PM.moe_ffn_dense_oracle(pp, t(x), cfg)
    py, _ = PM.moe_ffn(pp, t(x), cfg, capacity_factor=cf)
    np.testing.assert_allclose(poracle.numpy(), np.asarray(joracle),
                               atol=1e-5)
    np.testing.assert_allclose(py.numpy(), np.asarray(joracle), atol=1e-5)


def test_group_size_and_capacity_of_deepseek():
    """deepseek-moe-16b (64 experts, top-6): one 600-token admission is
    one group with 72 slots an expert; the batch-4 x 1024 engine prefill
    four groups of 1024 with 120; a 2-slot decode step one group of 2
    with the minimum 4 -- as JAX's formula gives them."""
    cfg = PC.get_config("deepseek_moe_16b")
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    for T, gs, cap in ((600, 600, 72), (4096, 1024, 120), (2, 2, 4)):
        assert PM.group_size(T) == gs
        assert PM._capacity(gs, E, K) == JM._capacity(gs, E, K) == cap
    for n in range(1, 300, 7):
        assert PM._capacity(n, E, K) == JM._capacity(n, E, K)
    assert PM.CAPACITY_FACTOR == JM.CAPACITY_FACTOR
    assert PM.GROUP_SIZE == JM.GROUP_SIZE

