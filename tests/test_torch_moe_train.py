"""Training the MoE family in the port, against the JAX package.

* ``moe_ffn``'s VJP against ``jax.vjp`` of JAX's ``moe_ffn`` (the
  router, every expert weight, the shared expert and the input; the aux
  loss's cotangent too): with capacity drops (a router skewed so every
  token's first choice is one expert) and dropless at ``capacity_factor
  = E / K``, at 1e-5 of each leaf's max (f32).  The gradient reaches the
  router through the renormalised top-k gates and the aux's mean router
  probability; dropped choices pass none.
* The loss, the aux and every gradient leaf of ``ModelAPI.loss`` against
  ``jax.value_and_grad(api.loss)`` for reduced deepseek and mixtral, as
  LMs and in tconst mode (1e-5 / 1e-4 of the leaf's max).
* One ``make_train_step`` step at ``n_micro`` 2 (AdamW, eps 1e-5)
  against JAX's: each microbatch routes its own groups on both sides.
* The train launcher on the CPU: its MoE leaves are float32 (the serving
  init's bf16 weights are them rounded), and its checkpoint is
  byte-equal to JAX's ``save_train_state`` of the same state, both ways.
Weights are JAX's, bridged; inputs are made with numpy from a seed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JC
from repro.core import tconst as JT
from repro.layers import moe as JM
from repro.models import api as JAPI
from repro_torch import bridge
from repro_torch.launch import train
from repro_torch.layers import moe as PM
from repro_torch.models.api import build_model
from repro_torch.training.optim import tree_leaves
from torch_parity import (assert_loss_grads_match_jax,
                          assert_train_cli_checkpoint_equals_jax,
                          assert_train_step_matches_jax, jax_to_numpy,
                          lm_pair, port_cfg)

torch.set_num_threads(1)

TOL = 1e-5          # f32: the same function summed in another order


@functools.lru_cache(maxsize=None)
def ffn_pair(arch):
    """(JAX cfg, JAX MoE params, the port's cfg, the same params as
    torch) for one reduced MoE FFN of ``arch`` in f32."""
    jcfg = JC.reduced(JC.get_config(arch), dtype="float32")
    jp = jax_to_numpy(JM.init_moe(jax.random.PRNGKey(3), jcfg))
    return jcfg, jp, port_cfg(jcfg)


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _skewed(jp, x):
    """The router with a column that every token of ``x`` favours: the
    first choice of all tokens is expert 0, past its capacity."""
    r = np.array(jp["router"])
    r[:, 0] += 2.0 * x.reshape(-1, x.shape[-1]).mean(axis=0)
    return {**jp, "router": r}


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mixtral_8x22b"])
@pytest.mark.parametrize("drops", [True, False])
def test_moe_ffn_vjp_matches_jax(arch, drops):
    jcfg, jp, cfg = ffn_pair(arch)
    rs = np.random.RandomState(7)
    x = (rs.randn(2, 32, jcfg.d_model) + 1.0).astype(np.float32)
    cf = None
    if drops:
        jp = _skewed(jp, x)
    else:
        cf = jcfg.n_experts / jcfg.n_experts_per_tok
    dy = rs.randn(*x.shape).astype(np.float32)
    daux = np.float32(0.37)
    params = _torch_tree(jp)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    live = [p.requires_grad_(True) for p in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = PM.moe_ffn(jax.tree_util.tree_unflatten(treedef, live), xt,
                        cfg, capacity_factor=cf)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + aux * daux,
                              live + [xt])
    (jy, jaux), vjp = jax.vjp(
        lambda p, v: JM.moe_ffn(p, v, jcfg, capacity_factor=cf),
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), jy, atol=TOL, rtol=0)
    assert abs(aux.item() - float(jaux)) <= TOL
    jgp, jgx = vjp((jnp.asarray(dy), jnp.asarray(daux)))
    want = jax.tree_util.tree_leaves(jgp) + [jgx]
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert float(np.abs(g.numpy() - w).max()) <= TOL * max(scale, 1.0)
    # the skewed router drops choices; the dropless factor drops none
    logits = xt.detach().reshape(1, -1, jcfg.d_model) @ params["router"]
    cap = PM._capacity(64, jcfg.n_experts, jcfg.n_experts_per_tok,
                       cf or PM.CAPACITY_FACTOR)
    gate = PM.route_topk(logits, jcfg.n_experts_per_tok, cap)[2]
    assert bool((gate == 0).any()) == drops


@functools.lru_cache(maxsize=None)
def tconst_pair(arch):
    jcfg = JC.reduced(JC.get_config(arch), dtype="float32",
                      attention_mode="tconst")
    jparams = JT.init_tconst_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, port_cfg(jcfg), \
        bridge.params_from_jax(jax_to_numpy(jparams))


PAIRS = {"deepseek": lambda: lm_pair("deepseek"),
         "mixtral": lambda: lm_pair("mixtral"),
         "deepseek-tconst": lambda: tconst_pair("deepseek_moe_16b"),
         "mixtral-tconst": lambda: tconst_pair("mixtral_8x22b")}


def _tokens(cfg, B, L, seed):
    return {"tokens": np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(B, L)).astype(np.int32)}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_loss_aux_and_gradients_match_jax(name):
    jcfg, jparams, cfg, params = PAIRS[name]()
    batch = _tokens(cfg, 2, 16, 5)
    api = build_model(cfg, device="cpu")
    with torch.no_grad():
        aux = api.loss(params, {"tokens": torch.from_numpy(
            batch["tokens"])})[1]["aux"]
    assert float(aux) > 0.0                  # held to JAX's in the helper
    assert_loss_grads_match_jax(JAPI.build_model(jcfg), jparams, api,
                                params, batch, name)


def test_train_step_n_micro_2_matches_jax():
    jcfg, jparams, cfg, params = lm_pair("deepseek")
    assert_train_step_matches_jax(JAPI.build_model(jcfg), jparams,
                                  build_model(cfg, device="cpu"), params,
                                  _tokens(cfg, 4, 16, 6), "deepseek")


def test_train_cli_checkpoint_equals_jax(tmp_path, capsys):
    assert_train_cli_checkpoint_equals_jax("deepseek_moe_16b",
                                           lm_pair("deepseek")[1], tmp_path,
                                           capsys)


def test_train_load_keeps_moe_leaves_float32():
    """The launcher's MoE leaves are float32 (JAX's param_dtype); the
    serving init (bf16) is the same draws rounded; ``loss`` takes them."""
    args = train.build_parser().parse_args(
        ["--arch", "deepseek_moe_16b", "--reduced", "--device", "cpu"])
    cfg, api, params = train.load(args)
    assert cfg.dtype == "bfloat16" and cfg.is_moe
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))
    serving = bridge.stack_params(api.init(args.seed))
    bf16 = [p for p in tree_leaves(serving) if p.dtype == torch.bfloat16]
    assert bf16
    for f32, s in zip(tree_leaves(params), tree_leaves(serving)):
        assert torch.equal(f32.to(s.dtype), s)
    loss, parts = api.loss(bridge.unstack_params(params), {
        "tokens": torch.zeros((1, 16), dtype=torch.int32)})
    assert torch.isfinite(loss) and float(parts["aux"]) > 0.0
