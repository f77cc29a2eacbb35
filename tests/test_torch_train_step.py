"""AdamW and the microbatched train step against the JAX package's: two
``adamw_update`` calls fed the same gradients (default, factored, bf16
state), and two train steps of ``make_train_step`` each side computing
its own gradients (n_micro 1 and 2, factored, bf16 state, bf16
accumulation), on ``jax_tiny_cfg``'s base transformer (f32 params,
weights bridged from JAX; params and state compared in JAX's tree
layout, where its layers are stacked as a TConst model's blocks are).
The TConst forward's gradients are ``test_torch_train.py``'s.

Tolerances:
* AdamW on identical inputs: 1e-6 absolute on the params, 1e-5 of the
  leaf's largest |entry| on m and v (f32 state);
* the train steps: each side computes its own gradients, so an entry of
  ~1e-9 can differ in sign between the two, and AdamW's normalisation
  turns it into an update of opposite sign (at the default eps 1e-8,
  ~0.05 of the LR).  The steps run at eps 1e-5, where such an entry
  moves its weight by ~1e-4 of the LR: params within 1e-5, m and v
  within 1e-4 of the leaf's largest |entry|;
* bf16 state or accumulation: a value rounded to bf16 on both sides may
  land one bf16 step (2^-7 relative) apart, once per step: params within
  2 * lr * 2^-7, m and v within 2 * 2^-7 of the leaf's largest |entry|.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.training import optim as JO
from repro.training import schedules as JS
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.training import optim as PO
from repro_torch.training import schedules as PS
from repro_torch.training.train_step import make_train_step
from torch_parity import (assert_tree_close, jax_loss_grads, jax_to_numpy,
                          train_pair, train_tokens)

torch.set_num_threads(1)
LR = 1e-2
BF16_STEP = 2 ** -7

OPT_CASES = {
    "default": {},
    "factored": {"factored": True},
    "bf16_state": {"state_dtype": "bfloat16"},
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_update_on_the_same_gradients_matches_jax(case):
    """Two AdamW steps from the base transformer's params, fed JAX's
    gradients (the second step's scaled by -0.5), on both sides."""
    kw = OPT_CASES[case]
    jparams, params = train_pair("full")[1], train_pair("full")[3]
    grads_np = jax_loss_grads("full")[1]
    jcfg, pcfg = JO.AdamWConfig(lr=LR, **kw), PO.AdamWConfig(lr=LR, **kw)
    jstate, pstate = JO.init_opt_state(jparams, jcfg), \
        PO.init_opt_state(params, pcfg)
    jp, pp = jparams, params
    jupdate = jax.jit(JO.adamw_update, static_argnums=3)
    for mul, lr_scale in ((1.0, 1.0), (-0.5, 0.7)):
        jg = jax.tree_util.tree_map(lambda g: jnp.asarray(g * mul), grads_np)
        pg = _port_tree(grads_np, mul)
        jp, jstate, jinfo = jupdate(jp, jg, jstate, jcfg,
                                    jnp.float32(lr_scale))
        pp, pstate, pinfo = PO.adamw_update(pp, pg, pstate, pcfg,
                                            torch.tensor(lr_scale))
        assert abs(float(jinfo["grad_norm"]) - float(pinfo["grad_norm"])) \
            <= 1e-5 * float(jinfo["grad_norm"])
    bf16 = kw.get("state_dtype") == "bfloat16"
    assert_tree_close(bridge.params_to_jax(bridge.unstack_params(pp)), jax_to_numpy(jp), rel=0.0,
                      atol=2 * LR * BF16_STEP if bf16 else 1e-6,
                      what=f"{case} params")
    so = bridge.opt_state_to_jax(pstate)
    assert int(so["step"]) == int(jstate.step) == 2
    for name in ("m", "v"):
        assert_tree_close(so[name], jax_to_numpy(getattr(jstate, name)),
                          rel=2 * BF16_STEP if bf16 else 1e-5,
                          what=f"{case} {name}")


def _port_tree(grads_np, mul):
    """JAX's gradients of the base transformer (numpy, stacked) as the
    port's stacked tree, times ``mul``."""
    return bridge.stack_params(PO.tree_map(
        lambda t: t * mul, bridge.lm_params_from_jax(grads_np)))


STEP_CASES = {
    # (mode, n_micro, AdamWConfig fields, accum_dtype)
    "full_n1": ("full", 1, {}, "float32"),
    "full_n2_factored": ("full", 2, {"factored": True}, "float32"),
    "full_n1_bf16_state": ("full", 1, {"state_dtype": "bfloat16"},
                           "float32"),
    "full_n2_factored_bf16": ("full", 2,
                              {"factored": True, "state_dtype": "bfloat16"},
                              "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_two_train_steps_match_jax_make_train_step(case):
    mode, n_micro, kw, accum = STEP_CASES[case]
    japi, jparams, api, params = train_pair(mode)
    jcfg = JO.AdamWConfig(lr=LR, eps=1e-5, **kw)
    pcfg = PO.AdamWConfig(lr=LR, eps=1e-5, **kw)
    jstep = jax.jit(j_make_train_step(japi, jcfg, JS.warmup_cosine(1, 4),
                                      n_micro=n_micro, accum_dtype=accum))
    pstep = make_train_step(api, pcfg, PS.warmup_cosine(1, 4),
                            n_micro=n_micro, accum_dtype=accum)
    jstate, pstate = JO.init_opt_state(jparams, jcfg), \
        PO.init_opt_state(params, pcfg)
    jp, pp = jparams, params
    for i in range(2):
        toks = train_tokens(seed=10 + i, batch=4)
        jp, jstate, jm = jstep(jp, jstate, {"tokens": jnp.asarray(toks)})
        pp, pstate, pm = pstep(pp, pstate, {"tokens": torch.from_numpy(toks)})
        assert abs(float(jm["loss"]) - float(pm["loss"])) <= 1e-5
        assert abs(float(jm["lr_scale"]) - float(pm["lr_scale"])) <= 1e-7
    bf16 = "bfloat16" in (kw.get("state_dtype"), accum)
    assert_tree_close(bridge.params_to_jax(bridge.unstack_params(pp)), jax_to_numpy(jp), rel=0.0,
                      atol=2 * LR * BF16_STEP if bf16 else 1e-5,
                      what=f"{case} params")
    so = bridge.opt_state_to_jax(pstate)
    assert int(so["step"]) == int(jstate.step) == 2
    for name in ("m", "v"):
        assert_tree_close(so[name], jax_to_numpy(getattr(jstate, name)),
                          rel=2 * BF16_STEP if bf16 else 1e-4,
                          what=f"{case} {name}")
