"""The port's training forward and loss against the JAX package's: the
loss and every gradient leaf against ``jax.value_and_grad(api.loss)``
(``jax_tiny_cfg``, f32, modes tconst, tlin and full, weights bridged from
JAX; the gradients compared in JAX's tree layout), the cross entropy and
the LR schedules (equal at steps 0-200).  The loss is within 1e-5 and
each gradient leaf within 1e-4 of its largest |entry| (the two sum in
other orders; seen ~2e-6).  AdamW and the train step:
``test_torch_train_step.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import schedules as JS
from repro_torch import bridge
from repro_torch.models.api import build_model, cross_entropy
from repro_torch.training import optim as PO
from repro_torch.training import schedules as PS
from repro_torch.training.train_step import loss_and_grads
from torch_parity import (assert_tree_close, jax_loss_grads, train_pair,
                          train_tokens)

torch.set_num_threads(1)
MODES = ("tconst", "tlin", "full")


@pytest.mark.parametrize("mode", MODES)
def test_loss_and_gradients_match_jax(mode):
    api, params = train_pair(mode)[2:]
    want_loss, want_grads = jax_loss_grads(mode)
    loss, grads = loss_and_grads(api, params,
                                 {"tokens": torch.from_numpy(train_tokens())})
    assert abs(float(loss) - want_loss) <= 1e-5
    assert_tree_close(bridge.params_to_jax(bridge.unstack_params(grads)), want_grads, rel=1e-4,
                      what=mode)


def test_cross_entropy_matches_jax():
    from repro.models.api import cross_entropy as j_ce
    rs = np.random.RandomState(1)
    logits = rs.randn(2, 5, 11).astype(np.float32) * 3
    tgt = rs.randint(0, 11, size=(2, 5)).astype(np.int32)
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(tgt)))
    assert abs(got - float(j_ce(jnp.asarray(logits), jnp.asarray(tgt)))) \
        <= 1e-6


SCHEDULES = {
    "cosine": (lambda M: M.warmup_cosine(10, 150)),
    "cosine_floor0": (lambda M: M.warmup_cosine(0, 120, floor=0.0)),
    "wsd": (lambda M: M.wsd(10, 127, 20)),
    "wsd_floor": (lambda M: M.wsd(0, 50, 100, floor=0.1)),
    "constant": (lambda M: M.constant()),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_equal_jax_at_steps_0_to_200(name):
    """Equal, bit for bit -- except that the cosine schedules may differ
    by the last bit of cos (XLA's and PyTorch's f32 cos round differently
    at ~10 of 201 steps): there within 2^-23, one f32 step at 1."""
    steps = np.arange(201, dtype=np.int32)
    jf, pf = SCHEDULES[name](JS), SCHEDULES[name](PS)
    want = np.array([float(jf(jnp.asarray(s))) for s in steps], np.float32)
    got = np.array([float(pf(torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps], np.float32)
    if name.startswith("cosine"):
        np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -23)
    else:
        np.testing.assert_array_equal(got, want)


def test_missing_gradient_counts_as_zeros_and_is_decayed():
    p = {"w": torch.ones(3, 4), "s": torch.ones(4)}
    cfg = PO.AdamWConfig(lr=0.1)
    state = PO.init_opt_state(p, cfg)
    out, state, info = PO.adamw_update(p, {"w": None, "s": None}, state,
                                       cfg, torch.tensor(1.0))
    assert float(info["grad_norm"]) == 0.0
    torch.testing.assert_close(out["w"], torch.full((3, 4), 1 - 0.1 * 0.1))
    torch.testing.assert_close(out["s"], torch.ones(4))     # rank 1: no decay

