"""Shared helpers of the port's parity suites (``tests/test_torch_*.py``):
the JAX configuration mirrored as the port's, the JAX init carried over by
``repro_torch.bridge``, and the port's scheduler runner.  The JAX side of
the serving comparisons is ``tests/parity.py``.

A plain importable module, not a conftest (pytest's prepend import mode
puts ``tests/`` on ``sys.path``).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import torch

from repro import config as JC
from repro.core import tconst as JT
from repro.models import lm as JLM
from repro.models.api import build_model as j_build_model
from repro_torch import bridge
from repro_torch import config as PC
from repro_torch.models.api import build_decode, build_model
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session


def jax_tiny_cfg(**kw):
    """``tiny_cfg`` of tests/test_tconst_core.py (GQA group of 2)."""
    base = dict(name="tiny", d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab_size=97, n_layers=8, dtype="float32",
                attention_mode="tconst",
                tconst=JC.TConstConfig(w_oh=8, w_og=8, h=2))
    base.update(kw)
    return JC.ModelConfig(**base)


def port_cfg(jcfg):
    """The same configuration as the port's ModelConfig."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(JC.ModelConfig)}
    kw["tconst"] = PC.TConstConfig(**dataclasses.asdict(jcfg.tconst))
    return PC.ModelConfig(**kw)


def jax_to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def build_pair(jcfg, seed=0):
    """(JAX params, the port's params bridged from them)."""
    jparams = JT.init_tconst_lm(jax.random.PRNGKey(seed), jcfg)
    return jparams, bridge.params_from_jax(jax_to_numpy(jparams))


@functools.lru_cache(maxsize=None)
def ssm_pair(tiny: bool = False):
    """(JAX cfg, JAX params, the port's cfg, its params bridged from
    them) for the SSM family in f32: ``reduced(mamba2_130m)`` or, with
    ``tiny``, a smaller config (d 32, 4 heads of 8, state 8, chunk 4).
    Built once per process."""
    jcfg = JC.reduced(JC.get_config("mamba2_130m"), dtype="float32")
    if tiny:
        jcfg = jcfg.replace(name="tiny-ssm", d_model=32, ssm_head_dim=8,
                            ssm_state=8, ssm_chunk=4, vocab_size=61)
    jparams = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.lm_params_from_jax(jax_to_numpy(jparams))
    return jcfg, jparams, port_cfg(jcfg), params


# the attention LMs of the parity suites: name -> (registry arch,
# reduced() overrides); gemma3 at 6 layers holds its 5 local : 1 global
# pattern (2 layers would both be local); minicpm-2b (G 1, tied head) as
# reduced by JAX.  The MoE family: deepseek (one
# dense layer, then an MoE layer with a shared expert; 4 experts, top-2)
# and mixtral (two MoE layers, window 8, top-2, G 4)
LM_CONFIGS = {
    "smollm": ("smollm_360m", {}),
    "llama3": ("llama3_405b", {}),
    "gemma3": ("gemma3_4b", {"n_layers": 6}),
    "full": ("tconst_41m", {"attention_mode": "full"}),
    "sliding": ("tconst_41m", {"attention_mode": "sliding",
                               "sliding_window": 8}),
    "softcap": ("smollm_360m", {"logit_softcap": 2.0}),
    "minicpm": ("minicpm_2b", {}),
    "deepseek": ("deepseek_moe_16b", {}),
    "mixtral": ("mixtral_8x22b", {}),
}
MOE_CONFIGS = ("deepseek", "mixtral")


@functools.lru_cache(maxsize=None)
def lm_pair(name: str):
    """(JAX cfg, JAX params, the port's cfg, its params bridged from
    them) for ``LM_CONFIGS[name]``, reduced, f32.  Built once per
    process."""
    arch, kw = LM_CONFIGS[name]
    jcfg = JC.reduced(JC.get_config(arch), dtype="float32", **kw)
    jparams = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.lm_params_from_jax(jax_to_numpy(jparams))
    return jcfg, jparams, port_cfg(jcfg), params


def t(a):
    return torch.from_numpy(np.array(a))


def port_streams(cfg, params, prompts, layout=None, *, gen, slots=2,
                 max_len=128, chunk_size=4, stagger=True, device="cpu",
                 **session_kw):
    """The port's scheduler runner, the twin of ``parity.serve_streams``:
    submit every prompt (one chunk between submissions when
    ``stagger``), run to completion.  Returns (streams, scheduler)."""
    sched = SlotScheduler(build_decode(cfg, layout, device=device), params,
                          slots=slots, max_len=max_len,
                          chunk_size=chunk_size)
    sessions = []
    for p in prompts:
        sessions.append(sched.submit(Session(p, max_new_tokens=gen,
                                             **session_kw)))
        if stagger:
            sched.step()
    sched.run()
    return [s.tokens for s in sessions], sched


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_SEQ = 16      # two windows of W_og 8: the first with no history


def train_tokens(seed=0, batch=2):
    return np.random.RandomState(seed).randint(0, 97, size=(
        batch, TRAIN_SEQ)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def train_pair(mode):
    """(JAX api, JAX params, the port's api on the CPU, its params in the
    JAX tree layout bridged from JAX's) for ``jax_tiny_cfg`` in
    attention mode ``mode`` (tconst, tlin or full)."""
    jcfg = jax_tiny_cfg(attention_mode=mode)
    japi = j_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build_model(port_cfg(jcfg), device="cpu")
    tree = jax_to_numpy(jparams)
    params = bridge.params_from_jax(tree) if mode != "full" else \
        bridge.lm_params_from_jax(tree)
    return japi, jparams, api, bridge.stack_params(params)


@functools.lru_cache(maxsize=None)
def jax_loss_grads(mode):
    """(loss, grads as numpy) of ``jax.value_and_grad(api.loss)`` at
    :func:`train_pair`'s params on :func:`train_tokens`."""
    japi, jparams = train_pair(mode)[:2]
    (loss, _), grads = jax.value_and_grad(japi.loss, has_aux=True)(
        jparams, {"tokens": jax.numpy.asarray(train_tokens())})
    return float(loss), jax_to_numpy(grads)


def assert_tree_close(port_np, jax_np, rel, atol=0.0, what=""):
    """Leaf by leaf (the port's tree in JAX's layout, numpy leaves, in
    JAX's flatten order): max |port - jax| <= atol + rel * max |jax|."""
    from repro_torch.training.optim import tree_leaves
    got = tree_leaves(port_np)
    want = jax.tree_util.tree_flatten_with_path(jax_np)[0]
    assert len(got) == len(want), (what, len(got), len(want))
    for a, (path, b) in zip(got, want):
        b = np.asarray(b, dtype=np.float32)
        name = jax.tree_util.keystr(path)
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        if not a.size:
            continue
        err = float(np.abs(a.astype(np.float32) - b).max())
        bound = atol + rel * float(np.abs(b).max())
        assert err <= bound, (what, name, err, bound)
