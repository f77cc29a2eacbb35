"""The port's TLinFormer mode (``attention_mode="tlin"``, paper Fig 1a)
against the JAX package.

Same inputs (numpy, from a seed), same weights (the JAX init carried over
by ``repro_torch.bridge``), f32 at atol 1e-4 as ``tests/test_tconst_core.py``
does: ``tconst_forward``, ``prefill``, ``resync`` and ``decode_step`` in
tlin mode on the tiny config of that file and on
``reduced(tconst_41m, attention_mode="tlin")``; decode + resync equal to
the training forward; the tlin cache growing linearly in N while tconst's
stays constant (paper Fig 8g).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JC
from repro.core import tconst as JT
from repro_torch.core import tconst as PT
from repro_torch.models.api import build_model
from torch_parity import build_pair, jax_tiny_cfg, port_cfg
from torch_parity import t as _t

torch.set_num_threads(1)
ATOL = 1e-4
KV_FIELDS = ("ctx_k", "ctx_v", "gen_k", "gen_v", "hist_k", "hist_v")
BK_FIELDS = ("tokens", "hist_len", "gen_len", "ctx_valid")


def _setup(name):
    if name == "tiny":
        jcfg = jax_tiny_cfg(attention_mode="tlin")
        seed, vocab = 0, 97
    else:
        jcfg = JC.reduced(JC.get_config("tconst_41m"), dtype="float32",
                          attention_mode="tlin")
        seed, vocab = 2, jcfg.vocab_size
    jparams, pparams = build_pair(jcfg, seed)
    tokens = np.random.RandomState(1).randint(0, vocab, size=(2, 32)).astype(
        np.int32)
    jlogits, _ = JT.tconst_forward(jparams, jnp.asarray(tokens), jcfg,
                                   mode="tlin")
    return jcfg, port_cfg(jcfg), jparams, pparams, tokens, np.asarray(jlogits)


@pytest.fixture(scope="module", params=["tiny", "reduced41"])
def tlin(request):
    return _setup(request.param)


def _assert_cache_equal(cache, jcache):
    for f in KV_FIELDS:
        np.testing.assert_allclose(cache[f].numpy(), np.asarray(jcache[f]),
                                   atol=ATOL, err_msg=f)
    for f in BK_FIELDS:
        np.testing.assert_array_equal(cache[f].numpy(),
                                      np.asarray(jcache[f]), err_msg=f)


def test_tlin_forward_matches_jax(tlin):
    _, cfg, _, pparams, tokens, jlogits = tlin
    logits, _ = PT.tconst_forward(pparams, _t(tokens), cfg, mode="tlin")
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=ATOL)
    # the raw-history pathway matters: tconst mode gives other logits
    tc_logits, _ = PT.tconst_forward(pparams, _t(tokens), cfg)
    assert (tc_logits - logits)[:, cfg.tconst.w_og:].abs().max() > 1e-3


@pytest.mark.parametrize("n0", [5, 9, 21])
def test_tlin_prefill_matches_jax(tlin, n0):
    jcfg, cfg, jparams, pparams, tokens, jlogits = tlin
    lg, cache = PT.prefill(pparams, _t(tokens[:, :n0]), cfg, max_len=48,
                           mode="tlin")
    jlg, jcache = JT.prefill(jparams, jnp.asarray(tokens[:, :n0]), jcfg,
                             max_len=48, mode="tlin")
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL)
    np.testing.assert_allclose(lg.numpy(), jlogits[:, n0 - 1], atol=ATOL)
    _assert_cache_equal(cache, jcache)


def test_tlin_decode_step_and_resync_match_jax(tlin):
    jcfg, cfg, jparams, pparams, tokens, _ = tlin
    _, cache = PT.prefill(pparams, _t(tokens[:, :13]), cfg, max_len=48,
                          mode="tlin")
    _, jcache = JT.prefill(jparams, jnp.asarray(tokens[:, :13]), jcfg,
                           max_len=48, mode="tlin")
    for t in range(13, 16):
        lg, cache = PT.decode_step(pparams, cache, _t(tokens[:, t]), cfg,
                                   mode="tlin")
        jlg, jcache = JT.decode_step(jparams, jcache,
                                     jnp.asarray(tokens[:, t]), jcfg,
                                     mode="tlin")
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL)
    cache = PT.resync(pparams, cache, cfg, mode="tlin")
    jcache = JT.resync(jparams, jcache, jcfg, mode="tlin")
    _assert_cache_equal(cache, jcache)


def test_tlin_decode_with_resync_matches_train_forward(tlin):
    """Paper invariant 1 in tlin mode: prefill + steps + periodic resync
    reproduce the teacher-forced logits (3 misses in 27 steps)."""
    _, cfg, _, pparams, tokens, jlogits = tlin
    logits, _ = PT.tconst_forward(pparams, _t(tokens), cfg, mode="tlin")
    lg, cache = PT.prefill(pparams, _t(tokens[:, :5]), cfg, max_len=64,
                           mode="tlin")
    n_miss = 0
    for t in range(5, tokens.shape[1]):
        if int(cache["gen_len"][0]) == cfg.tconst.w_og:
            cache = PT.resync(pparams, cache, cfg, mode="tlin")
            n_miss += 1
        lg, cache = PT.decode_step(pparams, cache, _t(tokens[:, t]), cfg,
                                   mode="tlin")
        np.testing.assert_allclose(lg.numpy(), logits[:, t].numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(lg.numpy(), jlogits[:, t], atol=ATOL)
    assert n_miss == 3


def test_tlin_cache_bytes_linear_in_N_tconst_constant():
    """Fig 8g: the tlin cache adds 2 x nb x N x KV x hd elements (the
    history KV) on top of tconst's constant Eq. 7 cache."""
    cfg = port_cfg(jax_tiny_cfg())
    el = 4 * cfg.n_kv_heads * cfg.resolved_head_dim * cfg.tconst_blocks
    base = PT.kv_cache_bytes(PT.init_tconst_cache(cfg, 2, 64))
    for n in (64, 256, 1024):
        assert PT.kv_cache_bytes(PT.init_tconst_cache(cfg, 2, n)) == base
        tl = PT.kv_cache_bytes(PT.init_tconst_cache(cfg, 2, n, mode="tlin"))
        assert tl == base + 2 * 2 * n * el
    # and the same through the facade, as the engine reports it
    tlin_api = build_model(cfg.replace(attention_mode="tlin"), device="cpu")
    assert tlin_api.decode.mode == "tlin"
    assert tlin_api.decode.init_state(2, 256).kv_bytes() == \
        base + 2 * 2 * 256 * el


def test_tlin_bridge_carries_the_same_weights():
    """TLin is the same model with the history pathway on: the JAX tlin
    init has the tconst init's tree, so one bridge serves both."""
    jcfg = jax_tiny_cfg()
    jp_tc, pp_tc = build_pair(jcfg, 4)
    jp_tl, pp_tl = build_pair(jcfg.replace(attention_mode="tlin"), 4)
    for a, b in zip(pp_tc["blocks"], pp_tl["blocks"]):
        for la, lb in zip(a["layers"], b["layers"]):
            for part in la:
                for n in la[part]:
                    assert torch.equal(la[part][n], lb[part][n])
    assert torch.equal(pp_tc["embed"]["tok"], pp_tl["embed"]["tok"])
