"""The port's layers and TConst core against the JAX package.

Same inputs (numpy, from a seed), same weights (the JAX init carried over
by ``repro_torch.bridge``), f32 at atol 1e-4 as ``tests/test_tconst_core.py``
does: layers, the bridge, ``tconst_forward`` / ``prefill`` / ``resync`` /
``decode_step`` on the tiny config of that file and on
``reduced(tconst_41m)``, plus the port's own copies of the paper's
invariants (decode + resync == training forward with exactly 3 misses
over 27 steps; Eq. 7 cache bytes constant in N).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JC
from repro.core import tconst as JT
from repro.layers import attention as JA
from repro.layers import common as JCOM
from repro.layers import embed as JE
from repro.layers import mlp as JM
from repro.layers import rope as JR
from repro_torch import config as PC
from repro_torch.core import tconst as PT
from repro_torch.layers import attention as PA
from repro_torch.layers import common as PCOM
from repro_torch.layers import embed as PE
from repro_torch.layers import mlp as PM
from repro_torch.layers import rope as PR
from repro_torch.models.api import build_model
from torch_parity import build_pair, jax_tiny_cfg, port_cfg
from torch_parity import t as _t

torch.set_num_threads(1)
ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_cfg()
    jparams, pparams = build_pair(jcfg)
    tokens = np.random.RandomState(1).randint(0, 97, size=(2, 32)).astype(
        np.int32)
    jlogits, _ = JT.tconst_forward(jparams, jnp.asarray(tokens), jcfg)
    return jcfg, port_cfg(jcfg), jparams, pparams, tokens, np.asarray(jlogits)


@pytest.fixture(scope="module")
def reduced41():
    jcfg = JC.reduced(JC.get_config("tconst_41m"), dtype="float32")
    jparams, pparams = build_pair(jcfg, seed=2)
    return jcfg, port_cfg(jcfg), jparams, pparams


# ---------------------------------------------------------------------------
# layers and the bridge
# ---------------------------------------------------------------------------


def test_config_copy_matches_jax():
    archs = ["deepseek_moe_16b", "gemma3_4b", "hymba_1_5b", "llama3_405b",
             "mamba2_130m", "minicpm_2b", "mixtral_8x22b", "qwen2_vl_2b",
             "smollm_360m", "tconst_41m", "whisper_small"]
    for arch in archs:
        j = JC.get_config(arch)
        p = PC.get_config(arch)
        assert port_cfg(j) == p
        assert port_cfg(JC.reduced(j)) == PC.reduced(p)
    assert PC.list_archs() == archs


def test_norm_rope_mlp_embed_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32)
    scale = rng.rand(64).astype(np.float32) + 0.5
    np.testing.assert_allclose(
        PCOM.rmsnorm({"scale": _t(scale)}, _t(x)).numpy(),
        np.asarray(JCOM.rmsnorm({"scale": jnp.asarray(scale)},
                                jnp.asarray(x))), atol=1e-5)

    pos = rng.randint(0, 999, size=(2, 5)).astype(np.int32)
    jc, js = JR.rope_cos_sin(jnp.asarray(pos), 36, 10000.0)
    pc, ps = PR.rope_cos_sin(_t(pos), 36, 10000.0)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)
    xh = rng.randn(2, 5, 3, 36).astype(np.float32)
    np.testing.assert_allclose(
        PR.apply_rope(_t(xh), pc, ps).numpy(),
        np.asarray(JR.apply_rope(jnp.asarray(xh), jc, js)), atol=1e-5)

    ffn = {n: rng.randn(*s).astype(np.float32) * 0.1 for n, s in
           (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    np.testing.assert_allclose(
        PM.swiglu({n: _t(w) for n, w in ffn.items()}, _t(x)).numpy(),
        np.asarray(JM.swiglu({n: jnp.asarray(w) for n, w in ffn.items()},
                             jnp.asarray(x))), atol=1e-5)

    tok = rng.randn(97, 64).astype(np.float32)
    ids = rng.randint(0, 97, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        PE.embed_tokens({"tok": _t(tok)}, _t(ids), torch.float32).numpy(),
        np.asarray(JE.embed_tokens({"tok": jnp.asarray(tok)},
                                   jnp.asarray(ids), jnp.float32)))
    for cap in (0.0, 5.0):
        np.testing.assert_allclose(
            PE.lm_head({"tok": _t(tok)}, _t(x), cap).numpy(),
            np.asarray(JE.lm_head({"tok": jnp.asarray(tok)},
                                  jnp.asarray(x), cap)), atol=1e-4)


def test_attention_layer_matches_jax():
    rng = np.random.RandomState(1)
    attn = {"wq": rng.randn(64, 4, 16), "wk": rng.randn(64, 2, 16),
            "wv": rng.randn(64, 2, 16), "wo": rng.randn(4, 16, 64)}
    attn = {n: (w * 0.1).astype(np.float32) for n, w in attn.items()}
    ja = {n: jnp.asarray(w) for n, w in attn.items()}
    pa = {n: _t(w) for n, w in attn.items()}
    xq = rng.randn(2, 6, 64).astype(np.float32)
    xkv = rng.randn(2, 9, 64).astype(np.float32)
    for jt, pt in zip(JA.qkv_proj(ja, jnp.asarray(xq), jnp.asarray(xkv),
                                  jnp.float32),
                      PA.qkv_proj(pa, _t(xq), _t(xkv), torch.float32)):
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-5)
    o = rng.randn(2, 6, 4, 16).astype(np.float32)
    np.testing.assert_allclose(
        PA.out_proj(pa, _t(o), torch.float32).numpy(),
        np.asarray(JA.out_proj(ja, jnp.asarray(o), jnp.float32)), atol=1e-5)

    qp = np.array([[3, 4, 5, 6, 7, 8], [-2, -1, 0, 1, 2, 3]], np.int32)
    kp = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    for mode in ("causal", "sliding", "full"):
        jm = JA.make_mask(jnp.asarray(qp), jnp.asarray(kp), mode, 3)
        pm = PA.make_mask(_t(qp), _t(kp), mode, 3)
        assert (jm is None) == (pm is None)
        if pm is not None:
            np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))

    # masked-safe sdpa: causal mask AND kv_valid, with fully masked rows
    q = rng.randn(2, 6, 4, 16).astype(np.float32)
    k = rng.randn(2, 9, 2, 16).astype(np.float32)
    v = rng.randn(2, 9, 2, 16).astype(np.float32)
    kv_valid = kp < np.array([[9], [2]])
    jm = JA.make_mask(jnp.asarray(qp), jnp.asarray(kp), "causal")
    ref = JA.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                  kv_valid=jnp.asarray(kv_valid))
    got = PA.sdpa(_t(q), _t(k), _t(v), PA.make_mask(_t(qp), _t(kp),
                                                      "causal"),
                  kv_valid=_t(kv_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert not got[1, :2].any(), "fully masked query rows give zeros"

    # the K2-routed attention block equals the JAX block on the same mask
    pos_q = _t(qp)
    kpos = torch.where(_t(kv_valid), _t(kp), torch.full_like(_t(kp),
                                                              PT.INVALID_POS))
    cq, sq = PR.rope_cos_sin(pos_q.clamp(min=0), 16, 1e4)
    ck, sk = PR.rope_cos_sin(_t(kp), 16, 1e4)
    got = PA.attention_block(pa, _t(xq), _t(xkv), pos_q, kpos, cq, sq, ck,
                             sk)
    jcq, jsq = JR.rope_cos_sin(jnp.maximum(jnp.asarray(qp), 0), 16, 1e4)
    jck, jsk = JR.rope_cos_sin(jnp.asarray(kp), 16, 1e4)
    ref = JA.attention_block(ja, jnp.asarray(xq), jnp.asarray(xkv),
                             jnp.logical_and(jm, jnp.asarray(kv_valid)[:, None]),
                             jcq, jsq, jck, jsk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_bridge_maps_every_leaf(tiny):
    jcfg, cfg, jparams, pparams, _, _ = tiny
    jleaves = jax.tree_util.tree_leaves(jparams)
    pleaves = [t for b in pparams["blocks"] for layer in b["layers"]
               for part in layer.values() for t in part.values()]
    pleaves += list(pparams["embed"].values()) + \
        [pparams["final_norm"]["scale"]]
    assert sum(x.size for x in jleaves) == sum(t.numel() for t in pleaves)
    assert len(pparams["blocks"]) == cfg.tconst_blocks
    assert len(pparams["blocks"][0]["layers"]) == cfg.tconst.block_depth
    jl = jparams["blocks"]["layers"][3]["attn"]["wo"]
    np.testing.assert_array_equal(
        pparams["blocks"][1]["layers"][3]["attn"]["wo"].numpy(),
        np.asarray(jl[1]))
    assert tuple(pparams["blocks"][0]["layers"][0]["attn"]["wq"].shape) == \
        (cfg.d_model, cfg.n_heads, cfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# the TConst core vs JAX
# ---------------------------------------------------------------------------


def test_forward_matches_jax(tiny):
    _, cfg, _, pparams, tokens, jlogits = tiny
    logits, _ = PT.tconst_forward(pparams, _t(tokens), cfg)
    assert logits.shape == (2, 32, 97)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=ATOL)


@pytest.mark.parametrize("n0", [5, 8, 9, 21, 31])
def test_prefill_matches_jax(tiny, n0):
    jcfg, cfg, jparams, pparams, tokens, jlogits = tiny
    lg, cache = PT.prefill(pparams, _t(tokens[:, :n0]), cfg, max_len=64)
    jlg, jcache = JT.prefill(jparams, jnp.asarray(tokens[:, :n0]), jcfg,
                             max_len=64)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL)
    np.testing.assert_allclose(lg.numpy(), jlogits[:, n0 - 1], atol=ATOL)
    for f in ("ctx_k", "ctx_v", "gen_k", "gen_v"):
        np.testing.assert_allclose(cache[f].numpy(), np.asarray(jcache[f]),
                                   atol=ATOL, err_msg=f)
    for f in ("tokens", "hist_len", "gen_len", "ctx_valid"):
        np.testing.assert_array_equal(cache[f].numpy(),
                                      np.asarray(jcache[f]), err_msg=f)


def test_decode_step_and_resync_match_jax(tiny):
    jcfg, cfg, jparams, pparams, tokens, _ = tiny
    _, cache = PT.prefill(pparams, _t(tokens[:, :13]), cfg, max_len=64)
    _, jcache = JT.prefill(jparams, jnp.asarray(tokens[:, :13]), jcfg,
                           max_len=64)
    for t in range(13, 17):
        lg, cache = PT.decode_step(pparams, cache, _t(tokens[:, t]), cfg)
        jlg, jcache = JT.decode_step(jparams, jcache,
                                     jnp.asarray(tokens[:, t]), jcfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL)
    cache = PT.resync(pparams, cache, cfg)
    jcache = JT.resync(jparams, jcache, jcfg)
    for f in ("ctx_k", "ctx_v", "gen_k", "gen_v"):
        np.testing.assert_allclose(cache[f].numpy(), np.asarray(jcache[f]),
                                   atol=ATOL, err_msg=f)
    for f in ("tokens", "hist_len", "gen_len", "ctx_valid"):
        np.testing.assert_array_equal(cache[f].numpy(),
                                      np.asarray(jcache[f]), err_msg=f)


def test_decode_with_resync_matches_train_forward(tiny):
    """Paper invariant 1 on the port: prefill + O(1) steps + periodic
    resync reproduce the teacher-forced logits, 3 misses in 27 steps."""
    _, cfg, _, pparams, tokens, jlogits = tiny
    logits, _ = PT.tconst_forward(pparams, _t(tokens), cfg)
    lg, cache = PT.prefill(pparams, _t(tokens[:, :5]), cfg, max_len=64)
    n_miss = 0
    for t in range(5, tokens.shape[1]):
        if int(cache["gen_len"][0]) == cfg.tconst.w_og:
            cache = PT.resync(pparams, cache, cfg)
            n_miss += 1
        lg, cache = PT.decode_step(pparams, cache, _t(tokens[:, t]), cfg)
        np.testing.assert_allclose(lg.numpy(), logits[:, t].numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(lg.numpy(), jlogits[:, t], atol=ATOL)
    assert n_miss == 3


def test_kv_cache_eq7_constant_in_N(tiny):
    _, cfg, _, _, _, _ = tiny
    tc = cfg.tconst
    kv_frac = cfg.n_kv_heads * cfg.resolved_head_dim / cfg.d_model
    for B, max_len in [(2, 64), (2, 4096), (4, 64)]:
        got = PT.kv_cache_bytes(PT.init_tconst_cache(cfg, B, max_len))
        expect = cfg.tconst_blocks * 4 * B * cfg.d_model * kv_frac * 2 * (
            (tc.h + 1) * tc.w_oh + (tc.h + 2) * tc.w_og)
        assert got == int(expect)
    assert PT.kv_cache_bytes(PT.init_tconst_cache(cfg, 2, 64)) == \
        PT.kv_cache_bytes(PT.init_tconst_cache(cfg, 2, 1 << 16))


def test_ctx_valid_is_a_suffix(tiny):
    """K1's cross-attention takes [W_oh - n_valid, W_oh): exact only
    because the valid context slots always form a suffix."""
    _, cfg, _, pparams, tokens, _ = tiny
    W = cfg.tconst.w_oh
    cache = PT.init_tconst_cache(cfg, 4, 40)
    cache["tokens"][:, :32] = _t(np.tile(tokens[:1], (4, 1)))
    cache["hist_len"] = torch.tensor([0, 3, 8, 29], dtype=torch.int32)
    out = PT.resync(pparams, cache, cfg)
    for b, n in enumerate([0, 3, 8, 8]):
        expect = np.arange(W) >= W - n
        np.testing.assert_array_equal(out["ctx_valid"][b].numpy(), expect)


def test_reduced_41m_matches_jax(reduced41):
    jcfg, cfg, jparams, pparams = reduced41
    tokens = np.random.RandomState(4).randint(
        0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    jlogits, _ = JT.tconst_forward(jparams, jnp.asarray(tokens), jcfg)
    logits, _ = PT.tconst_forward(pparams, _t(tokens), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL)
    lg, cache = PT.prefill(pparams, _t(tokens[:, :11]), cfg, max_len=48)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlogits)[:, 10],
                               atol=ATOL)
    for t in range(11, 24):
        if int(cache["gen_len"][0]) == cfg.tconst.w_og:
            cache = PT.resync(pparams, cache, cfg)
        lg, cache = PT.decode_step(pparams, cache, _t(tokens[:, t]), cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlogits)[:, t],
                                   atol=ATOL)


def test_init_is_seeded_and_shaped(reduced41):
    _, cfg, _, pparams = reduced41
    a = PT.init_tconst_lm(cfg, seed=5, device="cpu")
    b = PT.init_tconst_lm(cfg, seed=5, device="cpu")
    def leaves(p):
        return {(i, j, part, n): t for i, blk in enumerate(p["blocks"])
                for j, layer in enumerate(blk["layers"])
                for part, d in layer.items() for n, t in d.items()}

    la, lb, lp = leaves(a), leaves(b), leaves(pparams)
    assert all(torch.equal(la[key], lb[key]) for key in la)
    assert {key: t.shape for key, t in la.items()} == \
        {key: t.shape for key, t in lp.items()}
    assert a["embed"]["tok"].shape == pparams["embed"]["tok"].shape


def test_unported_paths_raise_and_name_the_roadmap(tiny):
    """``prefill_bucketed`` is ported (tests/test_torch_prefill_chunked.
    py); the speculative verify is not."""
    _, cfg, _, pparams, tokens, _ = tiny
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PT.verify_chunk_views(pparams, {}, _t(tokens), cfg)


def test_default_device_is_cuda(tiny):
    """Entry points run on cuda unless the caller asks for the CPU; with
    no GPU that is an error, never a silent CPU fallback."""
    _, cfg, _, _, _, _ = tiny
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"
