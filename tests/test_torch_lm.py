"""The port's attention LM families (dense and MoE) against the JAX
package, on the CPU, f32.

* ``lm_forward`` (logits and the MoE aux loss), ``lm_prefill`` (logits
  and the captured K/V cache) and 8 decode steps on each of the four
  layouts against ``repro.models.lm`` / JAX's ``DenseDecode`` on the same
  layout, atol 1e-4 (``tests/test_archs.py``'s tolerance); the dense and
  paged steps also against the port's dense oracle (``lm_decode_step``)
  at 1e-5.  Configs: reduced smollm (G 4), llama3 (MQA), gemma3 at 6
  layers (5 local : 1 global, window 8), tconst-41m in ``full`` (the
  paper's base transformer) and ``sliding`` (window 8) modes, smollm with
  a logit softcap, minicpm-2b (G 1, tied head), and the MoE family: deepseek (one dense layer with its
  own ``dense_k`` / ``dense_v`` cache, then an MoE layer with a shared
  expert) and mixtral (window 8, top-2).  Windows of 8 under prompts of 9
  and 13 tokens reach K1's ``lo > 0`` and K3's ``window > 0``.
* One layer's forward and its decode attention on every view kind,
  atol 1e-5; ``layer_windows`` equal to JAX's.
* The base transformer's seeded init is the TConst model's weights; the
  MoE family's init draws on its device in the activation dtype; the
  other families' inits are unchanged, bit for bit.
* ``_attend_views`` with ``window=0`` is the call the TConst path made
  before windows existed, bit for bit.

The JAX weights are carried across by ``bridge.lm_params_from_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity import make_prompts
from repro import config as JC
from repro.layers import attention as JA
from repro.models import api as JAPI
from repro.models import layouts as JLT
from repro.models import lm as JLM
from repro_torch import config as PC
from repro_torch.core import tconst as PT
from repro_torch.kernels import ops
from repro_torch.layers import attention as A
from repro_torch.models import layouts as PLT
from repro_torch.models import lm as LM
from repro_torch.models.api import build_decode
from torch_parity import LM_CONFIGS, MOE_CONFIGS, lm_pair, t

torch.set_num_threads(1)
PARTS = ("forward", "prefill", "dense", "int8", "paged", "paged_int8")
MAX_LEN = 64


def _forward(name):
    jcfg, jparams, cfg, params = lm_pair(name)
    toks = np.random.RandomState(1).randint(
        1, cfg.vocab_size, size=(2, 21)).astype(np.int32)
    jl, jaux = JLM.lm_forward(jparams, jnp.asarray(toks), jcfg,
                              remat=False)
    pl, aux = LM.lm_forward(params, t(toks), cfg)
    assert pl.dtype == torch.float32
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    if cfg.is_moe:
        assert aux.item() > 0.0
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    else:
        assert aux.item() == 0.0


def _prefill(name):
    jcfg, jparams, cfg, params = lm_pair(name)
    toks = np.random.RandomState(2).randint(
        1, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    jlg, jc = JLM.lm_prefill(jparams, jnp.asarray(toks), jcfg, 32)
    plg, pc = LM.lm_prefill(params, t(toks), cfg, 32)
    np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=1e-4)
    n_dense = LM.n_dense_layers(cfg)
    assert sorted(pc) == sorted(jc) == sorted(
        ["done", "k", "len", "v"] + (["dense_k", "dense_v"] if n_dense
                                     else []))
    for f in _kv_fields(pc):
        layers = n_dense if f.startswith("dense_") else \
            cfg.n_layers - n_dense
        assert tuple(pc[f].shape) == jc[f].shape == \
            (layers, 2, 32, cfg.n_kv_heads, cfg.resolved_head_dim)
        np.testing.assert_allclose(pc[f].numpy(), np.asarray(jc[f]),
                                   atol=1e-4, err_msg=f)
    assert pc["len"].tolist() == [13, 13]


def _kv_fields(cache):
    """The K/V fields of a dense logical cache: ``k`` / ``v`` and, for
    DeepSeek's leading dense layers, ``dense_k`` / ``dense_v``."""
    return [f for f in ("k", "v", "dense_k", "dense_v") if f in cache]


def _adopt_jax_codes(pst, jst, scale_rtol=1e-5):
    """An f32 K/V of the prefill may sit on the other side of a .5
    boundary of x / scale than JAX's: its stored int8 code then differs by
    one (seen: 1 code of 12288 in the sliding config), and while a window
    holds that slot the logits differ by ~3e-4.  Assert that such flips
    are rare and single, then let the port step on JAX's stored codes, so
    the steps are compared on the same cache.  A step's own write may flip
    a code too (seen: 1 code in deepseek's MoE layer on paged_int8, which
    moved the next steps' logits by 1.1e-4): after such a step the port
    adopts JAX's codes again.  A flip in a layer's new K/V moves the later
    layers' K/V of that token (gemma3's 6 layers: a scale 6.5e-5 off,
    relative), hence ``scale_rtol`` 1e-4 after a step."""
    for f, v in pst.kv.items():
        ref = t(np.asarray(jst.kv[f]))
        if f.endswith("__q"):
            flips = (v.int() - ref.int()).abs()
            assert flips.max() <= 1 and flips.float().mean() < 1e-3, f
        elif f.endswith("__scale"):
            np.testing.assert_allclose(v.numpy(), ref.numpy(),
                                       rtol=scale_rtol, err_msg=f)
        v.copy_(ref)
    for f, v in pst.bookkeeping.items():
        assert torch.equal(v, t(np.asarray(jst.bookkeeping[f]))), f


def _code_flips(pst, jst):
    """int8 codes of the port's cache that differ from JAX's."""
    return sum(int((v.int() - t(np.asarray(jst.kv[f])).int()).abs().sum())
               for f, v in pst.kv.items() if f.endswith("__q"))


def _decode_on_layout(name, kind):
    """Two slots admitted with prompts of 13 and 9 tokens, then 8 steps
    fed the JAX step's greedy tokens, on one layout."""
    jcfg, jparams, cfg, params = lm_pair(name)
    spec = dict(kind=kind, page_size=16)
    jdec = JAPI.build_decode(jcfg, JLT.LayoutSpec(**spec))
    pdec = build_decode(cfg, PLT.LayoutSpec(**spec), device="cpu")
    jst, pst = jdec.init_state(2, MAX_LEN), pdec.init_state(2, MAX_LEN)
    oracle = LM.init_kv_cache(cfg, 2, MAX_LEN)
    for slot, p in enumerate(make_prompts(jcfg, (13, 9), seed=4)):
        jlg, jst = jdec.prefill_into_slot(jparams, jst, np.int32(slot),
                                          jnp.asarray(p))
        plg, pst = pdec.prefill_into_slot(params, pst, slot, p)
        np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=1e-4)
        _, row = LM.lm_prefill(params, t(p[None]), cfg, MAX_LEN)
        for f, v in row.items():
            oracle[f].select(LM.CACHE_BATCH_AXES[f], slot).copy_(
                v.select(LM.CACHE_BATCH_AXES[f], 0))
    if "int8" in kind:
        _adopt_jax_codes(pst, jst)
    step = jax.jit(jdec.step)
    token = np.array([3, 4], np.int32)
    for _ in range(8):
        jlg, jst = step(jparams, jst, jnp.asarray(token))
        plg, pst = pdec.raw_step(params, pst, t(token))
        np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=1e-4)
        if "int8" in kind:
            if _code_flips(pst, jst):
                _adopt_jax_codes(pst, jst, scale_rtol=1e-4)
        else:
            olg, oracle = LM.lm_decode_step(params, oracle, t(token), cfg)
            np.testing.assert_allclose(plg.numpy(), olg.numpy(), atol=1e-5)
        token = np.asarray(jlg).argmax(-1).astype(np.int32)
    assert pst.bookkeeping["len"].tolist() == [21, 17]
    tol = 1e-4
    if "int8" in kind:
        # the last step's own writes may have flipped a code (see
        # _adopt_jax_codes): the dequantized caches may then differ by one
        # quantization step there
        for f, v in pst.kv.items():
            ref = t(np.asarray(jst.kv[f]))
            if f.endswith("__q"):
                flips = (v.int() - ref.int()).abs()
                assert flips.max() <= 1 and flips.float().mean() < 1e-3, f
            elif f.endswith("__scale"):
                np.testing.assert_allclose(v.numpy(), ref.numpy(),
                                           rtol=1e-4, err_msg=f)
                tol = max(tol, float(v.max()) + 1e-4)
    else:
        for f in _kv_fields(oracle):
            np.testing.assert_allclose(pst.merged()[f].numpy(),
                                       oracle[f].numpy(), atol=1e-5)
    jm, pm = jst.merged(), pst.merged()
    assert sorted(pm) == sorted(jm)
    for f in _kv_fields(pm) + ["len"]:
        np.testing.assert_allclose(pm[f].numpy(), np.asarray(jm[f]),
                                   atol=tol, err_msg=f)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("name", list(LM_CONFIGS))
def test_lm_vs_jax(name, part):
    if part == "forward":
        _forward(name)
    elif part == "prefill":
        _prefill(name)
    else:
        _decode_on_layout(name, part)


@pytest.mark.parametrize("name", list(LM_CONFIGS))
def test_layer_forward_and_windows_vs_jax(name):
    """One attention layer's full-sequence forward at 1e-5 (the last
    layer: gemma3's global one, an MoE model's last MoE layer, with its
    aux loss), and the per-layer windows."""
    jcfg, jparams, cfg, params = lm_pair(name)
    windows = LM.layer_windows(cfg)
    assert windows == JLM.layer_windows(jcfg).tolist()
    i = len(params["layers"]) - 1
    jl = jax.tree_util.tree_map(lambda a: a[i], jparams["layers"])
    x = np.random.RandomState(3).randn(2, 19, cfg.d_model).astype(np.float32)
    pos = np.arange(19, dtype=np.int32)
    cos, sin = JLM._rope_tables(jcfg, jnp.asarray(pos), None)
    jo, jaux = JLM._layer_fwd(jl, jnp.asarray(x), jnp.asarray(pos),
                              jnp.int32(windows[-1]), jcfg, cfg.is_moe, cos,
                              sin)
    ppos, pcos, psin = LM._positions(2, 19, cfg, torch.device("cpu"))
    po, k, v, aux = LM._attn_layer_fwd(params["layers"][i], t(x), ppos,
                                       windows[-1], cfg, pcos, psin,
                                       cfg.is_moe)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5)
    assert tuple(k.shape) == (2, 19, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.is_moe:
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    else:
        assert aux is None and float(jaux) == 0.0


def test_layer_windows_of_the_configs():
    gemma = PC.get_config("gemma3_4b")
    assert LM.layer_windows(gemma)[:6] == [1024] * 5 + [0]
    assert LM.layer_windows(PC.get_config("smollm_360m")) == [0] * 32
    assert LM.layer_windows(PC.get_config(
        "tconst_41m", attention_mode="sliding", sliding_window=64)) == \
        [64] * 8


@pytest.mark.parametrize("kind", ["dense", "int8", "paged", "paged_int8"])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attend_view_vs_jax(kind, window):
    """One layer's decode attention over each view kind, ragged lengths,
    with and without a sliding window, at 1e-5 of JAX's."""
    jcfg, jparams, cfg, params = lm_pair("smollm")
    rng = np.random.RandomState(6)
    B, S = 3, 32
    KV, D = cfg.n_kv_heads, cfg.resolved_head_dim
    kc = rng.randn(1, B, S, KV, D).astype(np.float32)
    vc = rng.randn(1, B, S, KV, D).astype(np.float32)
    length = np.array([0, 7, 20], np.int32)
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    axes = {"k": 1, "v": 1, "len": 0, "done": 0}
    bk = {"len": length, "done": np.zeros(B, bool)}
    kw = dict(slots=B, max_len=S, length_axes={"k": 2, "v": 2},
              quant_fields=("k", "v"), dtype="float32")
    spec = dict(kind=kind, page_size=8)
    jlay = JLT.bind_layout(JLT.LayoutSpec(**spec), **kw)
    play = PLT.bind_layout(PLT.LayoutSpec(**spec), **kw)
    if kind.startswith("paged"):           # one shuffled page table
        pps = play.pages_per_slot
        bk[PLT.PAGE_TABLE] = rng.permutation(B * pps).reshape(
            B, pps).astype(np.int32)
    jbk = {k: jnp.asarray(v) for k, v in bk.items()}
    pbk = {k: t(v) for k, v in bk.items()}
    jaxes = paxes = {**axes, **play.bookkeeping_axes()}
    dense = {"k": kc, "v": vc}
    jv = jlay.view(jlay.pack({k: jnp.asarray(v) for k, v in dense.items()},
                             jbk, jaxes), jbk, jaxes)
    pv = play.view(play.pack({k: t(v) for k, v in dense.items()}, pbk,
                             paxes), pbk, paxes)
    pos = length[:, None]
    cos, sin = JLM._rope_tables(jcfg, jnp.asarray(pos), None)
    jattn = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["attn"])
    jo, _, _ = JA.decode_attend_view(
        jattn, jnp.asarray(x), jv["k"].layer(0), jv["v"].layer(0),
        jnp.asarray(length), cos, sin, 0.0, window)
    pcos, psin = LM._rope(t(pos), cfg)
    po, _ = A.decode_attend_view(
        params["layers"][0]["attn"], t(x), pv["k"].layer(0),
        pv["v"].layer(0), t(length).long(), torch.ones(B, dtype=torch.bool),
        None, t(length) + 1, pcos, psin, 0.0, window)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5)


def test_attend_views_without_a_window_is_the_tconst_call():
    """``window=0`` (every TConst caller) gives exactly the kernel calls
    the TConst path made before windows existed; a window on a dense view
    is K1 over ``[max(lo, hi - window), hi)``."""
    g = torch.Generator().manual_seed(0)
    B, S, H, KV, D = 3, 24, 4, 2, 8
    q = torch.randn((B, H, D), generator=g)
    k = torch.randn((1, B, S, KV, D), generator=g)
    v = torch.randn((1, B, S, KV, D), generator=g)
    lo = torch.tensor([0, 3, 10], dtype=torch.int32)
    hi = torch.tensor([0, 9, 24], dtype=torch.int32)
    dv = PLT.DenseView(k[0]), PLT.DenseView(v[0])
    assert torch.equal(A._attend_views(q, *dv, lo, hi, 0.5),
                       ops.decode_attention(q, k[0], v[0], lo, hi, 0.5))
    assert torch.equal(A._attend_views(q, *dv, None, hi, 0.0, 4),
                       ops.decode_attention(q, k[0], v[0],
                                            (hi - 4).clamp(min=0), hi))
    assert torch.equal(A._attend_views(q, *dv, lo, hi, 0.0, 4),
                       ops.decode_attention(q, k[0], v[0],
                                            torch.maximum(lo, hi - 4), hi))
    lay = PLT.bind_layout(PLT.LayoutSpec(kind="paged_int8", page_size=8),
                          slots=B, max_len=S, length_axes={"k": 2, "v": 2},
                          quant_fields=("k", "v"), dtype="float32")
    bk = lay.init_bookkeeping(B)
    axes = {"k": 1, "v": 1, **lay.bookkeeping_axes()}
    views = lay.view(lay.pack({"k": k, "v": v}, bk, axes), bk, axes)
    kp, vp = views["k"].layer(0), views["v"].layer(0)
    for window in (0, 5):
        got = A._attend_views(q, kp, vp, None, hi, 0.5, window)
        ref = ops.paged_decode(q, kp.storage.q, vp.storage.q, kp.page_table,
                               hi, softcap=0.5, window=window,
                               k_scale=kp.storage.scale,
                               v_scale=vp.storage.scale)
        assert torch.equal(got, ref), window
    with pytest.raises(ValueError, match="prefix"):
        A._attend_views(q, kp, vp, lo, hi)


def test_base_transformer_init_is_the_tconst_weights():
    """``tconst-41m`` in ``full`` mode draws the TConst model's weights:
    its 8 layers are the 2 blocks x 4 layers of ``init_tconst_lm`` with
    the same seed, in order (so the paper's three variants are served on
    one set of weights), and every leaf has JAX's per-layer shape."""
    cfg = PC.reduced(PC.get_config("tconst_41m"))
    full = LM.init_lm(cfg.replace(attention_mode="full",
                                  n_layers=2 * cfg.tconst.block_depth), 3)
    tc = PT.init_tconst_lm(cfg, 3)
    layers = [ly for blk in tc["blocks"] for ly in blk["layers"]]
    assert len(layers) == len(full["layers"])
    for a, b in zip(layers, full["layers"]):
        assert sorted(a) == sorted(b)
        for part in a:
            for n, x in a[part].items():
                assert torch.equal(x, b[part][n]), (part, n)
    assert torch.equal(full["embed"]["tok"], tc["embed"]["tok"])
    jcfg, jparams, pcfg, _ = lm_pair("full")
    mine = LM.init_lm(pcfg, 0)
    for part, leaves in mine["layers"][0].items():
        for n, x in leaves.items():
            assert tuple(x.shape) == \
                jparams["layers"][part][n].shape[1:], (part, n)


def _leaves(tree, path=""):
    """(path, tensor) of every leaf, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


# sha256 (first 16 hex digits) of the seed-0 init of each reduced family
# that was served before the MoE family, taken on the tree before its
# init learned to draw on a device: the smoke's tolerances were measured
# on these weights, so they must not move
INIT_DIGESTS = {"tconst": "17f5cb23ea9b43d0", "full": "4979330d56ff0d7f",
                "smollm": "e7823c3e14b467aa", "mamba2": "ead1d68be91f19a0",
                "llama3": "599f7d78884e553e", "gemma3": "1bb8893bc638d106"}


@pytest.mark.parametrize("name", list(INIT_DIGESTS))
def test_served_families_init_is_unchanged(name):
    import hashlib
    arch, over = {"tconst": ("tconst_41m", {}),
                  "mamba2": ("mamba2_130m", {}),
                  **LM_CONFIGS}[name]
    cfg = PC.reduced(PC.get_config(arch), **over)
    params = PT.init_tconst_lm(cfg, 0) if name == "tconst" else \
        LM.init_lm(cfg, 0)
    h = hashlib.sha256()
    for path, x in _leaves(params):
        h.update(path.encode())
        h.update(str(x.dtype).encode())
        h.update(x.contiguous().numpy().tobytes())
    assert h.hexdigest()[:16] == INIT_DIGESTS[name]


@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_moe_bridge_and_init_keep_jax_layout(name):
    """The bridge carries ``dense_layers`` and the stacked MoE leaves
    across; the port's MoE init has JAX's per-layer shapes, draws on the
    generator's device and casts each tensor to the activation dtype as
    drawn (bf16: the f32 draws of the same seed, rounded; norm scales
    stay f32)."""
    jcfg, jparams, cfg, params = lm_pair(name)
    n_dense = LM.n_dense_layers(cfg)
    assert len(params.get("dense_layers", [])) == n_dense == \
        len(jparams.get("dense_layers", []))
    assert len(params["layers"]) == cfg.n_layers - n_dense
    ffn = params["layers"][0]["ffn"]
    assert sorted(ffn) == sorted(jparams["layers"]["ffn"])
    assert ("shared" in ffn) == (cfg.n_shared_experts > 0)
    np.testing.assert_array_equal(
        ffn["w_down"].numpy(),
        np.asarray(jparams["layers"]["ffn"]["w_down"][0]))
    f32 = LM.init_lm(cfg, 5)
    bf16 = LM.init_lm(cfg.replace(dtype="bfloat16"), 5)
    ref = dict(_leaves(params))
    got = dict(_leaves(f32))
    assert sorted(got) == sorted(ref)
    for path, x in _leaves(bf16):
        assert tuple(x.shape) == tuple(ref[path].shape), path
        if path.endswith("scale"):
            assert x.dtype == torch.float32 and torch.equal(x, got[path])
        else:
            assert x.dtype == torch.bfloat16, path
            assert torch.equal(x, got[path].to(torch.bfloat16)), path
    assert torch.equal(LM.init_lm(cfg, 5)["layers"][0]["ffn"]["w_up"],
                       f32["layers"][0]["ffn"]["w_up"])
