"""MoE FFNs inside the port's TConst core against the JAX package.

Reduced deepseek (4 experts, top-2, a shared expert, G 1) and reduced
mixtral (4 experts, top-2, G 4) in ``tconst`` and ``tlin`` modes, f32, on
JAX's weights carried over by ``repro_torch.bridge``, atol 1e-4:

* ``tconst_forward``'s logits and aux loss (JAX's sum over chunks, blocks
  and layers, the last block's RESTORE included);
* ``prefill`` and ``resync`` (and through the cases below, the
  compacted resync, the decode chunks and the scheduler streams);
* a decode chunk (the port's ``decode_chunk`` against JAX's) on the
  dense, int8, paged and paged_int8 layouts (mixtral in tlin mode);
* greedy ``SlotScheduler`` streams against the JAX scheduler's (deepseek
  in tconst mode on 4 slots: padded resync batches).

JAX's compiles dominate the file's time, so each (config, mode) pair and
each function runs once where one case shows what is at stake.

The routing set of the compacted resync: MoE routing groups span rows and
capacity drops count positions across a group, so ``TConstDecode.
sync_rows`` reproduces JAX's gather (pending rows first, padded up to a
bucket of ``resync_buckets``).  At B 4 with 3 rows pending it equals
JAX's ``resync_rows_compacted`` and differs from a resync of the 3 rows
alone; for a dense config the exact-rows resync equals the padded one bit
for bit.  Also: ``serve.load`` with ``--reduced`` and a mode override
builds JAX's reduced config, the MoE init keeps JAX's tree, and
``ModelAPI.loss`` still refuses MoE training.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity import make_prompts, serve_streams
from repro import config as JC
from repro.core import tconst as JT
from repro.models import api as JAPI
from repro.models import layouts as JLT
from repro_torch import bridge
from repro_torch import config as PC
from repro_torch.core import tconst as PT
from repro_torch.launch import serve
from repro_torch.layers.common import take_rows
from repro_torch.models import layouts as PLT
from repro_torch.models.api import build_decode, build_model, decode_chunk
from torch_parity import jax_to_numpy, port_cfg, port_streams, t

torch.set_num_threads(1)
ATOL = 1e-4
CASES = {"deepseek-tconst": ("deepseek_moe_16b", "tconst"),
         "deepseek-tlin": ("deepseek_moe_16b", "tlin"),
         "mixtral-tconst": ("mixtral_8x22b", "tconst"),
         "mixtral-tlin": ("mixtral_8x22b", "tlin")}
CTX = ("ctx_k", "ctx_v", "ctx_valid", "hist_len", "gen_len")


@functools.lru_cache(maxsize=None)
def moe_pair(name):
    """(JAX cfg, JAX params, the port's cfg, its params bridged from
    them), reduced, f32.  Built once per process."""
    arch, mode = CASES[name]
    jcfg = JC.reduced(JC.get_config(arch), dtype="float32",
                      attention_mode=mode)
    jparams = JT.init_tconst_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, port_cfg(jcfg), \
        bridge.params_from_jax(jax_to_numpy(jparams))


def _tokens(cfg, shape, seed=1):
    return np.random.RandomState(seed).randint(
        1, cfg.vocab_size, size=shape).astype(np.int32)


def _assert_cache(cache, jcache, fields, atol=ATOL):
    for f in fields:
        if f not in cache:
            continue
        want = np.asarray(jcache[f])
        if cache[f].dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(cache[f].numpy(), want, err_msg=f)
        else:
            np.testing.assert_allclose(cache[f].numpy(), want, atol=atol,
                                       err_msg=f)


# ---------------------------------------------------------------------------
# the core: forward, prefill, steps, resync
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_forward_logits_and_aux_match_jax(name):
    """Four chunks of W_og 8.  The aux loss is the sum of 4 chunks x 2
    blocks x 8 MoE FFNs; the last block's RESTORE adds ~1/64 of it, far
    above the tolerance, so the port must run that restore."""
    jcfg, jparams, cfg, params = moe_pair(name)
    toks = _tokens(cfg, (2, 32))
    jl, jaux = JT.tconst_forward(jparams, jnp.asarray(toks), jcfg,
                                 mode=cfg.attention_mode)
    pl, aux = PT.tconst_forward(params, t(toks), cfg,
                                mode=cfg.attention_mode)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)
    assert aux.dtype == torch.float32 and aux.item() > 0.0
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)


# deepseek in tconst mode and mixtral in tlin mode are admitted and
# resynced against JAX below (the compacted resync, the decode chunks, the
# scheduler streams); here the other two pairs
@pytest.mark.parametrize("name", ["deepseek-tlin", "mixtral-tconst"])
def test_prefill_and_resync_match_jax(name):
    """A 21-token prefill (2 windows of history in a 48-slot buffer: the
    restore FFN routes all 48 positions), then a resync that folds its
    5-token window into the history."""
    jcfg, jparams, cfg, params = moe_pair(name)
    mode = cfg.attention_mode
    toks = _tokens(cfg, (2, 21), seed=2)
    lg, cache = PT.prefill(params, t(toks), cfg, 48, mode=mode)
    jlg, jcache = JT.prefill(jparams, jnp.asarray(toks), jcfg, 48,
                             mode=mode)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL)
    _assert_cache(cache, jcache, PT.KV_KEYS + CTX + ("tokens",))
    cache = PT.resync(params, cache, cfg, mode)
    jcache = JT.resync(jparams, jcache, jcfg, mode)
    assert cache["hist_len"].tolist() == [21, 21]
    _assert_cache(cache, jcache, PT.KV_KEYS + CTX + ("tokens",))


# ---------------------------------------------------------------------------
# the routing set of the compacted resync
# ---------------------------------------------------------------------------


def _resync_state(cfg, params, lens, gen_len, done):
    """A 4-slot dense-layout TConst state admitted with prompts of
    ``lens`` (one window of 8 in front of a full window), then its
    counters set: ``gen_len`` and ``done`` per row.  Returns (state, JAX
    cache dict of the same values)."""
    dec = build_decode(cfg, device="cpu")
    st = dec.init_state(4, 40)
    for slot, p in enumerate(make_prompts(cfg, lens, seed=6)):
        _, st = dec.prefill_into_slot(params, st, slot, p)
    st.bookkeeping["gen_len"].copy_(torch.tensor(gen_len, dtype=torch.int32))
    st.bookkeeping["done"].copy_(torch.tensor(done))
    st.host["gen_len"][:] = gen_len
    jcache = {f: jnp.asarray(v.numpy()) for f, v in st.merged().items()}
    return dec, st, jcache


# rows 0, 1 and 3 pending (window full, not done), row 2 not: JAX gathers
# [0, 1, 3] padded with row 2 up to the bucket of 4.  "partial": row 2's
# window is half full (no host candidate); "done": row 2's window is full
# but the row is EOS-finished (a host candidate that is not pending)
RESYNC_ROWS = {"partial": ([8, 8, 4, 8], [False] * 4),
               "done": ([8] * 4, [False, False, True, False])}


@pytest.mark.parametrize("name,case", [("deepseek-tconst", "partial"),
                                       ("mixtral-tlin", "done")])
def test_compacted_moe_resync_routes_jax_rows(name, case):
    jcfg, jparams, cfg, params = moe_pair(name)
    gen_len, done = RESYNC_ROWS[case]
    dec, st, jcache = _resync_state(cfg, params, (16, 15, 13, 16), gen_len,
                                    done)
    pending = np.array(JT.pending_resync_rows(jcache, jcfg))
    assert pending.tolist() == [True, True, False, True]
    jout = JT.resync_rows_compacted(jparams, jcache, jcfg,
                                    jnp.asarray(pending), cfg.attention_mode)
    # the exact-rows resync a dense config runs, for contrast
    idx = torch.tensor([0, 1, 3])
    exact = PT.resync(params, {f: take_rows(st.bookkeeping[f], idx,
                                            st.axes[f])
                               for f in PT.RESYNC_INPUT_KEYS}, cfg,
                      cfg.attention_mode)
    rows = dec.sync_candidates(st)
    assert rows.tolist() == [True, True, case == "done", True]
    dec.sync_rows(params, st, rows)
    got = st.merged()
    _assert_cache(got, jout, PT.KV_KEYS + CTX)
    assert st.host["gen_len"].tolist() == [0, 0, 0 if case == "done" else
                                           4, 0]
    # routing three rows alone moves the ctx KV far past the tolerance:
    # capacity drops depend on which tokens share a group
    gap = (exact["ctx_k"] - got["ctx_k"][:, :, idx]).abs().max().item()
    assert gap > 0.1, gap


def test_dense_exact_rows_resync_equals_padded_batch():
    """Dense FFNs: a row's resync does not depend on the other rows, so
    the exact-rows batch [0, 1, 3] gives, bit for bit, what JAX's padded
    batch [0, 1, 3, 2] gives those rows."""
    cfg = PC.reduced(PC.get_config("tconst_41m"), dtype="float32")
    params = build_model(cfg, device="cpu").init(3)
    dec, st, _ = _resync_state(cfg, params, (16, 15, 13, 16), [8, 8, 4, 8],
                               [False] * 4)

    def resync_of(order):
        idx = torch.tensor(order)
        return PT.resync(params, {f: take_rows(st.bookkeeping[f], idx,
                                               st.axes[f])
                                  for f in PT.RESYNC_INPUT_KEYS}, cfg)

    padded = resync_of([0, 1, 3, 2])
    dec.sync_rows(params, st, dec.sync_candidates(st))
    got = st.merged()
    for f in ("ctx_k", "ctx_v", "ctx_valid", "hist_len"):
        ax = PT.CACHE_BATCH_AXES[f]
        assert torch.equal(got[f].index_select(ax, torch.tensor([0, 1, 3])),
                           padded[f].narrow(ax, 0, 3)), f


# ---------------------------------------------------------------------------
# serving: a decode chunk on every layout, scheduler streams
# ---------------------------------------------------------------------------


def _int8_close(pst, jst, tol=ATOL):
    """An f32 K/V at a .5 boundary of x / scale may be stored one code
    apart from JAX's (the two GEMMs sum in other orders): codes may differ
    by one, rarely, and the scales agree; the dequantized caches may then
    differ by one quantization step.  Returns the tolerance for them."""
    for f, v in pst.kv.items():
        ref = t(np.asarray(jst.kv[f]))
        if f.endswith("__q"):
            flips = (v.int() - ref.int()).abs()
            assert flips.max() <= 1 and flips.float().mean() < 1e-3, f
        elif f.endswith("__scale"):
            np.testing.assert_allclose(v.numpy(), ref.numpy(), rtol=1e-5,
                                       err_msg=f)
            tol = max(tol, float(v.max()) + 1e-4)
    return tol


CHUNK_CASE = "mixtral-tlin"     # G 4; tlin: the paged history KV


@functools.lru_cache(maxsize=None)
def _admitted(name):
    """Two slots admitted with prompts of 13 and 9 tokens on the dense
    layout, by JAX and by the port (their logits agree): each side's
    merged cache, the start of every layout's decode chunk."""
    jcfg, jparams, cfg, params = moe_pair(name)
    jdec = JAPI.build_decode(jcfg)
    pdec = build_decode(cfg, device="cpu")
    jst, pst = jdec.init_state(2, 48), pdec.init_state(2, 48)
    for slot, p in enumerate(make_prompts(jcfg, (13, 9), seed=4)):
        jlg, jst = jdec.prefill_into_slot(jparams, jst, np.int32(slot),
                                          jnp.asarray(p))
        plg, pst = pdec.prefill_into_slot(params, pst, slot, p)
        np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=ATOL)
    return jst.merged(), pst.merged(), pst.host["gen_len"].copy()


@pytest.mark.parametrize("kind", ["dense", "int8", "paged", "paged_int8"])
def test_decode_chunk_matches_jax_on_layouts(kind):
    """The admitted slots of ``_admitted`` packed into one layout, then
    one greedy decode chunk of 12 steps: the rows resync at their own
    steps inside the chunk (row 0 twice).  Tokens equal JAX's
    ``decode_chunk``; the merged caches agree at 1e-4 (int8: see
    ``_int8_close``)."""
    jcfg, jparams, cfg, params = moe_pair(CHUNK_CASE)
    jm0, pm0, gen_len = _admitted(CHUNK_CASE)
    spec = dict(kind=kind, page_size=16)
    jdec = JAPI.build_decode(jcfg, JLT.LayoutSpec(**spec))
    pdec = build_decode(cfg, PLT.LayoutSpec(**spec), device="cpu")
    jst = jdec._wrap_new(dict(jm0), 48)
    pst = pdec._wrap({f: v.clone() for f, v in pm0.items()}, gen_len,
                     pdec.bind(2, 48))
    token = np.array([3, 4], np.int32)
    active = np.ones((2,), bool)
    jtoks, jst, _ = jax.jit(functools.partial(
        JAPI.decode_chunk, jdec, n_steps=12))(
            jparams, jst, jnp.asarray(token), jax.random.PRNGKey(0),
            jnp.zeros((2,)), jnp.asarray(active))
    ptoks, pst, resyncs = decode_chunk(pdec, params, pst, t(token),
                                       [None, None], np.zeros(2), active, 12)
    assert resyncs.tolist() == [2, 1]
    np.testing.assert_array_equal(ptoks.numpy(), np.asarray(jtoks))
    tol = _int8_close(pst, jst) if "int8" in kind else ATOL
    jm, pm = jst.merged(), pst.merged()
    assert sorted(pm) == sorted(jm)
    _assert_cache(pm, jm, PT.KV_KEYS + CTX + ("tokens",), atol=tol)


def test_scheduler_streams_equal_jax_scheduler():
    """Greedy streams of 4 staggered sessions on 4 slots equal the JAX
    scheduler's.  Admitted one chunk of 4 apart with windows of 5, 1, 5
    and 6 tokens, slots 0-2 fill their windows at the same steps: a resync
    of 3 rows padded with slot 3."""
    jcfg, jparams, cfg, params = moe_pair("deepseek-tconst")
    prompts = make_prompts(jcfg, (21, 9, 21, 14))
    ref, _ = serve_streams(jcfg, jparams, prompts, gen=14, slots=4,
                           max_len=64)
    got, sched = port_streams(cfg, params, prompts, gen=14, slots=4,
                              max_len=64)
    assert got == ref
    assert all(n >= 1 for n in sched.resyncs.values())


# ---------------------------------------------------------------------------
# init, launcher, facade
# ---------------------------------------------------------------------------


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_moe_init_keeps_jax_tree_and_casts_as_drawn():
    """The bridge carries JAX's MoE TConst tree (the MoE leaves stacked on
    the blocks axis) both ways, bit for bit.  The port's MoE TConst init
    has its paths and shapes (every layer MoE, no dense first layer);
    bf16 is the f32 draw of the same seed rounded, norm scales f32."""
    _, jparams, cfg, params = moe_pair("deepseek-tconst")
    back = dict(_leaves(bridge.params_to_jax(params)))
    want = dict(_leaves(jax_to_numpy(jparams)))
    assert sorted(back) == sorted(want)
    for path, x in want.items():
        np.testing.assert_array_equal(back[path], x, err_msg=path)
    ref = dict(_leaves(params))
    f32 = dict(_leaves(PT.init_tconst_lm(cfg, 5)))
    bf16 = dict(_leaves(PT.init_tconst_lm(cfg.replace(dtype="bfloat16"), 5)))
    assert sorted(f32) == sorted(bf16) == sorted(ref)
    assert all(f"/blocks/{b}/layers/{i}/ffn/router" in f32
               for b in range(2) for i in range(4))
    for path, x in bf16.items():
        assert tuple(x.shape) == tuple(ref[path].shape), path
        if path.endswith("scale"):
            assert x.dtype == torch.float32 and torch.equal(x, f32[path])
        else:
            assert x.dtype == torch.bfloat16, path
            assert torch.equal(x, f32[path].to(torch.bfloat16)), path


def test_serve_load_reduces_in_the_override_mode():
    """deepseek's own mode is full: ``--reduced`` with
    ``attention_mode="tconst"`` is 2 blocks at W 8, as JAX's
    ``reduced(cfg, attention_mode=...)`` gives, and the model serves."""
    args = serve.parse_args(["--arch", "deepseek_moe_16b", "--reduced",
                             "--dtype", "float32", "--device", "cpu"])
    cfg, api, params = serve.load(args, attention_mode="tconst")
    assert cfg == PC.reduced(PC.get_config("deepseek_moe_16b"),
                             attention_mode="tconst", dtype="float32")
    assert port_cfg(JC.reduced(JC.get_config("deepseek_moe_16b"),
                               attention_mode="tconst",
                               dtype="float32")) == cfg
    assert cfg.n_layers == 8 and cfg.tconst.w_og == 8
    assert len(params["blocks"]) == 2
    assert all("router" in layer["ffn"] for b in params["blocks"]
               for layer in b["layers"])


def test_moe_training_still_refused():
    _, _, cfg, params = moe_pair("deepseek-tconst")
    api = build_model(cfg, device="cpu")
    batch = {"tokens": t(_tokens(cfg, (1, 16)))}
    logits, aux = api.forward(params, batch)
    assert logits.shape == (1, 16, cfg.vocab_size) and aux.item() > 0.0
    with pytest.raises(NotImplementedError, match="item 10b"):
        api.loss(params, batch)
