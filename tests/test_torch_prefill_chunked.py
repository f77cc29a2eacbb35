"""Chunked, KV-conditioned admission in the port, against the JAX package
(``tests/test_prefill_chunked.py`` is the suite mirrored).

Reduced f32 configs on JAX-bridged weights, pages of 16 tokens, chunks of
16, atol 1e-4 unless stated:

* ``write_span`` on the four layouts bit-equal to JAX's (``min_page``
  sending adopted pages to TRASH; int8 codes and their scales).
* ``lm_prefill_chunk`` chunk by chunk (logits, the row cache, the chunk's
  K/V) for a dense GQA LM (smollm), reduced deepseek (a dense layer's
  ``dense_k``, MoE routing over a padded last chunk), reduced gemma3
  (per-layer windows) and reduced mamba2 (the carried state, the padding
  kept out by ``valid_len``).
* The TConst ``prefill_bucketed`` for tconst and tlin with prompts below,
  at and above ``W_og``, and for reduced deepseek in tconst mode.
* ``prefill_into_slot_chunked`` end to end (logits, the slot's state) on
  dense and paged, with adopted pages and with a fully resident prompt.
* ``chunked_prefill_fits`` equal to JAX's on a grid of lengths.
* Within the port: chunked streams equal one-shot streams on the four
  layouts; a sharing admission forwards its tail only; one tagged
  chunked signature across prompt lengths; the page-grid ``ValueError``,
  the one-shot rule for a grid past ``max_len``, ``build_decode``'s
  default; the serve CLI's ``--prefill-chunk``.
* On the card (``cuda`` marker; skips without a GPU): K2 at the chunk
  shape against its plain version, ``write_span`` on a paged_int8 pool
  against the CPU's.

JAX's compiles dominate the time: each JAX function is jitted once per
family and every chunk reuses it.
"""
import functools

import numpy as np
import pytest
import torch

try:    # the GPU machine has no JAX: only the cuda tests run there
    import jax
    import jax.numpy as jnp
    from parity import family
    from repro import config as JC
    from repro.core import tconst as JT
    from repro.models import api as JAPI
    from repro.models import layouts as JLT
    from repro.models import lm as JLM
    from torch_parity import jax_to_numpy, lm_pair, port_cfg, ssm_pair
except ImportError:
    jax = None
from repro_torch import bridge
from repro_torch import config as PC
from repro_torch import runtime
from repro_torch.core import tconst as PT
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layouts as PLT
from repro_torch.models import lm as PLM
from repro_torch.models.api import build_decode
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session

torch.set_num_threads(1)
ATOL = 1e-4
PAGE = 16
CHUNK = 16
LAYOUTS = ("dense", "int8", "paged", "paged_int8")


def _need_jax():
    if jax is None:
        pytest.skip("the JAX references need JAX (absent on the GPU machine)")


def _t(a):
    return torch.from_numpy(np.array(a))


def _prompt(vocab, n, seed):
    return np.random.RandomState(seed).randint(1, vocab, size=n).astype(
        np.int32)


def _spec(kind, pool_pages=None):
    return PLT.LayoutSpec(kind=kind, page_size=PAGE, pool_pages=pool_pages)


def _jspec(kind, pool_pages=None):
    return JLT.LayoutSpec(kind=kind, page_size=PAGE, pool_pages=pool_pages)


def _close(got, want, what, atol=ATOL):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32) if want.dtype != bool else \
        np.asarray(want)
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=what)
    else:
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0,
                                   atol=atol, err_msg=what)


def _kv_equal(pkv, jkv, what, layout=None, exact=True):
    """Field by field; on a paged layout the TRASH page (unordered dead
    writes) is left out."""
    assert sorted(pkv) == sorted(jkv), what
    for f in jkv:
        g, w = pkv[f].numpy(), np.asarray(jkv[f])
        ax = layout.page_axis(f) if isinstance(
            layout, PLT.PagedLayout) else None
        if ax is not None:
            g = np.delete(g, layout.trash, axis=ax)
            w = np.delete(w, layout.trash, axis=ax)
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")
        else:
            _close(g, w, f"{what}: {f}")


@pytest.fixture(scope="module")
def lm():
    """reduced smollm (GQA), f32: (JAX cfg, JAX params, port cfg, port
    params)."""
    _need_jax()
    return lm_pair("smollm")


# ---------------------------------------------------------------------------
# the layout method against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", LAYOUTS)
def test_write_span_bit_equal_to_jax(lm, kind):
    """Two chunks into slot 1 of a 2 x 64 state: at 0 (paged: with
    ``min_page`` 1, its first page to TRASH) and at 32.  The physical
    buffers equal JAX's bit for bit (int8: codes and scales); slot 0's
    rows / pages keep their bytes."""
    jcfg, _, cfg, _ = lm
    jst = JAPI.build_decode(jcfg, _jspec(kind)).init_state(2, 64)
    pst = build_decode(cfg, _spec(kind), device="cpu").init_state(2, 64)
    paged = isinstance(pst.layout, PLT.PagedLayout)
    if paged:
        pt = np.random.RandomState(4).permutation(8).reshape(2, 4).astype(
            np.int32)
        jst = jst.with_bookkeeping(**{JLT.PAGE_TABLE: jnp.asarray(pt)})
        pst.bookkeeping[PLT.PAGE_TABLE].copy_(_t(pt))
    rng = np.random.RandomState(0)
    before = {f: v.clone() for f, v in pst.kv.items()}
    for start, min_page in ((0, 1 if paged else None), (32, None)):
        chunk = {f: rng.randn(*((cfg.n_layers, 1, 2 * PAGE) + tuple(
            pst.merged()[f].shape[3:]))).astype(np.float32)
            for f in ("k", "v")}
        jst = jst.write_span(jnp.int32(1), {f: jnp.asarray(v) for f, v in
                                            chunk.items()},
                             PLM.LENGTH_AXES, jnp.int32(start),
                             min_page=None if min_page is None else
                             jnp.int32(min_page))
        out = pst.write_span(1, {f: _t(v) for f, v in chunk.items()},
                             PLM.LENGTH_AXES, start, min_page=min_page)
        assert out is pst
    _kv_equal(pst.kv, jst.kv, f"write_span {kind}", pst.layout)
    if paged:
        # the pages below min_page and slot 0's pages are untouched
        kept = pst.layout.gather_pages(pst.kv, _t(np.r_[pt[0], pt[1, 0]]))
        old = pst.layout.gather_pages(before, _t(np.r_[pt[0], pt[1, 0]]))
        for f in old:
            assert torch.equal(kept[f], old[f]), f
    else:
        for f, v in pst.kv.items():
            assert torch.equal(v[:, 0], before[f][:, 0]), f


# ---------------------------------------------------------------------------
# lm_prefill_chunk against JAX's, chunk by chunk
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _deepseek_pair():
    """``lm_pair("deepseek")`` with JAX's init jitted: one compile where
    the eager init takes ~10 s of JAX dispatch (the weights differ from
    the eager init's in the last bits; both sides take these)."""
    jcfg = JC.reduced(JC.get_config("deepseek_moe_16b"), dtype="float32")
    jparams = jax.jit(JLM.init_lm, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    return jcfg, jparams, port_cfg(jcfg), \
        bridge.lm_params_from_jax(jax_to_numpy(jparams))


def _lm_family(name):
    if name == "mamba2":
        return ssm_pair()
    if name == "deepseek":
        return _deepseek_pair()
    return lm_pair(name)


@functools.lru_cache(maxsize=None)
def _jax_chunk_fn(name):
    jcfg = _lm_family(name)[0]
    return jax.jit(functools.partial(JLM.lm_prefill_chunk, cfg=jcfg))


@pytest.mark.parametrize("name", ["smollm", "deepseek", "gemma3", "mamba2"])
def test_lm_prefill_chunk_equals_jax(name):
    """A 37-token prompt in three chunks of 16 (the last with 5 real
    tokens) from an empty row cache: each chunk's logits (every position,
    padding too), the row cache after it and its K/V equal JAX's.
    deepseek routes every padded chunk through its MoE layer; gemma3's
    local layers run their window on K2's chunk shape; mamba2 carries
    its ssm / conv state across chunks, the padding kept out of it."""
    _need_jax()
    jcfg, jparams, cfg, params = _lm_family(name)
    L, max_len = 37, 64
    prompt = _prompt(cfg.vocab_size, L, seed=11)
    buf = np.zeros((3 * CHUNK,), np.int32)
    buf[:L] = prompt
    jrow = JLM.init_kv_cache(jcfg, 1, max_len)
    row = PLM.init_kv_cache(cfg, 1, max_len, device="cpu")
    jfn = _jax_chunk_fn(name)
    for j in range(3):
        start = j * CHUNK
        toks = buf[start:start + CHUNK][None]
        jlogits, jrow, jkv = jfn(jparams, jrow, jnp.asarray(toks),
                                 jnp.int32(start), jnp.int32(L))
        logits, row, kv = PLM.lm_prefill_chunk(params, row, _t(toks), start,
                                               L, cfg)
        what = f"{name} chunk {j}"
        _close(logits, jlogits, f"{what} logits")
        assert sorted(kv) == sorted(jkv), what
        for f in jkv:
            _close(kv[f], jkv[f], f"{what} chunk_kv {f}")
        for f in jrow:
            _close(row[f], jrow[f], f"{what} row {f}")
    # the admission reads one position: (L - 1) - start of the last chunk
    one, _, _ = PLM.lm_prefill_chunk(params, PLM.init_kv_cache(
        cfg, 1, max_len, device="cpu"), _t(buf[:CHUNK][None]), 0, L, cfg,
        logits_at=CHUNK - 1)
    first, _, _ = jfn(jparams, JLM.init_kv_cache(jcfg, 1, max_len),
                      jnp.asarray(buf[:CHUNK][None]), jnp.int32(0),
                      jnp.int32(L))
    _close(one, np.asarray(first)[:, CHUNK - 1], f"{name} logits_at")


# ---------------------------------------------------------------------------
# the TConst bucketed prefill against JAX's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tconst_pair(name):
    """(JAX cfg, JAX params, port cfg, port params) of reduced tconst /
    tlin (W_og 8) or reduced deepseek in tconst mode, f32."""
    if name == "deepseek-tconst":
        jcfg = JC.reduced(JC.get_config("deepseek_moe_16b"),
                          dtype="float32", attention_mode="tconst")
        jparams = JT.init_tconst_lm(jax.random.PRNGKey(0), jcfg)
    else:
        jcfg, _, jparams = family(name)
    return jcfg, jparams, port_cfg(jcfg), \
        bridge.params_from_jax(jax_to_numpy(jparams))


@pytest.mark.parametrize("name", ["tconst", "tlin", "deepseek-tconst"])
def test_prefill_bucketed_equals_jax(name):
    """Three rows of one (3, 48) buffer with prompts of 5, 8 and 13
    tokens (W_og 8: a window part below, at and above the window width):
    the logits and every cache field equal JAX's, the padded window slots
    included; ``gen_len`` is g0 per row."""
    _need_jax()
    jcfg, jparams, cfg, params = _tconst_pair(name)
    mode = cfg.attention_mode
    n_valid = np.array([5, 8, 13], np.int32)
    buf = np.zeros((3, 48), np.int32)
    for b, n in enumerate(n_valid):
        buf[b, :n] = _prompt(cfg.vocab_size, n, seed=20 + b)
    jlogits, jcache = jax.jit(functools.partial(
        JT.prefill_bucketed, cfg=jcfg, mode=mode))(
            jparams, jnp.asarray(buf), jnp.asarray(n_valid))
    logits, cache = PT.prefill_bucketed(params, _t(buf), _t(n_valid), cfg,
                                        mode=mode)
    _close(logits, jlogits, f"{name} logits")
    assert sorted(cache) == sorted(jcache)
    for f in jcache:
        _close(cache[f], jcache[f], f"{name} {f}")
    np.testing.assert_array_equal(cache["gen_len"].numpy(), [5, 8, 5])


# ---------------------------------------------------------------------------
# the chunked admission end to end against JAX's
# ---------------------------------------------------------------------------


def _admit_both(jdec, jparams, jst, pdec, params, pst, slot, prompt,
                resident, mask=None):
    jlogits, jst, jinfo = jdec.prefill_into_slot_chunked(
        jparams, jst, np.int32(slot), prompt, page_write_mask=None
        if mask is None else jnp.asarray(mask), resident_len=resident,
        chunk=CHUNK)
    logits, pst, info = pdec.prefill_into_slot_chunked(
        params, pst, slot, prompt, page_write_mask=None if mask is None
        else _t(mask), resident_len=resident, chunk=CHUNK)
    assert info == jinfo
    _close(logits, jlogits, f"admission of {len(prompt)} logits")
    return jst, pst, info


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_prefill_into_slot_chunked_equals_jax(lm, kind):
    """A 45-token prompt admitted chunked into slot 0; on paged, then a
    prompt sharing its first 32 tokens into slot 1 with those 2 pages
    adopted (resident 32: one chunk forwarded), then the first 48 tokens
    of a prompt with all 3 pages adopted (fully resident: its last chunk
    forwarded for the logits, its writes sent to TRASH).  Logits, forward
    counts and the slots' states equal JAX's."""
    jcfg, jparams, cfg, params = lm
    jdec = JAPI.build_decode(jcfg, _jspec(kind))
    pdec = build_decode(cfg, _spec(kind), device="cpu")
    jst, pst = jdec.init_state(2, 64), pdec.init_state(2, 64)
    a = _prompt(cfg.vocab_size, 48, seed=31)
    jst, pst, info = _admit_both(jdec, jparams, jst, pdec, params, pst, 0,
                                 a[:45], 0)
    assert info == {"forward_tokens": 48, "chunks": 3}
    if kind == "paged":
        table = pst.bookkeeping[PLT.PAGE_TABLE].numpy().copy()
        for resident, prompt, fwd in (
                (32, np.r_[a[:32], _prompt(cfg.vocab_size, 8, 32)], 16),
                (48, a, 16)):
            n = resident // PAGE
            row = np.r_[table[0, :n], table[1, n:]].astype(np.int32)
            pt = np.stack([table[0], row])
            jst = jst.with_bookkeeping(**{JLT.PAGE_TABLE: jnp.asarray(pt)})
            pst.bookkeeping[PLT.PAGE_TABLE].copy_(_t(pt))
            mask = np.arange(4) >= n
            jst, pst, info = _admit_both(jdec, jparams, jst, pdec, params,
                                         pst, 1, prompt, resident, mask)
            assert info["forward_tokens"] == fwd
    _kv_equal(pst.kv, jst.kv, f"chunked admission {kind}", pst.layout,
              exact=False)
    for f, v in jst.bookkeeping.items():
        np.testing.assert_array_equal(pst.bookkeeping[f].numpy(),
                                      np.asarray(v), err_msg=f)


def test_chunked_prefill_fits_equals_jax(lm):
    """The fit rule on a grid of prompt lengths, resident prefixes and
    chunks: an attention LM resumes after the resident prefix, the SSM
    family forwards from 0, the TConst family always fits."""
    jcfg, _, cfg, _ = lm
    scfg = ssm_pair()
    tcfg = _tconst_pair("tconst")
    for jc, pc in ((jcfg, cfg), (scfg[0], scfg[2]), (tcfg[0], tcfg[2])):
        jdec = JAPI.build_decode(jc)
        pdec = build_decode(pc, device="cpu")
        assert pdec.supports_chunked_prefill() == \
            jdec.supports_chunked_prefill()
        for L in range(1, 70, 3):
            for resident in (0, 16, 32, 64):
                for chunk in (16, 32):
                    for max_len in (64, 80):
                        assert pdec.chunked_prefill_fits(
                            L, resident, chunk, max_len) == \
                            jdec.chunked_prefill_fits(L, resident, chunk,
                                                      max_len), \
                            (pc.name, L, resident, chunk, max_len)


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


def _serve(cfg, params, prompts, kind="dense", prefill_chunk=None, *,
           gen=6, slots=2, stagger=True, pool_pages=None, **kw):
    """The port's scheduler on ``prompts`` (one chunk between submissions
    when ``stagger``): (streams, scheduler)."""
    spec = None if kind == "dense" else _spec(kind, pool_pages)
    sched = SlotScheduler(build_decode(cfg, spec, device="cpu"), params,
                          slots=slots, max_len=128, chunk_size=4,
                          prefill_chunk=prefill_chunk, **kw)
    sessions = []
    for p in prompts:
        sessions.append(sched.submit(Session(p, max_new_tokens=gen)))
        if stagger:
            sched.step()
    sched.run()
    return [s.tokens for s in sessions], sched


def _family(name):
    if name == "tlin":
        return _tconst_pair("tlin")
    return _lm_family(name)


@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("name", ["smollm", "tlin"])
def test_chunked_streams_equal_one_shot(name, kind):
    """Staggered admission of prompts of 21, 34 and 17 tokens: chunked
    admission (tlin: the bucketed one) gives the one-shot streams on every
    layout, and records the tokens each admission forwarded."""
    _need_jax()
    _, _, cfg, params = _family(name)
    prompts = [_prompt(cfg.vocab_size, n, seed=3 + n) for n in (21, 34, 17)]
    ref, _ = _serve(cfg, params, prompts, kind)
    out, sched = _serve(cfg, params, prompts, kind, CHUNK)
    assert out == ref
    fwd = [s.forward_tokens for s in sched.admit_stats]
    assert fwd == ([128] * 3 if name == "tlin" else [32, 48, 32]), fwd


def test_ssm_chunked_streams_equal_one_shot():
    """mamba2: chunked admission from the carried state (prompts of 19 and
    33 tokens: padded last chunks) gives the one-shot streams; a sharing
    admission of the SSM family would forward from 0."""
    _need_jax()
    _, _, cfg, params = ssm_pair()
    prompts = [_prompt(cfg.vocab_size, n, seed=n) for n in (19, 33)]
    ref, _ = _serve(cfg, params, prompts, gen=5)
    out, sched = _serve(cfg, params, prompts, prefill_chunk=CHUNK, gen=5)
    assert out == ref
    assert [s.forward_tokens for s in sched.admit_stats] == [32, 48]
    assert sched.decode._chunk_resident_start(32) == 0


def _shared(vocab, n, common=48, tail=8, seed=0):
    rng = np.random.RandomState(seed)
    head = rng.randint(1, vocab, size=common).astype(np.int32)
    return [np.r_[head, rng.randint(1, vocab, size=tail).astype(np.int32)]
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["paged", "paged_int8"])
def test_sharing_admission_forwards_only_the_tail(lm, kind):
    """Three prompts of a 48-token common prefix and 8-token tails,
    admitted together: the cold admission forwards its whole prompt (64:
    padded), each sharer the tail plus one chunk at most (16: resident
    48, start 48); the streams equal the unchunked sharing run's and the
    solo runs'."""
    _, _, cfg, params = lm
    prompts = _shared(cfg.vocab_size, 3)
    kw = dict(stagger=False, slots=3, prefix_sharing=True)
    ref, _ = _serve(cfg, params, prompts, kind, **kw)
    out, sched = _serve(cfg, params, prompts, kind, CHUNK, **kw)
    assert out == ref
    fwd = [s.forward_tokens for s in sched.admit_stats]
    assert fwd[0] >= len(prompts[0]) and fwd[0] == 64, fwd
    assert all(f <= 8 + CHUNK for f in fwd[1:]) and fwd[1:] == [16, 16], fwd
    for p, got in zip(prompts, out):
        solo, _ = _serve(cfg, params, [p], kind, CHUNK, stagger=False)
        assert got == solo[0]


def test_fully_resident_prompt_never_writes_adopted_pages(lm):
    """A 48-token prompt whose 3 pages are all adopted still forwards its
    last chunk for the first token; the adopted pages keep their bytes
    through the admission and the run, and the streams equal the solo
    run's."""
    _, _, cfg, params = lm
    p = _prompt(cfg.vocab_size, 3 * PAGE, seed=4)
    sched = SlotScheduler(build_decode(cfg, _spec("paged"), device="cpu"),
                          params, slots=2, max_len=128, chunk_size=4,
                          prefix_sharing=True, prefill_chunk=CHUNK)
    s1 = sched.submit(Session(p.copy(), max_new_tokens=6))
    s2 = sched.submit(Session(p.copy(), max_new_tokens=6))
    first = sched._admission_plan(s1)
    sched.pending.popleft()
    sched._admit(s1, 0, first)
    shared = _t(np.asarray(sched._slot_pages[0][:3]))
    before = sched.layout.gather_pages(sched.state.kv, shared)
    sched.admit_pending()
    assert int((sched.page_refcounts() > 1).sum()) == 3
    assert [s.forward_tokens for s in sched.admit_stats] == [48, 16]
    sched.run()
    after = sched.layout.gather_pages(sched.state.kv, shared)
    for f in before:
        assert torch.equal(after[f], before[f]), f
    solo, _ = _serve(cfg, params, [p], "paged", CHUNK, stagger=False)
    assert s1.tokens == solo[0] and s2.tokens == solo[0]


@pytest.mark.parametrize("name", ["tconst", "smollm"])
def test_one_tagged_chunked_signature_across_lengths(name):
    """Four prompt lengths: chunked admission tags one signature (the
    chunk's), one-shot admission one per length."""
    _need_jax()
    _, _, cfg, params = _tconst_pair(name) if name == "tconst" \
        else _lm_family(name)
    prompts = [_prompt(cfg.vocab_size, n, seed=5) for n in (17, 26, 35, 44)]

    def tagged(prefill_chunk):
        sched = SlotScheduler(build_decode(cfg, device="cpu"), params,
                              slots=1, max_len=128, chunk_size=4,
                              prefill_chunk=prefill_chunk)
        for p in prompts:
            sched.submit(Session(p, max_new_tokens=1))
            sched.admit_pending()
        assert len(sched.admit_stats) == len(prompts)
        return sum(1 for s in sched.admit_stats if s.compiled)

    assert tagged(CHUNK) == 1
    assert tagged(None) == len(prompts)


def test_prefill_chunk_checks_and_build_decode_default(lm):
    """A chunk that is no page multiple on a paged layout, or not
    positive, raises; ``build_decode(prefill_chunk=N)`` is the
    scheduler's default (19 tokens: 2 chunks of 16 forwarded)."""
    _, _, cfg, params = lm
    with pytest.raises(ValueError, match="multiple of the page size"):
        SlotScheduler(build_decode(cfg, _spec("paged"), device="cpu"),
                      params, slots=1, max_len=128, prefill_chunk=PAGE + 1)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="must be positive"):
            SlotScheduler(build_decode(cfg, device="cpu"), params, slots=1,
                          max_len=128, prefill_chunk=bad)
        with pytest.raises(ValueError, match="must be positive"):
            build_decode(cfg, device="cpu", prefill_chunk=bad)
    dec = build_decode(cfg, device="cpu", prefill_chunk=CHUNK)
    assert dec.prefill_chunk == CHUNK
    sched = SlotScheduler(dec, params, slots=1, max_len=128)
    assert sched.prefill_chunk == CHUNK
    sched.submit(Session(np.arange(1, 20, dtype=np.int32), max_new_tokens=1))
    sched.admit_pending()
    assert sched.admit_stats[0].forward_tokens == 2 * CHUNK


def test_chunk_grid_past_max_len_admits_in_one_shot(lm):
    """A 65-token prompt at max_len 74: its grid (5 x 16 = 80) would run
    past the buffers, so it is admitted in one shot (65 forwarded,
    unpadded), with the one-shot stream."""
    _, _, cfg, params = lm
    p = _prompt(cfg.vocab_size, 65, seed=6)

    def run(prefill_chunk):
        sched = SlotScheduler(build_decode(cfg, device="cpu"), params,
                              slots=1, max_len=74, chunk_size=4,
                              prefill_chunk=prefill_chunk)
        s = sched.submit(Session(p, max_new_tokens=5))
        sched.run()
        return s.tokens, sched

    out, sched = run(CHUNK)
    assert not sched.decode.chunked_prefill_fits(65, 0, CHUNK, 74)
    assert sched.admit_stats[0].forward_tokens == 65
    assert out == run(None)[0]


def test_serve_cli_prefill_chunk(capsys):
    """``--prefill-chunk`` with prefix sharing on reduced smollm: the
    chunked-prefill line (tail-only forwards), the streams match their
    solo runs; without ``--sessions``, negative, or no page multiple it
    argparse-errors as JAX's launcher does."""
    base = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
            "--sessions", "4", "--slots", "4", "--gen", "6",
            "--prompt-len", "64", "--layout", "paged", "--page-size", "16",
            "--prefix-sharing"]
    assert serve.main(base + ["--prefill-chunk", "16"]) == 0
    out = capsys.readouterr().out
    assert "chunked prefill (chunk=16): forward tokens per admission " \
        "[80, 16, 16, 16]" in out, out
    assert out.count("matches solo run: True") == 4, out
    for bad, msg in ((["--prefill-chunk", "24"], "multiple of --page-size"),
                     (["--prefill-chunk", "-1"], "must be positive")):
        with pytest.raises(SystemExit):
            serve.parse_args(base + bad)
        assert msg in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "smollm-360m", "--prefill-chunk", "16"])
    assert "add --sessions N" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the chunked paths' CPU runs are above)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_k2_at_chunk_shape(dtype, tol):
    """K2 at a chunk's shape -- 64 queries at ``[start, start + 64)`` over
    keys ``[0, start + 64)`` at smollm-360m's heads (15 over 5, D 64), one
    case with a 256 window -- against its plain version on the same CUDA
    tensors, and through ``ops.prefill_chunk_attention``."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for start, window in ((576, 0), (960, 0), (960, 256)):
        live = start + 64
        q = torch.randn((1, 64, 15, 64), generator=gen, device="cuda").to(
            dtype)
        k = torch.randn((1, live, 5, 64), generator=gen, device="cuda").to(
            dtype)
        v = torch.randn((1, live, 5, 64), generator=gen, device="cuda").to(
            dtype)
        qp = (start + torch.arange(64, device="cuda", dtype=torch.int32)
              )[None]
        kp = torch.arange(live, device="cuda", dtype=torch.int32)[None]
        runtime.reset_counters()
        out = ops.prefill_chunk_attention(q, k, v, qp, kp, window)
        assert runtime.read_counters()["flash_attention"] == \
            {"kernel": 1, "plain": 0}
        ref = FA.flash_attention_plain(q, k, v, qp, kp, True, window)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol, (start, window, err)


@pytest.mark.cuda
def test_cuda_write_span_paged_int8_equals_cpu():
    """``write_span`` on a paged_int8 pool on the card (quantize on write,
    the scale pools alongside, ``min_page`` to TRASH) equals the same
    write on the CPU, TRASH left out."""
    _need_cuda()
    cfg = PC.reduced(PC.get_config("smollm_360m"), dtype="float32")
    spec = _spec("paged_int8")
    states = {d: build_decode(cfg, spec, device=d).init_state(2, 64)
              for d in ("cpu", "cuda")}
    pt = np.random.RandomState(4).permutation(8).reshape(2, 4).astype(
        np.int32)
    rng = np.random.RandomState(0)
    shape = (cfg.n_layers, 1, 2 * PAGE, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    chunks = [{f: rng.randn(*shape).astype(np.float32) for f in ("k", "v")}
              for _ in range(2)]
    for dev, st in states.items():
        st.bookkeeping[PLT.PAGE_TABLE].copy_(_t(pt))
        for (start, min_page), chunk in zip(((0, 1), (32, None)), chunks):
            st.write_span(1, {f: _t(v).to(dev) for f, v in chunk.items()},
                          PLM.LENGTH_AXES, start, min_page=min_page)
    cpu, card = states["cpu"], states["cuda"]
    for f, v in cpu.kv.items():
        ax = cpu.layout.page_axis(f)
        keep = [i for i in range(v.shape[ax]) if i != cpu.layout.trash]
        a = card.kv[f].cpu().index_select(ax, torch.tensor(keep))
        b = v.index_select(ax, torch.tensor(keep))
        if f.endswith("__q"):
            assert (a.int() - b.int()).abs().max().item() <= 1, f
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=f)
