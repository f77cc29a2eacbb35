"""Prefix sharing and copy-on-write pages in the port's scheduler, against
the JAX package (``tests/test_prefix_sharing.py`` is the suite mirrored).

Reduced f32 configs on JAX-bridged weights, pages of 16 tokens:

* The page-granular layout methods -- ``fork_pages``, ``write_slot`` with
  a ``page_mask``, ``read_slot``, ``gather_pages``, ``scatter_pages``,
  ``page_axis`` -- bit-equal to JAX's on paged and paged_int8.
* ``stable_prefix_len`` and ``sync_anticipated`` equal to JAX's for tlin
  and an attention LM.
* Reduced tlin on paged, three sessions sharing a 32-token prefix: the
  port's and JAX's ``SlotScheduler(prefix_sharing=True)`` give equal
  refcounts after admission, equal assigned KV bytes, equal greedy
  streams, and both recycle the pool.
* Within the port: paged_int8 sharing equals its solo runs; the CoW
  invariant at every chunk boundary; LM sharing across staggered
  admission; a slot that cannot fork is paused, not crashed; several
  adopters overcommitting the pool resolve; an undersized-pool stress
  run; reduced mixtral in tlin mode, whose padded MoE resync writes back
  a row that maps shared pages, and whose fork-paused rows ride in a
  resync's batch unwritten; the serve CLI's ``--prefix-sharing``.
* On the card (``cuda`` marker; skips without a GPU): tlin on paged_int8
  with sharing against its solo runs, K3-int8 launched.
"""
import functools

import numpy as np
import pytest
import torch

try:    # the GPU machine has no JAX: only the cuda test runs there
    import jax.numpy as jnp
    from parity import family
    from repro.core import tconst as JT
    from repro.models import api as JAPI
    from repro.models import layouts as JLT
    from repro.serving.scheduler import SlotScheduler as JScheduler
    from repro.serving.session import Session as JSession
    from torch_parity import (build_pair, jax_tiny_cfg, jax_to_numpy,
                              lm_pair, port_cfg)
    from repro import config as JC
except ImportError:
    jnp = None
from repro_torch import bridge
from repro_torch import config as PC
from repro_torch import runtime
from repro_torch.core import tconst as PT
from repro_torch.launch import serve
from repro_torch.models import layouts as PLT
from repro_torch.models.api import build_decode, build_model
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session

torch.set_num_threads(1)
PAGE = 16


def _need_jax():
    if jnp is None:
        pytest.skip("the JAX references need JAX (absent on the GPU machine)")


def _t(a):
    return torch.from_numpy(np.array(a))


def shared_prompts(vocab, n, common_len=32, tail_len=8, seed=0):
    """n prompts of one page-aligned common prefix plus distinct tails of
    one length (``parity.shared_prompts``, without JAX)."""
    rng = np.random.RandomState(seed)
    common = rng.randint(1, vocab, size=common_len).astype(np.int32)
    return [np.concatenate([common, rng.randint(
        1, vocab, size=tail_len).astype(np.int32)]) for _ in range(n)]


def _spec(kind, pool_pages):
    return PLT.LayoutSpec(kind=kind, page_size=PAGE, pool_pages=pool_pages)


def _sched(cfg, params, kind="paged", pool_pages=14, slots=3, device="cpu",
           **kw):
    kw.setdefault("prefix_sharing", True)
    return SlotScheduler(build_decode(cfg, _spec(kind, pool_pages),
                                      device=device), params, slots=slots,
                         max_len=128, chunk_size=4, **kw)


def _solo_streams(cfg, params, prompts, gen, kind="paged", pool_pages=14,
                  device="cpu"):
    """One session at a time through the same layout, no sharing."""
    solo = _sched(cfg, params, kind, pool_pages, device=device,
                  prefix_sharing=False)
    out = []
    for p in prompts:
        s = solo.submit(Session(p, max_new_tokens=gen))
        solo.run()
        out.append(s.tokens)
    return out


def _snapshot(sched, pages):
    """Content of pool pages ``pages`` of every paged field (copies)."""
    return sched.layout.gather_pages(sched.state.kv, _t(np.asarray(
        pages, np.int64)).to(sched.device))


def _assert_same(after, before, what):
    for f in before:
        assert torch.equal(after[f], before[f]), f"{what}: {f}"


def _assert_recycled(sched, pool_pages):
    assert (sched.page_refcounts() == 0).all()
    assert sorted(sched.free_pages) == list(range(pool_pages))
    assert not sched._prefix_map and not sched._page_key


@pytest.fixture(scope="module")
def tlin():
    """reduced(tconst_41m) in tlin mode (W_og 8), f32: (JAX cfg, JAX
    params, the port's cfg, its params bridged from JAX's)."""
    _need_jax()
    jcfg, _, jparams = family("tlin")
    return jcfg, jparams, port_cfg(jcfg), \
        bridge.params_from_jax(jax_to_numpy(jparams))


@pytest.fixture(scope="module")
def lm():
    """reduced llama3 (one KV head), f32: as :func:`tlin`."""
    _need_jax()
    return lm_pair("llama3")


# ---------------------------------------------------------------------------
# the layout methods against JAX's
# ---------------------------------------------------------------------------

TINY_SLOTS, TINY_LEN, TINY_PAGE = 2, 40, 8


@pytest.fixture(scope="module")
def tiny_cache():
    """A prefilled two-row tlin cache of the tiny config (numpy)."""
    _need_jax()
    jcfg = jax_tiny_cfg(attention_mode="tlin")
    jparams, _ = build_pair(jcfg)
    tokens = np.random.RandomState(2).randint(0, 97, size=(TINY_SLOTS, 13))
    _, cache = JT.prefill(jparams, jnp.asarray(tokens, jnp.int32), jcfg,
                          max_len=TINY_LEN, mode="tlin")
    return jax_to_numpy(cache)


def _packed(kind, cache):
    """Both layouts packed from one dense cache through one shuffled page
    table: (JAX layout, kv, bk), (port layout, kv, bk), axes."""
    out = []
    for mod, T in ((JLT, JT), (PLT, PT)):
        out.append(mod.bind_layout(
            mod.LayoutSpec(kind=kind, page_size=TINY_PAGE), slots=TINY_SLOTS,
            max_len=TINY_LEN, length_axes=T.LENGTH_AXES,
            quant_fields=T.QUANT_FIELDS, dtype="float32"))
    jl, pl = out
    kv = {k: v for k, v in cache.items() if k in PT.KV_KEYS}
    bk = {k: v for k, v in cache.items() if k not in PT.KV_KEYS}
    bk[PLT.PAGE_TABLE] = np.random.RandomState(5).permutation(
        TINY_SLOTS * pl.pages_per_slot).reshape(
            TINY_SLOTS, pl.pages_per_slot).astype(np.int32)
    axes = {**PT.CACHE_BATCH_AXES, **pl.bookkeeping_axes()}
    jbk = {k: jnp.asarray(v) for k, v in bk.items()}
    pbk = {k: _t(v) for k, v in bk.items()}
    jkv = jl.pack({k: jnp.asarray(v) for k, v in kv.items()}, jbk, axes)
    pkv = pl.pack({k: _t(v) for k, v in kv.items()}, pbk, axes)
    return (jl, jkv, jbk), (pl, pkv, pbk), axes


def _assert_equal(got, want, what, trash=None, layout=None):
    """Field by field, exactly; with ``trash``, a paged field's trash page
    (which takes unordered dead writes) is left out."""
    assert sorted(got) == sorted(want), what
    for f in want:
        g, w = got[f].numpy(), np.asarray(want[f])
        ax = None if trash is None else layout.page_axis(f)
        if ax is not None:
            g, w = np.delete(g, trash, axis=ax), np.delete(w, trash, axis=ax)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


@pytest.mark.parametrize("kind", ["paged", "paged_int8"])
def test_page_methods_bit_equal_to_jax(tiny_cache, kind):
    """``page_axis``, ``read_slot``, ``gather_pages``, ``scatter_pages``,
    ``fork_pages`` (TRASH-padded) and ``write_slot`` with a page mask
    leave the port's pools bit-equal to JAX's; the masked-out pages of
    the written slot are not touched."""
    (jl, jkv, jbk), (pl, pkv, pbk), axes = _packed(kind, tiny_cache)
    trash, pps = pl.trash, pl.pages_per_slot
    table = pbk[PLT.PAGE_TABLE].numpy()
    assert {f: pl.page_axis(f) for f in pkv} == \
        {f: jl.page_axis(f) for f in jkv}
    assert any(pl.page_axis(f) is not None for f in pkv)
    for slot in range(TINY_SLOTS):
        _assert_equal(pl.read_slot(pkv, pbk, axes, slot),
                      jl.read_slot(jkv, jbk, axes, jnp.int32(slot)),
                      f"read_slot {slot}")
    pages = np.array([3, 0, 7, trash], np.int32)
    _assert_equal(pl.gather_pages(pkv, _t(pages)),
                  jl.gather_pages(jkv, jnp.asarray(pages)), "gather_pages")
    # re-adoption: the content of pages 1, 2, 5 uploaded onto 6, 8, 9
    contents = {f: v.numpy() for f, v in pl.gather_pages(
        pkv, _t([1, 2, 5])).items()}
    dst = np.array([6, 8, 9], np.int32)
    jkv = jl.scatter_pages(jkv, jnp.asarray(dst),
                           {f: jnp.asarray(v) for f, v in contents.items()})
    assert pl.scatter_pages(pkv, _t(dst), {f: _t(v) for f, v in
                                           contents.items()}) is pkv
    _assert_equal(pkv, jkv, "scatter_pages")
    # a fork of two pages of slot 0 onto two pages of slot 1, padded
    src = np.full((pps,), trash, np.int32)
    fdst = np.full((pps,), trash, np.int32)
    src[:2], fdst[:2] = table[0, :2], table[1, 3:5]
    jkv = jl.fork_pages(jkv, jnp.asarray(src), jnp.asarray(fdst))
    pl.fork_pages(pkv, _t(src), _t(fdst))
    _assert_equal(pkv, jkv, "fork_pages")
    # admission's tail-only write into slot 1: masked-out entries -> TRASH
    row = {f: np.asarray(v) * np.float32(1.5) for f, v in
           jl.read_slot(jkv, jbk, axes, jnp.int32(0)).items()}
    mask = np.array([False, True, False, True, True])
    kept = pl.gather_pages(pkv, _t(table[1][~mask]))
    jkv = jl.write_slot(jkv, jbk, jnp.int32(1),
                        {f: jnp.asarray(v) for f, v in row.items()}, axes,
                        page_mask=jnp.asarray(mask))
    pl.write_slot(pkv, pbk, 1, {f: _t(v) for f, v in row.items()}, axes,
                  page_mask=_t(mask))
    _assert_equal(pkv, jkv, "write_slot", trash=trash, layout=pl)
    _assert_same(pl.gather_pages(pkv, _t(table[1][~mask])), kept,
                 "masked-out pages")


@pytest.mark.parametrize("fam", ["tlin", "lm"])
def test_stable_prefix_and_sync_anticipated_equal_jax(fam, request):
    """The prefix-sharing hooks of the decode protocol: the port reads the
    host mirror of ``gen_len`` where JAX reads the device (rows not
    ``done``)."""
    jcfg, _, cfg, _ = request.getfixturevalue(fam)
    jdec = JAPI.build_decode(jcfg, JLT.LayoutSpec(kind="paged",
                                                  page_size=PAGE))
    pdec = build_decode(cfg, _spec("paged", None), device="cpu")
    for n in range(1, 50):
        assert pdec.stable_prefix_len(n) == jdec.stable_prefix_len(n), n
    jst, pst = jdec.init_state(4, 64), pdec.init_state(4, 64)
    if fam == "tlin":
        gen = np.array([0, 3, 5, 8], np.int32)
        jst = jst.with_bookkeeping(gen_len=jnp.asarray(gen))
        pst.host["gen_len"] = gen.astype(np.int64)
    for n in (1, 3, 4, 8, 1 << 30):
        np.testing.assert_array_equal(pdec.sync_anticipated(pst, n),
                                      jdec.sync_anticipated(jst, n))


# ---------------------------------------------------------------------------
# the scheduler against JAX's
# ---------------------------------------------------------------------------


def test_tlin_sharing_scheduler_equals_jax(tlin):
    """Three sessions sharing a 32-token prefix (2 pages) on a pool of 14:
    after the first admissions both schedulers hold the same refcounts
    and page tables (the two prefix pages at refcount 3) and the same
    assigned KV bytes; the shared pages are forked before the first
    resync, the greedy streams are equal, and both pools come back."""
    jcfg, jparams, cfg, params = tlin
    prompts = shared_prompts(cfg.vocab_size, 3)
    jsched = JScheduler(JAPI.build_decode(jcfg, JLT.LayoutSpec(
        kind="paged", page_size=PAGE, pool_pages=14)), jparams, slots=3,
        max_len=128, chunk_size=4, prefix_sharing=True)
    sched = _sched(cfg, params)
    jsess = [jsched.submit(JSession(p, max_new_tokens=8)) for p in prompts]
    sess = [sched.submit(Session(p, max_new_tokens=8)) for p in prompts]
    jsched.admit_pending()
    sched.admit_pending()
    refs = sched.page_refcounts()
    np.testing.assert_array_equal(refs, jsched.page_refcounts())
    assert int((refs == 3).sum()) == 2 and int((refs > 0).sum()) == 8
    np.testing.assert_array_equal(
        sched.state.bookkeeping[PLT.PAGE_TABLE].numpy(),
        np.asarray(jsched.state.bookkeeping[JLT.PAGE_TABLE]))
    assert sched.assigned_kv_bytes() == jsched.assigned_kv_bytes()
    jsched.run()
    sched.run()
    assert [s.tokens for s in sess] == [s.tokens for s in jsess]
    assert sched.pages_forked == 4 and sched.fork_pauses == 0
    _assert_recycled(sched, 14)
    assert (jsched.page_refcounts() == 0).all()


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


def test_paged_int8_sharing_equals_solo_runs(tlin):
    """paged_int8: the prefix pages (int8 pools and their scale pools)
    counted once, fewer assigned bytes than the same admissions without
    sharing, streams equal the solo runs on the same layout (JAX's own
    oracle: the one-code int8 flip between frameworks cannot enter)."""
    _, _, cfg, params = tlin
    prompts = shared_prompts(cfg.vocab_size, 3, seed=6)
    sched = _sched(cfg, params, "paged_int8")
    sess = [sched.submit(Session(p, max_new_tokens=8)) for p in prompts]
    sched.admit_pending()
    refs = sched.page_refcounts()
    assert int((refs == 3).sum()) == 2 and int((refs > 0).sum()) == 8
    no_share = _sched(cfg, params, "paged_int8", prefix_sharing=False)
    for p in prompts:
        no_share.submit(Session(p, max_new_tokens=8))
    no_share.admit_pending()
    assert sched.assigned_kv_bytes() < no_share.assigned_kv_bytes()
    sched.run()
    assert [s.tokens for s in sess] == _solo_streams(
        cfg, params, prompts, 8, "paged_int8")
    _assert_recycled(sched, 14)


@pytest.mark.parametrize("tail", [8, 1])
def test_resync_never_writes_shared_pages(tlin, tail):
    """The CoW invariant at every chunk boundary: after the CoW pass a
    slot whose resync may fire in the coming chunk maps only refcount-1
    pages, and the pages still shared come out of the chunk
    bit-identical.  Tails of 8 put every resync at a chunk's first step
    (JAX's case); tails of 1 put one at a chunk's last step, which only
    an anticipation over the whole chunk forks for in time."""
    _, _, cfg, params = tlin
    sched = _sched(cfg, params)
    for p in shared_prompts(cfg.vocab_size, 3, tail_len=tail, seed=1):
        sched.submit(Session(p, max_new_tokens=8))
    saw_shared = saw_fork = False
    while True:
        sched.admit_pending()
        refs_before = sched.page_refcounts()
        tables_before = [list(r) for r in sched._slot_pages]
        saw_shared = saw_shared or bool((refs_before > 1).any())
        anticipated = sched.decode.sync_anticipated(sched.state,
                                                    sched.chunk_size)
        sched._cow_before_chunk()
        refs = sched.page_refcounts()
        for slot in np.nonzero(sched.active)[0]:
            if not anticipated[slot]:
                continue
            assert all(refs[p] == 1 for p in sched._slot_pages[slot]), \
                "a slot about to resync still maps a shared page"
            saw_fork = saw_fork or any(refs_before[p] > 1
                                       for p in tables_before[slot])
        still = np.nonzero(refs > 1)[0]
        before = _snapshot(sched, still)
        if not sched.step() and not sched.pending:
            break
        _assert_same(_snapshot(sched, still), before, "shared pages")
    assert saw_shared and saw_fork
    _assert_recycled(sched, 14)


def test_lm_sharing_persists_across_staggered_admission(lm):
    """An attention LM never rewrites its prompt pages: the two prefix
    pages stay shared for the sessions' lifetime, across staggered
    admission and decode chunks, bit-identical; streams equal the dense
    Engine's."""
    _, _, cfg, params = lm
    pa, pb = shared_prompts(cfg.vocab_size, 2, seed=2)
    sched = _sched(cfg, params, pool_pages=10, slots=2)
    assert not sched._fork_reserve
    sa = sched.submit(Session(pa, max_new_tokens=12))
    sched.step()                      # A decodes alone for one chunk
    sb = sched.submit(Session(pb, max_new_tokens=12))
    sched.step()
    refs = sched.page_refcounts()
    assert int((refs == 2).sum()) == 2 and int((refs > 0).sum()) == 6
    shared = np.nonzero(refs > 1)[0]
    before = _snapshot(sched, shared)
    sched.step()
    _assert_same(_snapshot(sched, shared), before, "LM prefix pages")
    sched.run()
    eng = Engine(build_model(cfg, device="cpu"), params, max_len=128)
    for s, p in ((sa, pa), (sb, pb)):
        assert s.tokens == eng.generate({"tokens": p[None]}, 12)[0].tolist()
    assert sched.pages_forked == 0
    _assert_recycled(sched, 10)


def test_fork_starvation_pauses_slot_instead_of_crashing(tlin):
    """Pool of 8 (4 + 2 + 2 pages): neither sharer can fork for its first
    resync, so both are paused with only their admission token while the
    small session decodes and retires; then they fork and finish, their
    streams exact."""
    _, _, cfg, params = tlin
    pa, pb = shared_prompts(cfg.vocab_size, 2, seed=4)
    small = np.arange(1, 21, dtype=np.int32) % cfg.vocab_size
    sched = _sched(cfg, params, pool_pages=8)
    sa = sched.submit(Session(pa, max_new_tokens=8))
    sb = sched.submit(Session(pb, max_new_tokens=8))
    sc = sched.submit(Session(small, max_new_tokens=4))
    sched.step()
    assert sc.done
    assert len(sa.tokens) == 1 and len(sb.tokens) == 1
    assert sched.fork_pauses >= 2
    sched.run()
    assert [sa.tokens, sb.tokens] == _solo_streams(cfg, params, [pa, pb], 8,
                                                   pool_pages=8)
    _assert_recycled(sched, 8)


def test_multi_adopter_overcommit_resolves_via_pausing(tlin):
    """A pool of 10 for three sharers: the per-admission fork reserve lets
    them overcommit it jointly; the run resolves through pausing and
    retirement, every stream exact."""
    _, _, cfg, params = tlin
    prompts = shared_prompts(cfg.vocab_size, 3, seed=5)
    sched = _sched(cfg, params, pool_pages=10)
    sess = [sched.submit(Session(p, max_new_tokens=8)) for p in prompts]
    sched.run()
    assert all(s.done for s in sess)
    assert [s.tokens for s in sess] == _solo_streams(cfg, params, prompts, 8,
                                                     pool_pages=10)
    _assert_recycled(sched, 10)


def test_scheduler_stress_undersized_pool_mixed_sizes(tlin):
    """Seven sessions, sharers and small standalone prompts of mixed
    budgets, submitted staggered onto 3 slots and an undersized pool of
    12: the run ends with every budget met and the pool recycled; the
    first chunk and the first admission of each signature are tagged as
    compiles, nothing else."""
    _, _, cfg, params = tlin
    rng = np.random.RandomState(3)
    common = rng.randint(1, cfg.vocab_size, size=32).astype(np.int32)
    sched = _sched(cfg, params, pool_pages=12)
    sessions = []
    for i in range(7):
        if i % 2 == 0:
            prompt = np.concatenate([common, rng.randint(
                1, cfg.vocab_size, size=8).astype(np.int32)])
        else:
            prompt = rng.randint(1, cfg.vocab_size,
                                 size=8 + 4 * (i % 3)).astype(np.int32)
        sessions.append(sched.submit(Session(
            prompt, max_new_tokens=4 + 2 * (i % 3))))
        if i % 3 == 2:
            sched.step()
    sched.run()
    for s in sessions:
        assert s.done and len(s.tokens) == s.max_new_tokens
    _assert_recycled(sched, 12)
    chunks = [s for s in sched.stats if s.kind == "chunk"]
    assert chunks[0].compiled and not any(s.compiled for s in chunks[1:])
    admits = sched.admit_stats
    assert admits and admits[0].compiled
    # an admission's tag carries whether it wrote the tail only: sharers
    # admitted with and without adopted pages are two signatures
    assert {("admit", (40, True)), ("admit", (40, False))} <= sched._warm
    assert sum(s.compiled for s in admits) == sum(
        k[0] == "admit" for k in sched._warm)


@functools.lru_cache(maxsize=None)
def _mixtral_tlin():
    jcfg = JC.reduced(JC.get_config("mixtral_8x22b"), dtype="float32",
                      attention_mode="tlin")
    jparams = JT.init_tconst_lm(__import__("jax").random.PRNGKey(0), jcfg)
    return port_cfg(jcfg), bridge.params_from_jax(jax_to_numpy(jparams))


def test_moe_padded_resync_keeps_shared_pages(monkeypatch):
    """Reduced mixtral in tlin mode on paged, 5 slots: three sessions of 40
    tokens resync at the first step (their windows are full) and two of
    33 do not.  All five share the 32-token prefix; the three resyncing
    slots fork, the two others keep sharing it.  The MoE resync's batch
    is JAX's, the 3 pending rows padded to 4 with the lowest other row,
    which maps the shared pages: its write-back (``sel`` False) leaves
    them bit-identical.  Streams equal the same schedule without sharing
    (an MoE resync depends on the rows beside it, so a one-row solo run
    is no oracle)."""
    _need_jax()
    cfg, params = _mixtral_tlin()
    rng = np.random.RandomState(8)
    common = rng.randint(1, cfg.vocab_size, size=32).astype(np.int32)
    prompts = [np.concatenate([common, rng.randint(
        1, cfg.vocab_size, size=n).astype(np.int32)])
        for n in (8, 8, 8, 1, 1)]
    calls = []
    orig = PLT.PagedView.scatter_rows

    def spy(view, idx, sel, rows):
        calls.append((idx.tolist(), sel.tolist()))
        return orig(view, idx, sel, rows)

    monkeypatch.setattr(PLT.PagedView, "scatter_rows", spy)
    streams = {}
    for sharing in (True, False):
        sched = _sched(cfg, params, pool_pages=None, slots=5,
                       prefix_sharing=sharing)
        sess = [sched.submit(Session(p, max_new_tokens=8)) for p in prompts]
        sched.admit_pending()
        if sharing:
            assert int((sched.page_refcounts() == 5).sum()) == 2
            sched._cow_before_chunk()
            refs = sched.page_refcounts()
            assert sched.pages_forked == 6
            shared = np.nonzero(refs > 1)[0]
            assert len(shared) == 2 and all(
                set(shared) <= set(sched._slot_pages[s]) for s in (3, 4))
            before = _snapshot(sched, shared)
            calls.clear()
            sched.step()
            # the first resync: rows 0-2 written, row 3 the padding
            assert calls[0] == ([0, 1, 2, 3], [True, True, True, False])
            _assert_same(_snapshot(sched, shared), before,
                         "shared pages through the padded MoE resync")
        sched.run()
        streams[sharing] = [s.tokens for s in sess]
        if sharing:
            assert all(sched.resyncs[s.sid] >= 1 for s in sess)
            _assert_recycled(sched, sched.layout.pool_pages)
    assert streams[True] == streams[False]


def test_moe_fork_paused_rows_ride_the_resync_unwritten():
    """Reduced mixtral in tlin mode on a pool of 8: the two sharers (full
    windows: pending on the device) cannot fork and are paused while a
    small session decodes.  When the small session resyncs, the MoE batch
    is JAX's, the paused pending rows in it, but only the small row is
    written: the paused rows keep their counters and their shared pages
    bit-identical, and the device's ``gen_len`` stays the host mirror's."""
    _need_jax()
    cfg, params = _mixtral_tlin()
    pa, pb = shared_prompts(cfg.vocab_size, 2, seed=9)
    small = np.arange(1, 21, dtype=np.int32) % cfg.vocab_size
    sched = _sched(cfg, params, pool_pages=8)
    sa = sched.submit(Session(pa, max_new_tokens=8))
    sb = sched.submit(Session(pb, max_new_tokens=8))
    sc = sched.submit(Session(small, max_new_tokens=8))
    sched.step()
    assert len(sa.tokens) == 1 and len(sb.tokens) == 1 and len(sc.tokens) == 5
    shared = np.nonzero(sched.page_refcounts() > 1)[0]
    assert len(shared) == 2
    before = _snapshot(sched, shared)
    resyncs = sched.resyncs[sc.sid]
    sched.step()                       # the small slot resyncs
    assert sched.resyncs[sc.sid] == resyncs + 1
    assert len(sa.tokens) == 1 and len(sb.tokens) == 1
    _assert_same(_snapshot(sched, shared), before, "paused rows' pages")
    np.testing.assert_array_equal(
        sched.state.bookkeeping["gen_len"].numpy()[:2], [8, 8])
    sched.run()
    assert sa.done and sb.done and sc.done
    _assert_recycled(sched, 8)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def test_serve_cli_prefix_sharing(capsys):
    """``--prefix-sharing`` on reduced llama3 (paged): 2 shared pages, the
    streams match their solo runs; it needs ``--sessions`` and a paged
    layout; on pure tconst it is inert and says so."""
    base = ["--arch", "llama3_405b", "--reduced", "--device", "cpu",
            "--sessions", "3", "--slots", "3", "--gen", "8",
            "--prompt-len", "32", "--page-size", "16", "--chunk", "4",
            "--prefix-sharing"]
    assert serve.main(base + ["--layout", "paged"]) == 0
    out = capsys.readouterr().out
    assert "prefix sharing: 2 shared pages (refcount > 1), 8 assigned" \
        in out, out
    assert out.count("matches solo run: True") == 3, out
    no_sessions = base[:4] + base[6:]
    assert "--sessions" not in no_sessions
    for bad in (base + ["--layout", "dense"],
                no_sessions + ["--layout", "paged"]):
        with pytest.raises(SystemExit):
            serve.parse_args(bad)
    err = capsys.readouterr().err
    assert "--prefix-sharing shares pool pages" in err
    assert "--prefix-sharing needs --sessions" in err
    assert serve.main(["--arch", "tconst-41m"] + base[2:] +
                      ["--layout", "paged", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "prefix sharing is inert" in out
    assert out.count("matches solo run: True") == 3, out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_tlin_paged_int8_sharing_equals_solo_runs():
    """Reduced tlin (f32, the port's seeded init) on paged_int8 with
    sharing on the card: the prefix pages are shared and then forked,
    the greedy streams equal the card's solo runs, K3-int8 launched (and
    no plain version), the pool recycled."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the sharing scheduler's CPU runs are above)")
    cfg = PC.reduced(PC.get_config("tconst_41m"), dtype="float32",
                     attention_mode="tlin")
    params = build_model(cfg, device="cuda").init(0)
    prompts = shared_prompts(cfg.vocab_size, 3, seed=7)
    sched = _sched(cfg, params, "paged_int8", device="cuda")
    sess = [sched.submit(Session(p, max_new_tokens=8)) for p in prompts]
    runtime.reset_counters()
    sched.admit_pending()
    assert int((sched.page_refcounts() == 3).sum()) == 2
    sched.run()
    torch.cuda.synchronize()
    counts = runtime.read_counters()
    assert counts["paged_decode_attention_int8"]["kernel"] > 0, counts
    assert all(c["plain"] == 0 for c in counts.values()), counts
    assert sched.pages_forked == 4
    assert [s.tokens for s in sess] == _solo_streams(
        cfg, params, prompts, 8, "paged_int8", device="cuda")
    _assert_recycled(sched, 14)
