"""Session tiering in the port: the TierStore, slot snapshots, spill /
resume, retired prefix pages and the O(1) TConst re-admission, against the
JAX package (``tests/test_tier_store.py`` is the suite mirrored) and within
the port.

Against JAX (f32):

* ``TierStore``: the same op sequences on the port's store and on JAX's
  give the same LRU order, stats, pins, RAM and disk bytes after every op
  (eviction, pins over capacity without a disk tier, demote / promote /
  re-index, a put under all-pinned pressure); a spill directory written
  by either store reads back in the other.
* ``admission_digest`` byte-equal to JAX's.
* ``DecodeState.snapshot_slot`` / ``restore_slot`` bit-equal to JAX's on
  the four layouts (reduced tconst on dense and int8, reduced tlin on
  paged and paged_int8, from one random physical state), restoring into
  another slot.
* One scheduler run on both frameworks (module-scoped JAX fixture):
  a one-block tlin config on paged pages of 8 with prefix sharing, a
  store and ``preempt_chunks=1``, five sessions over two slots, the last
  repeating the first prompt: equal ``spill_stats``, per-session spills /
  resumes, admission sources and greedy streams.  JAX's (family x layout)
  grid is not replayed: its jit compiles cost ~30-60 s of one core a
  case.

Within the port (the port's own seeded init; no JAX compile): spill /
resume streams equal never-spilled ones for tconst, tlin, a GQA LM and
mamba2 on the layouts each has, greedy and at temperature > 0 (the
generator state carried); a spill, another session in the same slot, a
resume (the stored blob is a copy); bf16 round trips bit-exact, KV and
stored logits; the host ``gen_len`` mirror after a restore; pinned
spills under a tight capacity; the disk tier; retired prefix pages
re-adopted with a tail-only chunked admission; a store hit that never
calls a prefill entry point; the key salt; the constructor's refusals; a
missing pinned snapshot raises; the serve CLI.  On the card (``cuda``
marker; skips without a GPU): a bf16 paged_int8 snapshot restored into
another slot, and a TConst store hit that launches no K1 or K2.
"""
import numpy as np
import pytest
import torch

try:    # the GPU machine has no JAX: only the cuda tests run there
    import jax
    import jax.numpy as jnp
    from repro import config as JC
    from repro.core import tconst as JT
    from repro.models import api as JAPI
    from repro.models import layouts as JLT
    from repro.serving import tier_store as JTS
    from repro.serving.scheduler import SlotScheduler as JScheduler
    from repro.serving.session import Session as JSession
    from torch_parity import build_pair, jax_tiny_cfg, port_cfg
except ImportError:
    jax = None
from repro_torch import config as PC
from repro_torch import runtime
from repro_torch.core import tconst as PT
from repro_torch.launch import serve
from repro_torch.models import layouts as PLT
from repro_torch.models.api import DecodeState, build_decode, build_model
from repro_torch.serving import tier_store as PTS
from repro_torch.serving.scheduler import SlotScheduler, to_device, to_host
from repro_torch.serving.session import Session
from repro_torch.serving.tier_store import Blob, TierStore

torch.set_num_threads(1)
PAGE = 8            # spill points land mid-page (JAX's suite)
POOL = 40
MAX_LEN = 96


def _need_jax():
    if jax is None:
        pytest.skip("the JAX references need JAX (absent on the GPU machine)")


def _spec(kind, pool_pages=POOL):
    if kind == "dense":
        return None
    return PLT.LayoutSpec(kind=kind, page_size=PAGE, pool_pages=pool_pages)


def _prompts(vocab, n, seed=3):
    # lengths straddle page boundaries so spill points land mid-page
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=9 + 4 * i).astype(np.int32)
            for i in range(n)]


# the port's families, reduced, f32, on the port's own seeded init: name ->
# (registry arch, config overrides).  "lm" is GQA (2 KV heads over 4)
FAMILIES = {"tconst": ("tconst_41m", {}),
            "tlin": ("tconst_41m", {"attention_mode": "tlin"}),
            "lm": ("smollm_360m", {"n_kv_heads": 2}),
            "mamba2": ("mamba2_130m", {})}
_MODELS = {}


def _model(name, dtype="float32"):
    key = (name, dtype)
    if key not in _MODELS:
        arch, kw = FAMILIES[name]
        cfg = PC.reduced(PC.get_config(arch), dtype=dtype, **kw)
        _MODELS[key] = cfg, build_model(cfg, device="cpu").init(0)
    return _MODELS[key]


def _sched(cfg, params, kind="dense", slots=2, store=None, preempt=None,
           **kw):
    return SlotScheduler(build_decode(cfg, _spec(kind), device="cpu"),
                         params, slots=slots, max_len=kw.pop("max_len",
                                                             MAX_LEN),
                         chunk_size=4, tier_store=store,
                         preempt_chunks=preempt, **kw)


def _serve(cfg, params, prompts, kind="dense", gen=8, temperature=0.0,
           **kw):
    sched = _sched(cfg, params, kind, **kw)
    sess = [sched.submit(Session(p, max_new_tokens=gen,
                                 temperature=temperature, seed=17 + i))
            for i, p in enumerate(prompts)]
    sched.run()
    return sched, sess


# ---------------------------------------------------------------------------
# the TierStore against JAX's
# ---------------------------------------------------------------------------


def _blob(mod, nbytes, fill):
    return mod.Blob({"x": np.full((nbytes,), fill, np.uint8)},
                    {"fill": fill})


K = {c: c.encode() * 20 for c in "abcdpuvABC"}
# op scripts: ("put", key, nbytes, fill, pin) / ("get"|"contains"|"pin"|
# "unpin"|"pop", key) / ("reopen",): a fresh store over the same dir.
# Each mirrors a test of tests/test_tier_store.py
STORE_SCRIPTS = {
    "lru": (256, False, [
        ("put", "a", 100, 1, False), ("put", "b", 100, 2, False),
        ("get", "a"), ("contains", "b"), ("contains", "a"),
        ("put", "c", 100, 3, False), ("get", "b"), ("pop", "a"),
        ("contains", "a")]),
    "pins_without_disk": (64, False, [
        ("put", "p", 100, 7, True), ("put", "v", 100, 8, False),
        ("unpin", "p"), ("put", "v", 100, 8, False), ("contains", "p")]),
    "all_pinned": (128, False, [
        ("put", "A", 100, 0, True), ("put", "B", 100, 1, True),
        ("put", "C", 100, 2, True), ("put", "u", 50, 9, False),
        ("get", "B"), ("pin", "B"), ("unpin", "B"), ("unpin", "A"),
        ("put", "u", 50, 9, False)]),
    "disk_tier": (128, True, [
        ("put", "a", 100, 5, True), ("put", "b", 100, 2, False),
        ("get", "a"), ("get", "b"), ("put", "c", 100, 3, False),
        ("reopen",), ("get", "a"), ("pop", "b"), ("get", "b")]),
    "promote": (250, True, [
        ("put", "a", 100, 1, False), ("put", "b", 100, 2, False),
        ("put", "c", 100, 3, False), ("get", "a"),
        ("put", "d", 100, 4, False), ("get", "a"), ("get", "c")]),
}


def _replay(mod, capacity, disk, ops, tmp):
    """Run an op script on ``mod.TierStore``; after every op record what
    the op returned and the store's LRU order, stats, pins and bytes."""
    spill_dir = str(tmp) if disk else None
    st = mod.TierStore(capacity_bytes=capacity, spill_dir=spill_dir)
    trace = []
    for op in ops:
        name, key = op[0], K.get(op[1]) if len(op) > 1 else None
        if name == "put":
            st.put(key, _blob(mod, op[2], op[3]), pin=op[4])
            out = None
        elif name == "get" or name == "pop":
            b = getattr(st, name)(key)
            out = None if b is None else (b.meta, np.asarray(
                b.arrays["x"]).tolist())
        elif name == "contains":
            out = key in st
        elif name == "reopen":
            st = mod.TierStore(capacity_bytes=capacity, spill_dir=spill_dir)
            out = None
        else:
            out = getattr(st, name)(key)
        trace.append((op, out, list(st._ram), dict(st.stats),
                      sorted(st._pins.items()), st.occupancy_bytes,
                      st.disk_bytes, len(st), sorted(st.pinned_keys())))
    return trace


@pytest.mark.parametrize("script", sorted(STORE_SCRIPTS))
def test_store_matches_jax_op_sequence(script, tmp_path):
    """The port's TierStore is JAX's, op for op."""
    _need_jax()
    capacity, disk, ops = STORE_SCRIPTS[script]
    got = _replay(PTS, capacity, disk, ops, tmp_path / "port")
    want = _replay(JTS, capacity, disk, ops, tmp_path / "jax")
    for g, w in zip(got, want):
        assert g == w, f"{script}: after {g[0]}"
    assert len(got) == len(ops)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spill_dir_interchangeable(writer, tmp_path):
    """A blob demoted by either store (one .npy per array + meta.json)
    reads back in the other: arrays (int16 bits of a bfloat16 tensor,
    bool, int8, float32) and meta equal."""
    _need_jax()
    src, dst = (PTS, JTS) if writer == "port" else (JTS, PTS)
    rng = np.random.RandomState(0)
    arrays = {"kv.ctx_k": rng.randint(-2 ** 15, 2 ** 15, (1, 3, 4),
                                      dtype=np.int64).astype(np.int16),
              "bk.done": np.array([True]),
              "kv.hist_k__q": rng.randint(-127, 128, (2, 8),
                                          dtype=np.int64).astype(np.int8),
              "logits": rng.randn(7).astype(np.float32)}
    meta = {"kind": "admit", "logits_dtype": "float32", "sid": 3}
    st = src.TierStore(capacity_bytes=1, spill_dir=str(tmp_path))
    st.put(b"k" * 20, src.Blob(dict(arrays), dict(meta)))
    st.put(b"j" * 20, src.Blob({"x": np.zeros(4, np.uint8)}, {}))
    assert st.stats["demotions"] == 2
    other = dst.TierStore(capacity_bytes=1 << 20, spill_dir=str(tmp_path))
    assert b"k" * 20 in other and other.disk_bytes == st.disk_bytes
    blob = other.get(b"k" * 20)
    assert blob.meta == meta and blob.nbytes == sum(
        a.nbytes for a in arrays.values())
    for name, a in arrays.items():
        b = np.asarray(blob.arrays[name])
        assert b.dtype == a.dtype and np.array_equal(b, a), name
    bk, kv, m = dst.unflatten_slot_snapshot(blob)
    assert set(bk) == {"done"} and set(kv) == {"ctx_k", "hist_k__q"}
    assert m == meta


def test_admission_digest_equals_jax():
    _need_jax()
    rng = np.random.RandomState(1)
    for n in (1, 9, 300):
        toks = rng.randint(0, 50257, size=n).astype(np.int32)
        for mode in ("tconst", "tlin"):
            for w_og in (8, 256):
                assert PT.admission_digest(toks, mode, w_og) == \
                    JT.admission_digest(toks, mode, w_og)
    # the decode's key, and None with extras (JAX's rule)
    cfg = _model("tconst")[0]
    dec = build_decode(cfg, device="cpu")
    toks = rng.randint(0, 512, size=20).astype(np.int32)
    assert dec.admission_key(toks) == JT.admission_digest(
        toks, "tconst", cfg.tconst.w_og)
    assert dec.admission_key(toks, {"x": np.zeros(2)}) is None
    assert build_decode(_model("lm")[0], device="cpu").admission_key(
        toks) is None


# ---------------------------------------------------------------------------
# snapshot / restore against JAX's
# ---------------------------------------------------------------------------

SNAP_SLOTS = 3


def _random_cache(cfg, mode, seed=0):
    """A filled numpy cache of the TConst shapes: every KV field random,
    the bookkeeping random ids, lengths and flags."""
    rng = np.random.RandomState(seed)
    out = {}
    for f, v in PT.init_tconst_cache(cfg, SNAP_SLOTS, MAX_LEN, mode).items():
        if v.dtype == torch.bool:
            out[f] = rng.rand(*v.shape) < 0.5
        elif v.dtype == torch.int32:
            out[f] = rng.randint(0, 97, size=v.shape).astype(np.int32)
        else:
            out[f] = rng.randn(*v.shape).astype(np.float32)
    return out


def _states(kind):
    """One random physical state on both frameworks (the tlin history
    through a shuffled page table of the full pool): (JAX DecodeState,
    the port's)."""
    mode = "tlin" if kind.startswith("paged") else "tconst"
    cfg = _model(mode)[0]
    cache = _random_cache(cfg, mode)
    spec = PLT.LayoutSpec(kind=kind, page_size=PAGE)
    jspec = JLT.LayoutSpec(kind=kind, page_size=PAGE)
    bind = dict(slots=SNAP_SLOTS, max_len=MAX_LEN,
                quant_fields=PT.QUANT_FIELDS, dtype="float32")
    pl = PLT.bind_layout(spec, length_axes=PT.LENGTH_AXES, **bind)
    jl = JLT.bind_layout(jspec, length_axes=JT.LENGTH_AXES, **bind)
    kv = {k: v for k, v in cache.items() if k in PT.KV_KEYS}
    bk = {k: v for k, v in cache.items() if k not in PT.KV_KEYS}
    axes = {**PT.CACHE_BATCH_AXES, **pl.bookkeeping_axes()}
    if kind.startswith("paged"):
        bk[PLT.PAGE_TABLE] = np.random.RandomState(5).permutation(
            SNAP_SLOTS * pl.pages_per_slot).reshape(
                SNAP_SLOTS, -1).astype(np.int32)
    jbk = {k: jnp.asarray(v) for k, v in bk.items()}
    pbk = {k: torch.from_numpy(v.copy()) for k, v in bk.items()}
    jst = JAPI.DecodeState(jl.pack({k: jnp.asarray(v) for k, v in
                                    kv.items()}, jbk, axes), jbk, axes, jl)
    pst = DecodeState(pl.pack({k: torch.from_numpy(v.copy()) for k, v in
                               kv.items()}, pbk, axes), pbk, axes,
                      {"gen_len": bk["gen_len"].astype(np.int64)}, pl)
    return jst, pst


def _assert_state_equal(pst, jst, what):
    for part in ("kv", "bookkeeping"):
        got, want = getattr(pst, part), getattr(jst, part)
        assert sorted(got) == sorted(want), (what, part)
        for f in want:
            np.testing.assert_array_equal(got[f].numpy(), np.asarray(
                want[f]), err_msg=f"{what}: {part} {f}")


@pytest.mark.parametrize("kind", ["dense", "int8", "paged", "paged_int8"])
def test_snapshot_restore_bit_equal_to_jax(kind):
    """Slot 0's snapshot equals JAX's bit for bit in the physical
    representation (int8 codes and scales, the slot's page stacks); its
    host form restored into slot 2 leaves the whole state equal to JAX's
    after the same restore, and the host ``gen_len`` mirror follows."""
    _need_jax()
    jst, pst = _states(kind)
    jsnap = jst.snapshot_slot(jnp.int32(0))
    psnap = pst.snapshot_slot(0)
    for part in ("bookkeeping", "kv"):
        assert sorted(psnap[part]) == sorted(jsnap[part]), part
        for f, v in jsnap[part].items():
            np.testing.assert_array_equal(psnap[part][f].numpy(),
                                          np.asarray(v), err_msg=f)
    if "int8" in kind:
        assert any(v.dtype == torch.int8 for v in psnap["kv"].values())
    host = {part: {f: to_host(v) for f, v in rows.items()}
            for part, rows in psnap.items()}
    psnap["kv"]["ctx_k" if "ctx_k" in psnap["kv"] else "ctx_k__q"].zero_()
    pst.restore_slot(2, {part: {f: to_device(v, "cpu")
                                for f, v in rows.items()}
                         for part, rows in host.items()})
    jst = jst.restore_slot(jnp.int32(2), jsnap)
    _assert_state_equal(pst, jst, f"restore {kind}")
    assert pst.host["gen_len"][2] == int(np.asarray(
        jst.bookkeeping["gen_len"])[2])


# ---------------------------------------------------------------------------
# one scheduler run against JAX's
# ---------------------------------------------------------------------------


def _tiny_tlin_cfg():
    """One TConst block of depth 3 (h 1, W_oh = W_og = 8) in tlin mode:
    the smallest config whose history is paged (JAX's compile of the
    scheduler's programs dominates this file)."""
    return jax_tiny_cfg(attention_mode="tlin", n_layers=3,
                        tconst=JC.TConstConfig(w_oh=8, w_og=8, h=1))


def _tiering_prompts(vocab):
    """Four prompts of one 32-token prefix (4 pages of 8, all stable: the
    one-token tails put g0 at 1) and distinct tails, then the first
    again: an admission-cache hit."""
    rng = np.random.RandomState(0)
    common = rng.randint(1, vocab, size=32).astype(np.int32)
    out = [np.concatenate([common, rng.randint(1, vocab, size=1).astype(
        np.int32)]) for _ in range(4)]
    return out + [out[0].copy()]


def _tiering_kw():
    return dict(slots=2, max_len=MAX_LEN, chunk_size=4, prefix_sharing=True,
                preempt_chunks=1)


@pytest.fixture(scope="module")
def jax_tiered():
    """The JAX scheduler's run, once: (prompts, scheduler, sessions) and
    the port's params bridged from the same init."""
    _need_jax()
    jcfg = _tiny_tlin_cfg()
    jparams, params = build_pair(jcfg)
    prompts = _tiering_prompts(jcfg.vocab_size)
    jsched = JScheduler(JAPI.build_decode(jcfg, JLT.LayoutSpec(
        kind="paged", page_size=PAGE, pool_pages=POOL)), jparams,
        tier_store=JTS.TierStore(), **_tiering_kw())
    jsess = [jsched.submit(JSession(p, max_new_tokens=8)) for p in prompts]
    jsched.run()
    return port_cfg(jcfg), params, prompts, jsched, jsess


def test_tiered_scheduler_equals_jax(jax_tiered):
    """Five sessions over two slots, preempted every chunk: the port's
    scheduler spills, resumes, retires and re-adopts prefix pages, puts
    and hits the admission cache exactly as JAX's does, and streams the
    same greedy tokens."""
    cfg, params, prompts, jsched, jsess = jax_tiered
    sched = SlotScheduler(build_decode(cfg, _spec("paged"), device="cpu"),
                          params, tier_store=TierStore(), **_tiering_kw())
    sess = [sched.submit(Session(p, max_new_tokens=8)) for p in prompts]
    sched.run()
    assert sched.spill_stats == jsched.spill_stats
    st = sched.spill_stats
    assert st["spills"] == st["resumes"] > 0 and st["admit_store_hits"] == 1
    assert st["pages_retired"] > 0 and st["pages_readopted"] > 0
    assert [(s.spills, s.resumes) for s in sess] == \
        [(s.spills, s.resumes) for s in jsess]
    assert [a.source for a in sched.admit_stats] == \
        [a.source for a in jsched.admit_stats]
    assert [a.forward_tokens for a in sched.admit_stats] == \
        [a.forward_tokens for a in jsched.admit_stats]
    assert [s.tokens for s in sess] == [s.tokens for s in jsess]
    assert (sched.page_refcounts() == 0).all()
    assert sorted(sched.free_pages) == list(range(POOL))


# ---------------------------------------------------------------------------
# within the port: spill / resume streams
# ---------------------------------------------------------------------------

STREAM_CASES = [("tconst", "dense", 0.0), ("tconst", "int8", 0.0),
                ("tconst", "dense", 0.8), ("tlin", "paged", 0.0),
                ("tlin", "paged_int8", 0.0), ("tlin", "paged", 0.8),
                ("lm", "dense", 0.0), ("lm", "int8", 0.0),
                ("lm", "paged", 0.0), ("lm", "paged_int8", 0.0),
                ("lm", "paged", 0.8), ("mamba2", "dense", 0.0),
                ("mamba2", "dense", 0.8)]


@pytest.mark.parametrize("fam,kind,temperature", STREAM_CASES)
def test_spill_resume_streams_equal_untiered(fam, kind, temperature):
    """Four sessions over two slots, spilled every chunk, stream exactly
    as over four slots without a store (at temperature > 0 too: each
    session's generator state rides through its spills); every excess
    session completes a cycle, resumes forward nothing, every pin and
    page comes back, and a TConst session resyncs as often as unspilled
    (the host ``gen_len`` mirror is restored)."""
    cfg, params = _model(fam)
    prompts = _prompts(cfg.vocab_size, 4)
    sharing = kind.startswith("paged")
    ref, rsess = _serve(cfg, params, prompts, kind, slots=4,
                        temperature=temperature, prefix_sharing=sharing)
    store = TierStore(capacity_bytes=1 << 30)
    sched, sess = _serve(cfg, params, prompts, kind, slots=2, store=store,
                         preempt=1, temperature=temperature,
                         prefix_sharing=sharing)
    assert [s.tokens for s in sess] == [s.tokens for s in rsess]
    assert sum(1 for s in sess if s.resumes >= 1) >= 2
    st = sched.spill_stats
    assert st["spills"] == st["resumes"] > 0
    resumes = [a for a in sched.admit_stats if a.source == "resume"]
    assert resumes and all(a.forward_tokens == 0 for a in resumes)
    assert not tuple(store.pinned_keys())
    assert [sched.resyncs[s.sid] for s in sess] == \
        [ref.resyncs[r.sid] for r in rsess]
    if sched._paged:
        assert (sched.page_refcounts() == 0).all()
        assert sorted(sched.free_pages) == list(range(POOL))
        if sharing:
            assert st["pages_retired"] > 0


def test_spill_then_other_session_then_resume():
    """Spill A out of slot 0, admit B into slot 0 (its prefill writes the
    slot the release just cleared), resume A into slot 1: A's stored
    snapshot is a copy (the release's in-place clear and B's prefill leave
    it as spilled), and A streams as if never spilled."""
    cfg, params = _model("tconst")
    pa, pb = _prompts(cfg.vocab_size, 2, seed=5)
    store = TierStore()
    sched = _sched(cfg, params, "dense", store=store)
    sa = sched.submit(Session(pa, max_new_tokens=10))
    sched.step()                                 # A decodes in slot 0
    assert sa.slot == 0 and len(sa.tokens) == 5
    before = {part: {f: to_host(v) for f, v in rows.items()}
              for part, rows in sched.state.snapshot_slot(0).items()}
    key = sched.spill(0)
    assert sa.slot is None and sa.snap_key == key
    assert key in tuple(store.pinned_keys())
    assert not sched.state.kv["ctx_k"][:, :, 0].any()   # slot 0 cleared
    sb = sched.submit(Session(pb, max_new_tokens=4))
    sched.pending.rotate(-1)                     # B ahead of A: slot 0
    sched.admit_pending()
    assert sb.slot == 0 and sa.slot == 1 and sa.resumes == 1
    blob = store.get(key)
    assert blob is not None and not tuple(store.pinned_keys())
    for part, rows in before.items():
        for f, v in rows.items():
            got = blob.arrays[("bk." if part == "bookkeeping" else "kv.")
                              + f]
            np.testing.assert_array_equal(got, v, err_msg=f)
    sched.run()
    _, (ra,) = _serve(cfg, params, [pa], gen=10)
    assert sa.tokens == ra.tokens


def test_missing_pinned_snapshot_raises():
    """A spilled session whose pinned snapshot is gone is refused, never
    prefilled again."""
    cfg, params = _model("tconst")
    store = TierStore()
    sched = _sched(cfg, params, "dense", slots=1, store=store)
    sess = sched.submit(Session(_prompts(cfg.vocab_size, 1)[0],
                                max_new_tokens=10))
    sched.step()
    key = sched.spill(0)
    store.pop(key)
    with pytest.raises(RuntimeError, match="pinned snapshot is missing"):
        sched.admit_pending()
    assert sess.resumes == 0


def test_bf16_snapshot_roundtrip_bit_exact():
    """bf16 tlin on paged: the stored snapshot holds each bf16 tensor's
    int16 bits and the logits (float32) as computed; a second scheduler on
    the same store restores the slot bit for bit (its first token from the
    stored logits), and the snapshot's bytes are the physical ones."""
    cfg, params = _model("tlin", "bfloat16")
    prompt = _prompts(cfg.vocab_size, 1, seed=9)[0]
    store = TierStore()
    s1 = _sched(cfg, params, "paged", store=store)
    a = s1.submit(Session(prompt.copy(), max_new_tokens=6))
    s1.admit_pending()
    key = s1._admission_key(a)
    blob = store.get(key)
    assert blob.meta["logits_dtype"] == "float32"
    dec = s1.decode
    fresh = dec.init_state(1, MAX_LEN)
    logits, _ = dec.prefill_into_slot(s1.params, fresh, 0, prompt)
    assert torch.equal(torch.from_numpy(np.asarray(blob.arrays["logits"])),
                       logits)
    live = s1._live_pages(a)
    want = {}
    for f, v in s1.state.snapshot_slot(0)["kv"].items():
        ax = s1._page_axes.get(f)
        want[f] = v if ax is None else v.narrow(ax, 0, live)
        got = np.asarray(blob.arrays["kv." + f])
        if v.dtype == torch.bfloat16:
            assert got.dtype == np.int16, f
            assert torch.equal(torch.from_numpy(got).view(torch.bfloat16),
                               want[f]), f
        assert got.nbytes == want[f].numel() * want[f].element_size()
    s2 = _sched(cfg, params, "paged", store=store)
    b = s2.submit(Session(prompt.copy(), max_new_tokens=6))
    s2.admit_pending()
    assert s2.admit_stats[0].source == "store"
    assert b.tokens == a.tokens
    for f, v in s2.state.snapshot_slot(0)["kv"].items():
        ax = s2._page_axes.get(f)
        v = v if ax is None else v.narrow(ax, 0, live)
        assert v.dtype == want[f].dtype and torch.equal(v, want[f]), f
    s1.run()
    s2.run()
    assert b.tokens == a.tokens


def test_restore_sets_host_gen_len():
    """``restore_slot`` sets the host mirror of ``gen_len`` from the
    restored rows: the decode loop then resyncs the slot at the step it
    would have resynced before the spill."""
    cfg, params = _model("tconst")
    dec = build_decode(cfg, device="cpu")
    p = dec.prepare_params(params)
    st = dec.init_state(2, MAX_LEN)
    prompt = _prompts(cfg.vocab_size, 3)[2]                 # 17 tokens
    dec.prefill_into_slot(p, st, 0, prompt)
    g0 = (len(prompt) - 1) % cfg.tconst.w_og + 1
    assert st.host["gen_len"].tolist() == [g0, 0]
    st.restore_slot(1, st.snapshot_slot(0))
    assert st.host["gen_len"].tolist() == [g0, g0]
    steps = cfg.tconst.w_og - g0
    tok = torch.zeros((2,), dtype=torch.int32)
    for _ in range(steps):
        assert not dec.sync_candidates(st).any()
        _, st = dec.raw_step(p, st, tok)
    assert dec.sync_candidates(st).tolist() == [True, True]


def test_tight_capacity_keeps_pinned_spills_exact():
    """A store far below one snapshot evicts the unpinned admission
    entries, but pinned session snapshots survive without a disk tier and
    the streams stay exact."""
    cfg, params = _model("tconst")
    prompts = _prompts(cfg.vocab_size, 3, seed=7)
    _, ref = _serve(cfg, params, prompts, "paged", slots=3,
                    prefix_sharing=True)
    store = TierStore(capacity_bytes=4096)
    _, got = _serve(cfg, params, prompts, "paged", slots=1, store=store,
                    preempt=1, prefix_sharing=True)
    assert [s.tokens for s in got] == [s.tokens for s in ref]
    assert store.stats["evictions"] > 0
    assert not tuple(store.pinned_keys())


def test_disk_tier_roundtrip(tmp_path):
    """With a spill directory a squeezed RAM tier demotes snapshots to
    disk (read back as read-only memmaps) and resumes promote them: the
    streams stay exact and the files are there."""
    cfg, params = _model("tlin")
    prompts = _prompts(cfg.vocab_size, 3, seed=8)
    _, ref = _serve(cfg, params, prompts, "paged_int8", slots=3)
    store = TierStore(capacity_bytes=4096, spill_dir=str(tmp_path / "t"))
    _, got = _serve(cfg, params, prompts, "paged_int8", slots=1,
                    store=store, preempt=1)
    assert [s.tokens for s in got] == [s.tokens for s in ref]
    assert store.stats["demotions"] > 0 and store.stats["promotions"] > 0
    assert any((tmp_path / "t").iterdir())


def test_retired_prefix_pages_readopted_tail_only():
    """After the only holder of a prefix retires, its refcount-0 pages
    retire INTO the store; a later admission of the same prefix re-adopts
    them (one upload) and its chunked admission forwards the tail only --
    one chunk -- and streams exactly as a cold run."""
    cfg, params = _model("lm")
    rng = np.random.RandomState(11)
    common = rng.randint(1, cfg.vocab_size, size=4 * PAGE).astype(np.int32)
    pa, pb = (np.concatenate([common, rng.randint(
        1, cfg.vocab_size, size=PAGE).astype(np.int32)]) for _ in range(2))
    store = TierStore()
    sched = _sched(cfg, params, "paged", slots=1, store=store,
                   prefix_sharing=True, prefill_chunk=PAGE)
    sched.submit(Session(pa, max_new_tokens=4))
    sched.run()
    assert sched.spill_stats["pages_retired"] == 5   # the whole prompt
    assert not sched._prefix_map and len(sched.free_pages) == POOL
    sb = sched.submit(Session(pb, max_new_tokens=4))
    sched.admit_pending()
    assert sched.spill_stats["pages_readopted"] == 4
    assert sched.admit_stats[-1].forward_tokens == PAGE
    sched.run()
    _, (rb,) = _serve(cfg, params, [pb], "paged", gen=4,
                      prefill_chunk=PAGE)
    assert sb.tokens == rb.tokens


def test_store_hit_never_prefills():
    """A prompt whose admission snapshot is in the store re-admits without
    calling a prefill entry point, forwards 0 tokens and streams as the
    cold admission did."""
    cfg, params = _model("tconst")
    prompt = _prompts(cfg.vocab_size, 1, seed=13)[0]
    store = TierStore()
    s1, (a,) = _serve(cfg, params, [prompt.copy()], "paged", store=store,
                      prefix_sharing=True)
    assert s1.admit_stats[-1].source == "cold"
    assert s1.spill_stats["admit_store_puts"] == 1
    s2 = _sched(cfg, params, "paged", store=store, prefix_sharing=True)

    def boom(*args, **kw):
        raise AssertionError("a prefill ran on a store-hit admission")

    class NoPrefill:                         # only the prefills are mined
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        prefill_into_slot = prefill_into_slot_chunked = staticmethod(boom)

    s2.decode = NoPrefill(s2.decode)
    b = s2.submit(Session(prompt.copy(), max_new_tokens=8, seed=17))
    s2.run()
    admit = s2.admit_stats[0]
    assert admit.source == "store" and admit.forward_tokens == 0
    assert s2.spill_stats["admit_store_hits"] == 1
    assert b.tokens == a.tokens


@pytest.mark.parametrize("change", ["none", "max_len", "layout",
                                    "prefill_chunk"])
def test_store_salt_separates_schedulers(change):
    """Admission snapshots cross only between schedulers of one max_len,
    bound layout and prefill path."""
    cfg, params = _model("tconst")
    prompt = _prompts(cfg.vocab_size, 1, seed=17)[0]
    store = TierStore()
    _, (a,) = _serve(cfg, params, [prompt.copy()], "dense", slots=1,
                     store=store, gen=6)
    kw = {"max_len": {"max_len": 64}, "prefill_chunk": {"prefill_chunk": 8},
          }.get(change, {})
    s2, (b,) = _serve(cfg, params, [prompt.copy()],
                      "int8" if change == "layout" else "dense", slots=1,
                      store=store, gen=6, **kw)
    hit = change == "none"
    assert s2.spill_stats["admit_store_hits"] == int(hit)
    assert s2.admit_stats[0].source == ("store" if hit else "cold")
    if change != "layout":
        assert b.tokens == a.tokens
    assert "tensor" not in s2._store_salt().decode()


def test_preemption_requires_store_and_validates_args():
    cfg, params = _model("tconst")
    with pytest.raises(ValueError, match="needs a tier_store"):
        _sched(cfg, params, "paged", slots=1, preempt=1)
    with pytest.raises(ValueError, match="must be positive"):
        _sched(cfg, params, "paged", slots=1, store=TierStore(), preempt=0)
    with pytest.raises(ValueError, match="capacity_bytes must be >= 0"):
        TierStore(capacity_bytes=-1)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def test_serve_cli_tiering(capsys):
    """``--spill-capacity-mb`` serves oversubscribed sessions through the
    store: the tiering lines, every excess session completes a cycle, and
    the greedy streams match their solo runs."""
    rc = serve.main(["--arch", "tconst-41m", "--reduced", "--device", "cpu",
                     "--dtype", "float32", "--sessions", "3", "--slots",
                     "1", "--gen", "8", "--chunk", "4", "--prompt-len",
                     "12", "--spill-capacity-mb", "64"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[serve] tiering: " in out and " resumes (" in out
    assert "spill->resume cycle (oversubscribed by 2): ok" in out
    assert out.count("matches solo run: True") == 3


@pytest.mark.parametrize("flags,message", [
    (["--sessions", "2", "--spill-capacity-mb", "-1"], "must be positive"),
    (["--sessions", "2", "--spill-dir", "x"], "--spill-dir is the tier"),
    (["--spill-capacity-mb", "8"], "add --sessions N"),
    (["--sessions", "2", "--spill-capacity-mb", "8", "--spill-dir", "x"],
     None)])
def test_serve_spill_flags_validated_like_jax(flags, message, capsys):
    if message is None:
        args = serve.parse_args(flags)
        assert serve.tier_store(args).spill_dir.name == "x"
        return
    with pytest.raises(SystemExit) as e:
        serve.parse_args(flags)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the tiering paths' CPU runs are above)")


@pytest.mark.cuda
def test_cuda_snapshot_restore_paged_int8_bf16():
    """A bf16 tlin slot on paged_int8, admitted on the card: its snapshot
    restored into another slot snapshots bit-identically there, and
    equals the snapshot of the same state copied to the CPU."""
    _need_cuda()
    cfg = PC.reduced(PC.get_config("tconst_41m"), dtype="bfloat16",
                     attention_mode="tlin")
    params = build_model(cfg, device="cpu").init(0)
    dec = build_decode(cfg, _spec("paged_int8", None), device="cuda")
    st = dec.init_state(2, MAX_LEN)
    dec.prefill_into_slot(dec.prepare_params(params), st, 0,
                          _prompts(cfg.vocab_size, 3)[2])
    snap = st.snapshot_slot(0)
    cpu = DecodeState({f: v.cpu() for f, v in st.kv.items()},
                      {f: v.cpu() for f, v in st.bookkeeping.items()},
                      st.axes, {k: v.copy() for k, v in st.host.items()},
                      st.layout)
    host = {part: {f: to_host(v) for f, v in rows.items()}
            for part, rows in snap.items()}
    for part, rows in cpu.snapshot_slot(0).items():
        for f, v in rows.items():
            np.testing.assert_array_equal(to_host(v), host[part][f], f)
    st.restore_slot(1, {part: {f: to_device(v, "cuda")
                               for f, v in rows.items()}
                        for part, rows in host.items()})
    for part, rows in st.snapshot_slot(1).items():
        for f, v in rows.items():
            np.testing.assert_array_equal(to_host(v), host[part][f], f)
    assert st.host["gen_len"].tolist() == [st.host["gen_len"][0]] * 2


@pytest.mark.cuda
def test_cuda_tconst_store_hit_launches_no_kernel():
    """A TConst store hit on the card restores the admitted slot with no
    K1 or K2 launch and forwards 0 tokens; its first token is the cold
    admission's."""
    _need_cuda()
    cfg = PC.reduced(PC.get_config("tconst_41m"), dtype="bfloat16")
    params = build_model(cfg, device="cpu").init(0)
    prompt = _prompts(cfg.vocab_size, 4)[3]
    store = TierStore()

    def sched():
        return SlotScheduler(build_decode(cfg, device="cuda"), params,
                             slots=1, max_len=MAX_LEN, chunk_size=4,
                             tier_store=store)

    s1 = sched()
    a = s1.submit(Session(prompt.copy(), max_new_tokens=4))
    s1.admit_pending()
    s2 = sched()
    b = s2.submit(Session(prompt.copy(), max_new_tokens=4))
    runtime.reset_counters()
    s2.admit_pending()
    torch.cuda.synchronize()
    counts = runtime.read_counters()
    assert s2.admit_stats[0].source == "store"
    assert s2.admit_stats[0].forward_tokens == 0
    assert all(c["kernel"] == 0 and c["plain"] == 0
               for c in counts.values()), counts
    assert b.tokens == a.tokens
