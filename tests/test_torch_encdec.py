"""The port's encoder-decoder (whisper-small, reduced: 2 + 2 layers,
encoder_seq 16, frontend_dim 32) against the JAX package, on the CPU,
f32.  One JAX family for the file: ``init_encdec`` from PRNGKey 0,
carried across by ``bridge.encdec_params_from_jax`` (the ``sliding``
config shares its weights).

* ``layernorm``, ``gelu_mlp`` (tanh GELU, biases) and
  ``project_frontend`` at 1e-5; ``encode``, ``decode_train``,
  ``encdec_forward`` and ``encdec_prefill`` (logits and its four cache
  fields) at 1e-4.
* Decode steps on the four layouts in ``full`` and ``sliding`` mode
  (``tests/test_layout_native.py``'s ``encdec`` family): each step
  against the port's dense oracle (``encdec_decode_step``) on the same
  state's ``merged()`` at that test's tolerances (paged 2e-5, int8
  2e-2), the float layouts' logits against JAX's dense step at 1e-4.
* ``encdec_seed_cache`` and ``encdec_prefill_chunk`` chunk by chunk
  against JAX's; chunked admission token-identical to one-shot
  (``tests/test_prefill_chunked.py``'s ``encdec`` cases).
* Greedy ``SlotScheduler`` streams on the four layouts equal the JAX
  scheduler's (two JAX schedulers: dense for the float layouts,
  paged_int8 for the int8 ones), every session with its own audio, so a
  mix-up of slots' cross K/V shows; on the paged layouts an admission
  waits for pages.
* Spill / resume token-identical to never-spilled runs on the four
  layouts (``tests/test_tier_store.py``'s ``encdec`` cases); no store
  hit (a session with extras has no admission key).
* A session without ``audio_feats`` raises JAX's message; the bridge
  round-trips through ``params_to_jax``; ``input_specs`` equal JAX's;
  the ``serve`` Engine path on the CPU, and ``--sessions`` failing as
  JAX's launcher does.
* Training: the loss and every gradient leaf against
  ``jax.value_and_grad(api.loss)`` with seeded audio, ``full`` and
  ``sliding`` (1e-5 / 1e-4 of the leaf's max); one ``make_train_step``
  step at ``n_micro`` 2 against JAX's (eps 1e-5); the train launcher on
  the CPU, its checkpoint byte-equal to JAX's ``save_train_state`` of
  the same state, both ways; ``loss`` and ``launch.train.load`` take the
  family (K2's backward on the card: ``test_torch_flash_bwd.py``).
* ``cuda``-marked: each layout on the card against the CPU plain path,
  one-shot and chunked admission, launch counts (skipped without one).
"""
import functools

import numpy as np
import pytest
import torch

try:    # the GPU machine has no JAX: only the cuda test runs there
    import jax
    import jax.numpy as jnp
    from repro import config as JC
    from repro.layers import common as JCOM
    from repro.layers import embed as JE
    from repro.layers import mlp as JMLP
    from repro.models import api as JAPI
    from repro.models import encdec as JED
    from repro.models import layouts as JLT
    from repro.serving.scheduler import SlotScheduler as JScheduler
    from repro.serving.session import Session as JSession
    from torch_parity import (assert_loss_grads_match_jax,
                              assert_train_cli_checkpoint_equals_jax,
                              assert_train_step_matches_jax, jax_to_numpy,
                              port_cfg)
except ImportError:
    jax = None
from repro_torch import bridge, runtime
from repro_torch.config import get_config, get_shape, reduced
from repro_torch.launch import serve, train
from repro_torch.layers import common as PCOM
from repro_torch.layers import embed as PE
from repro_torch.layers import mlp as PMLP
from repro_torch.models import encdec as ED
from repro_torch.models import layouts as PLT
from repro_torch.models.api import AUDIO_MISSING, build_decode, build_model
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session
from repro_torch.serving.tier_store import TierStore

torch.set_num_threads(1)
LAYOUTS = ("dense", "int8", "paged", "paged_int8")
PAGE = 16
MAX_LEN = 64
STEPS = 8
PROMPT_LENS = (13, 9, 17, 11)
GEN = 10


def _need_jax():
    if jax is None:
        pytest.skip("the JAX references need JAX (absent on the GPU "
                    "machine)")


def t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def pair(mode: str = "full"):
    """(JAX cfg, JAX params, the port's cfg, its params) for reduced
    whisper-small in ``mode``; one JAX init for the file."""
    if mode != "full":
        jcfg, jparams, _, params = pair()
        jcfg = jcfg.replace(attention_mode=mode)
        return jcfg, jparams, port_cfg(jcfg), params
    jcfg = JC.reduced(JC.get_config("whisper_small"), dtype="float32")
    jparams = JED.init_encdec(jax.random.PRNGKey(0), jcfg)
    params = bridge.encdec_params_from_jax(jax_to_numpy(jparams))
    return jcfg, jparams, port_cfg(jcfg), params


def _audio(cfg, seed, n=None):
    shape = (cfg.encoder_seq, cfg.frontend_dim)
    return np.random.RandomState(100 + seed).randn(
        *(shape if n is None else (n,) + shape)).astype(np.float32)


def _prompts(cfg, lens=PROMPT_LENS, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _spec(kind, pool=None):
    return PLT.LayoutSpec(kind=kind, page_size=PAGE, pool_pages=pool)


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# layers and model functions against JAX
# ---------------------------------------------------------------------------


def test_layers_vs_jax():
    _need_jax()
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32) * 3 + 1
    ln = {"scale": rng.rand(64).astype(np.float32) + 0.5,
          "bias": rng.randn(64).astype(np.float32)}
    _close(PCOM.layernorm({k: t(v) for k, v in ln.items()}, t(x), 1e-5),
           JCOM.layernorm({k: jnp.asarray(v) for k, v in ln.items()},
                          jnp.asarray(x), 1e-5), 1e-5, "layernorm")
    ffn = {"w_in": rng.randn(64, 96).astype(np.float32) / 8,
           "b_in": rng.randn(96).astype(np.float32),
           "w_out": rng.randn(96, 64).astype(np.float32) / 10,
           "b_out": rng.randn(64).astype(np.float32)}
    _close(PMLP.gelu_mlp({k: t(v) for k, v in ffn.items()}, t(x)),
           JMLP.gelu_mlp({k: jnp.asarray(v) for k, v in ffn.items()},
                         jnp.asarray(x)), 1e-5, "gelu_mlp")
    feats = rng.randn(2, 7, 32).astype(np.float32)
    proj = rng.randn(32, 64).astype(np.float32) / 6
    _close(PE.project_frontend({"frontend_proj": t(proj)}, t(feats)),
           JE.project_frontend({"frontend_proj": jnp.asarray(proj)},
                               jnp.asarray(feats)), 1e-5, "project_frontend")


@pytest.mark.parametrize("part", ["encode", "decode_train", "forward",
                                  "prefill"])
def test_model_vs_jax(part):
    _need_jax()
    jcfg, jp, cfg, p = pair()
    audio = _audio(cfg, 0, n=2)
    toks = np.random.RandomState(1).randint(
        1, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    if part == "encode":
        _close(ED.encode(p, t(audio), cfg),
               JED.encode(jp, jnp.asarray(audio), jcfg), 1e-4)
    elif part == "decode_train":
        mem = JED.encode(jp, jnp.asarray(audio), jcfg)
        _close(ED.decode_train(p, t(toks), t(mem), cfg),
               JED.decode_train(jp, jnp.asarray(toks), mem, jcfg), 1e-4)
    elif part == "forward":
        pl, paux = ED.encdec_forward(p, t(toks), t(audio), cfg)
        jl, jaux = JED.encdec_forward(jp, jnp.asarray(toks),
                                      jnp.asarray(audio), jcfg)
        assert pl.dtype == torch.float32 and paux.item() == float(jaux) == 0
        _close(pl, jl, 1e-4)
    else:
        plg, pc = ED.encdec_prefill(p, t(toks), t(audio), cfg, 32)
        jlg, jc = JED.encdec_prefill(jp, jnp.asarray(toks),
                                     jnp.asarray(audio), jcfg, 32)
        _close(plg, jlg, 1e-4, "logits")
        assert sorted(pc) == sorted(jc)
        for f in ED.KV_KEYS:
            assert tuple(pc[f].shape) == jc[f].shape
            _close(pc[f], jc[f], 1e-4, f)
        assert pc["len"].tolist() == [13, 13]


# ---------------------------------------------------------------------------
# decode steps on the four layouts (full and sliding)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_steps(mode):
    """JAX's dense decode of two slots (prompts 13 and 9, each its own
    audio), 8 greedy steps: (prompts, audio, admission logits, per-step
    (fed tokens, logits))."""
    jcfg, jp, cfg, _ = pair(mode)
    prompts = _prompts(cfg, (13, 9), seed=4)
    audio = [_audio(cfg, s) for s in range(2)]
    jdec = JAPI.build_decode(jcfg)
    st = jdec.init_state(2, MAX_LEN)
    admit = []
    for slot, (pr, a) in enumerate(zip(prompts, audio)):
        lg, st = jdec.prefill_into_slot(jp, st, np.int32(slot),
                                        jnp.asarray(pr),
                                        extras={"audio_feats": a})
        admit.append(np.asarray(lg))
    step = jax.jit(jdec.step)
    token = np.array([3, 4], np.int32)
    steps = []
    for _ in range(STEPS):
        lg, st = step(jp, st, jnp.asarray(token))
        steps.append((token, np.asarray(lg)))
        token = np.asarray(lg).argmax(-1).astype(np.int32)
    return prompts, audio, admit, steps


@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("mode", ["full", "sliding"])
def test_decode_steps_on_layouts(mode, kind):
    """Each layout-native step against the dense oracle step run on the
    same state's ``merged()`` (paged 2e-5 and the same argmax; int8 2e-2:
    the new token's K/V is attended in its int8 rounding), and the float
    layouts' logits against JAX's dense step at 1e-4, fed JAX's greedy
    tokens.  Sliding: window 8 under prompts of 13 and 9 reaches K1's
    ``lo > 0`` and K3's ``window > 0``."""
    _need_jax()
    prompts, audio, admit, steps = _jax_steps(mode)
    _, _, cfg, params = pair(mode)
    dec = build_decode(cfg, _spec(kind), device="cpu")
    p = dec.prepare_params(params)
    st = dec.init_state(2, MAX_LEN)
    for slot, (pr, a) in enumerate(zip(prompts, audio)):
        lg, st = dec.prefill_into_slot(p, st, slot, pr,
                                       extras={"audio_feats": a})
        _close(lg, admit[slot], 1e-4, "admission")
    quant = "int8" in kind
    for i, (token, jlg) in enumerate(steps):
        ref = {k: v.clone() for k, v in st.merged().items()}
        olg, _ = ED.encdec_decode_step(p, ref, t(token), cfg)
        lg, st = dec.raw_step(p, st, t(token))
        _close(lg, olg, 2e-2 if quant else 2e-5, f"vs the oracle @{i}")
        if not quant:
            assert torch.equal(lg.argmax(-1), olg.argmax(-1))
            _close(lg, jlg, 1e-4, f"vs JAX @{i}")
    assert st.bookkeeping["len"].tolist() == [13 + STEPS, 9 + STEPS]


# ---------------------------------------------------------------------------
# chunked admission
# ---------------------------------------------------------------------------


def test_seed_and_prefill_chunk_vs_jax():
    """``encdec_seed_cache`` and three chunks of 4 of an 11-token prompt
    (the last zero-padded) against JAX's: logits, the row's K/V and the
    chunk K/V at 1e-4; the last real position's logits equal the
    one-shot prefill's."""
    _need_jax()
    jcfg, jp, cfg, p = pair()
    audio = _audio(cfg, 5, n=1)
    prompt = _prompts(cfg, (11,), seed=6)[0]
    jrow = JED.encdec_seed_cache(jp, jnp.asarray(audio), jcfg, 32)
    row = ED.encdec_seed_cache(p, t(audio), cfg, 32)
    assert sorted(row) == sorted(jrow)
    for f in ED.KV_KEYS:
        _close(row[f], jrow[f], 1e-4, f)
    buf = np.zeros((1, 12), np.int32)
    buf[0, :11] = prompt
    for start in (0, 4, 8):
        c = buf[:, start:start + 4]
        jl, jrow, jkv = JED.encdec_prefill_chunk(jp, jrow, jnp.asarray(c),
                                                 np.int32(start),
                                                 np.int32(11), jcfg)
        pl, row, kv = ED.encdec_prefill_chunk(p, row, t(c), start, 11, cfg)
        _close(pl, jl, 1e-4, f"logits @{start}")
        for f in ("k", "v"):
            _close(row[f], jrow[f], 1e-4, f"row {f} @{start}")
            _close(kv[f], jkv[f], 1e-4, f"chunk {f} @{start}")
    one, _ = ED.encdec_prefill(p, t(prompt[None]), t(audio), cfg, 32)
    _close(pl[0, 2], one[0], 1e-5, "chunked vs one-shot")


def _serve(cfg, params, prompts, audio, kind, *, slots=2, pool=None,
           prefill_chunk=None, stagger=True, gen=GEN, **kw):
    sched = SlotScheduler(build_decode(cfg, _spec(kind, pool), device="cpu"),
                          params, slots=slots, max_len=MAX_LEN, chunk_size=4,
                          prefill_chunk=prefill_chunk, **kw)
    sessions = []
    for pr, a in zip(prompts, audio):
        sessions.append(sched.submit(Session(
            pr, max_new_tokens=gen, extras={"audio_feats": a})))
        if stagger:
            sched.step()
    sched.run()
    return [s.tokens for s in sessions], sched, sessions


def _port():
    _, _, cfg, params = pair()
    return cfg, params, _prompts(cfg), [_audio(cfg, s)
                                        for s in range(len(PROMPT_LENS))]


@pytest.mark.parametrize("kind", ["dense", "paged", "paged_int8"])
def test_chunked_admission_token_identical(kind):
    _need_jax()
    cfg, params, prompts, audio = _port()
    ref, _, _ = _serve(cfg, params, prompts, audio, kind)
    got, sched, _ = _serve(cfg, params, prompts, audio, kind,
                           prefill_chunk=PAGE)
    assert got == ref
    fwd = [s.forward_tokens for s in sched.admit_stats]
    assert fwd == [-(-n // PAGE) * PAGE for n in PROMPT_LENS]


# ---------------------------------------------------------------------------
# scheduler streams, spill / resume
# ---------------------------------------------------------------------------


# the paged runs' pool: 3 pages of 16 for 2 slots x 4 pages, and every
# session needs 2 (prompt + gen + a chunk of headroom), so an admission
# waits for pages a finished session frees
POOL = 3


@functools.lru_cache(maxsize=None)
def _jax_scheduler_streams(kind):
    """JAX's scheduler on ``kind``: two slots, four staggered sessions,
    each with its own audio."""
    jcfg, jp, cfg, _ = pair()
    spec = None if kind == "dense" else JLT.LayoutSpec(
        kind=kind, page_size=PAGE, pool_pages=POOL)
    sched = JScheduler(JAPI.build_decode(jcfg, spec), jp, slots=2,
                       max_len=MAX_LEN, chunk_size=4)
    sessions = []
    for s, pr in enumerate(_prompts(cfg)):
        sessions.append(sched.submit(JSession(
            pr, max_new_tokens=GEN, extras={"audio_feats": _audio(cfg, s)})))
        sched.step()
    sched.run()
    return [s.tokens for s in sessions]


@pytest.mark.parametrize("kind", LAYOUTS)
def test_scheduler_streams_equal_jax(kind):
    """Two JAX schedulers, one of each numerics: dense (the float
    layouts' streams; paging is exact) and paged_int8 (the int8 layouts':
    the int8 rounding of K/V changes greedy streams)."""
    _need_jax()
    cfg, params, prompts, audio = _port()
    pool = POOL if kind.startswith("paged") else None
    got, sched, _ = _serve(cfg, params, prompts, audio, kind, pool=pool)
    assert got == _jax_scheduler_streams(
        "paged_int8" if "int8" in kind else "dense")
    # distinct audio matters: the same prompts over one shared audio
    # give other streams
    same, _, _ = _serve(cfg, params, prompts, [audio[0]] * len(audio), kind,
                        pool=pool)
    assert same != got
    if pool:
        assert sched.page_waits >= 1, "no admission waited for pages"
        assert sorted(sched.free_pages) == list(range(pool))


@pytest.mark.parametrize("kind", LAYOUTS)
def test_spill_resume_token_identical(kind):
    """4 sessions over 2 slots, a spill every chunk: the streams equal
    the never-spilled run's, every excess session completes a cycle, and
    no admission is a store hit."""
    _need_jax()
    cfg, params, prompts, audio = _port()
    sharing = kind.startswith("paged")
    ref, _, _ = _serve(cfg, params, prompts, audio, kind, slots=4,
                       stagger=False, gen=8, prefix_sharing=sharing)
    got, sched, sessions = _serve(
        cfg, params, prompts, audio, kind, slots=2, stagger=False, gen=8,
        prefix_sharing=sharing, tier_store=TierStore(capacity_bytes=1 << 30),
        preempt_chunks=1)
    assert got == ref
    assert sum(1 for s in sessions if s.resumes >= 1) >= 2
    assert sched.spill_stats["admit_store_hits"] == 0
    assert sched.spill_stats["admit_store_puts"] == 0


def test_session_without_audio_raises_jax_message():
    _need_jax()
    cfg, params, prompts, _ = _port()
    dec = build_decode(cfg, device="cpu")
    st = dec.init_state(1, MAX_LEN)
    with pytest.raises(ValueError) as err:
        dec.prefill_into_slot(params, st, 0, prompts[0])
    with pytest.raises(ValueError, match="audio_feats"):
        dec.prefill_into_slot_chunked(params, st, 0, prompts[0], chunk=PAGE)
    jcfg, jp, _, _ = pair()
    with pytest.raises(ValueError) as jerr:
        JAPI.build_decode(jcfg).prefill_into_slot(
            jp, JAPI.build_decode(jcfg).init_state(1, MAX_LEN), np.int32(0),
            jnp.asarray(prompts[0]))
    assert str(err.value) == str(jerr.value) == AUDIO_MISSING
    sched = SlotScheduler(dec, params, slots=1, max_len=MAX_LEN)
    sched.submit(Session(prompts[0], max_new_tokens=4))
    with pytest.raises(ValueError, match="audio_feats"):
        sched.run()


# ---------------------------------------------------------------------------
# bridge, facade, launchers
# ---------------------------------------------------------------------------


def test_bridge_round_trip():
    _need_jax()
    jcfg, jp, _, params = pair()
    tree = jax_to_numpy(jp)
    back = bridge.params_to_jax(params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    again = bridge.unstack_params(bridge.stack_params(params))
    assert len(again["enc_layers"]) == jcfg.encoder_layers
    assert len(again["dec_layers"]) == jcfg.n_layers
    torch.testing.assert_close(again["dec_layers"][1]["cross"]["wq"],
                               params["dec_layers"][1]["cross"]["wq"],
                               rtol=0, atol=0)


def test_input_specs_and_seeded_init_shapes():
    _need_jax()
    full = get_config("whisper_small")
    shape = get_shape("decode_32k")
    specs = build_model(full, device="cpu").input_specs(shape)
    jspecs = JAPI.build_model(JC.get_config("whisper_small")).input_specs(
        JC.get_shape("decode_32k"))
    assert sorted(specs) == sorted(jspecs) == ["audio_feats", "tokens"]
    for k, v in specs.items():
        assert tuple(v.shape) == jspecs[k].shape and v.is_meta
        assert str(v.dtype).rsplit(".", 1)[-1] == str(jspecs[k].dtype)
    jcfg, jp, cfg, params = pair()
    own = build_model(cfg, device="cpu").init(1)
    assert jax.tree_util.tree_structure(bridge.params_to_jax(own)) == \
        jax.tree_util.tree_structure(jax_to_numpy(jp))
    for a, b in zip(jax.tree_util.tree_leaves(bridge.params_to_jax(own)),
                    jax.tree_util.tree_leaves(jax_to_numpy(jp))):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_trains_through_loss_and_the_launcher():
    """``ModelAPI.loss`` takes the enc-dec's batch and ``launch.train.load``
    the arch: its params in JAX's tree layout (the encoder's and the
    decoder's layers stacked on a leading axis), a finite loss whose
    gradient reaches the encoder."""
    args = train.build_parser().parse_args(
        ["--arch", "whisper_small", "--reduced", "--device", "cpu"])
    cfg, api, params = train.load(args)
    assert params["enc_layers"]["attn"]["wq"].shape == (
        cfg.encoder_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim)
    assert params["dec_layers"]["cross"]["wk"].shape[0] == cfg.n_layers
    batch = {"tokens": torch.ones((1, 4), dtype=torch.int32),
             **train.extra_inputs(cfg, 1, 4, "cpu")}
    assert sorted(batch) == ["audio_feats", "tokens"]
    assert batch["audio_feats"].shape == (1, cfg.encoder_seq,
                                          cfg.frontend_dim)
    live = bridge.unstack_params(params)
    w = live["enc_layers"][0]["attn"]["wq"].requires_grad_(True)
    loss, parts = api.loss(live, batch)
    assert torch.isfinite(loss) and float(parts["aux"]) == 0.0
    (g,) = torch.autograd.grad(loss, [w])
    assert bool(g.abs().sum() > 0)


def _train_batch(cfg, B, L, seed):
    rs = np.random.RandomState(seed)
    return {"tokens": rs.randint(0, cfg.vocab_size,
                                 size=(B, L)).astype(np.int32),
            "audio_feats": _audio(cfg, seed, n=B)}


@pytest.mark.parametrize("mode", ["full", "sliding"])
def test_loss_and_gradients_match_jax(mode):
    """Reduced whisper (``sliding``: window 8 on the decoder's
    self-attention, 20 tokens) with seeded audio."""
    _need_jax()
    jcfg, jp, cfg, p = pair(mode)
    assert_loss_grads_match_jax(JAPI.build_model(jcfg), jp,
                                build_model(cfg, device="cpu"), p,
                                _train_batch(cfg, 2, 20, 5), mode)


def test_train_step_n_micro_2_matches_jax():
    _need_jax()
    jcfg, jp, cfg, p = pair()
    assert_train_step_matches_jax(JAPI.build_model(jcfg), jp,
                                  build_model(cfg, device="cpu"), p,
                                  _train_batch(cfg, 4, 12, 6), "whisper")


def test_train_cli_checkpoint_equals_jax(tmp_path, capsys):
    _need_jax()
    assert_train_cli_checkpoint_equals_jax("whisper_small", pair()[1],
                                           tmp_path, capsys)


def test_serve_engine_cli_on_cpu(capsys):
    """The uniform-batch Engine path puts zero audio frames into the
    batch, as JAX's launcher does; the paged layouts page the decoder's
    K/V (no inert-pages note)."""
    argv = ["--arch", "whisper_small", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "6"]
    assert serve.main(argv) == 0
    assert serve.main(argv + ["--layout", "paged_int8",
                              "--page-size", "16"]) == 0
    out = capsys.readouterr().out
    assert out.count("generated (2, 6)") == 2
    assert "cache-hit steps: n=" in out and "resync" not in out
    assert "stores nothing in pages" not in out


def test_serve_sessions_cli_fails_as_jax_does():
    """JAX's ``run_sessions`` submits sessions without extras, so its
    ``--sessions`` run of an enc-dec raises; so does the port's."""
    with pytest.raises(ValueError, match="audio_feats"):
        serve.main(["--arch", "whisper_small", "--reduced", "--device",
                    "cpu", "--sessions", "2", "--slots", "2", "--gen", "4"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_encdec_layouts_vs_plain():
    """Reduced whisper (f32, the port's seeded init) on each layout: two
    admissions (one-shot, then chunked) and 8 steps on the card against
    the CPU plain path fed the same tokens, logits within 1e-3; the card
    ran K2 for every encoder layer, decoder self- and cross-attention,
    and a step's self- and cross-attention on the layout's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (their plain versions are tested above)")
    cfg = reduced(get_config("whisper_small"), dtype="float32")
    n_enc, n_dec = cfg.encoder_layers, cfg.n_layers
    params = ED.init_encdec(cfg, 0)
    kernels = {"dense": ("decode_attention", "decode_attention"),
               "int8": ("decode_attention_int8", "decode_attention_int8"),
               "paged": ("paged_decode_attention", "decode_attention"),
               "paged_int8": ("paged_decode_attention_int8",
                              "decode_attention_int8")}
    prompts = [np.random.RandomState(s).randint(1, cfg.vocab_size, size=n)
               for s, n in ((0, 37), (1, 70))]
    audio = [_audio(cfg, s) for s in range(2)]
    for kind in LAYOUTS:
        decs = {d: build_decode(cfg, _spec(kind), device=d)
                for d in ("cpu", "cuda")}
        ps = {d: dec.prepare_params(params) for d, dec in decs.items()}
        sts = {d: dec.init_state(2, 128) for d, dec in decs.items()}
        runtime.reset_counters()
        for slot, (pr, a) in enumerate(zip(prompts, audio)):
            ex = {"audio_feats": a}
            if slot == 0:
                lg = {d: dec.prefill_into_slot(ps[d], sts[d], slot, pr,
                                               extras=ex)[0]
                      for d, dec in decs.items()}
            else:
                lg = {d: dec.prefill_into_slot_chunked(
                    ps[d], sts[d], slot, pr, extras=ex, chunk=32)[0]
                    for d, dec in decs.items()}
            assert (lg["cuda"].cpu() - lg["cpu"]).abs().max() < 1e-3, kind
        token = torch.tensor([3, 4], dtype=torch.int32)
        for _ in range(STEPS):
            lg = {d: dec.raw_step(ps[d], sts[d], token.to(d))[0]
                  for d, dec in decs.items()}
            torch.cuda.synchronize()
            err = (lg["cuda"].cpu() - lg["cpu"]).abs().max().item()
            assert err < 1e-3, (kind, err)
            token = lg["cpu"].argmax(-1).to(torch.int32)
        counts = runtime.read_counters()
        chunks = -(-len(prompts[1]) // 32)
        # one-shot: encoder + self + cross; chunked: encoder + (self +
        # cross) per chunk
        assert counts["flash_attention"]["kernel"] == \
            2 * n_enc + 2 * n_dec + 2 * n_dec * chunks, kind
        self_k, cross_k = kernels[kind]
        want = {self_k: STEPS * n_dec}
        want[cross_k] = want.get(cross_k, 0) + STEPS * n_dec
        for name, n in want.items():
            assert counts[name]["kernel"] == n, (kind, name, counts)
