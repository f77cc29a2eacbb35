"""The port's VLM family (qwen2-vl-2b, reduced: 2 layers, d 128, 4 query
heads over 1 KV head of 32 -- G 4 --, M-RoPE sections 8 / 4 / 4, the
stub vision encoder's 8 patches of 32) against the JAX package, on the
CPU, f32.  One JAX family for the file: ``init_lm`` from PRNGKey 0,
carried across by ``bridge.lm_params_from_jax``.

* ``mrope_cos_sin`` with three distinct position streams, and
  ``text_positions3`` (equal streams: plain RoPE), at 1e-6.
* ``embed_inputs`` with a vision mask (patches scattered in order, the
  positions past the last patch taking it) at 1e-5.
* ``lm_forward`` with vision inputs and distinct ``positions3``, and
  ``lm_prefill`` with vision inputs, at 1e-4.
* A vision admission and a text-only one, then 8 decode steps on each of
  the four layouts against JAX's ``DenseDecode`` at 1e-4 (int8: JAX's
  stored codes adopted where an f32 rounding flips one).
* A vision session is admitted one-shot under ``--prefill-chunk``, a
  text-only one in chunks (``tests/test_prefill_chunked.py:370-392``).
* Two sessions with equal prompts and different images never share a
  page; with the same image they do.
* Greedy ``SlotScheduler`` streams with per-session vision inputs equal
  the JAX scheduler's.
* ``input_specs`` equal JAX's; the ``serve`` Engine and sessions paths
  on the CPU.
* Training: the loss and every gradient leaf against
  ``jax.value_and_grad(api.loss)`` with seeded patches over a marked
  span (1e-5 / 1e-4 of the leaf's max); one ``make_train_step`` step at
  ``n_micro`` 2 against JAX's (eps 1e-5); the train launcher on the CPU,
  its checkpoint byte-equal to JAX's ``save_train_state`` of the same
  state, both ways; ``loss`` and ``launch.train.load`` take the VLM.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from parity import make_prompts
from repro import config as JC
from repro.layers import rope as JR
from repro.models import api as JAPI
from repro.models import layouts as JLT
from repro.models import lm as JLM
from repro.serving.scheduler import SlotScheduler as JScheduler
from repro.serving.session import Session as JSession
from repro_torch import bridge
from repro_torch.config import get_shape
from repro_torch.launch import serve, train
from repro_torch.layers import rope as PR
from repro_torch.models import layouts as PLT
from repro_torch.models import lm as LM
from repro_torch.models.api import build_decode, build_model
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session
from test_torch_lm import _adopt_jax_codes, _code_flips
from torch_parity import (assert_loss_grads_match_jax,
                          assert_train_cli_checkpoint_equals_jax,
                          assert_train_step_matches_jax, jax_to_numpy,
                          port_cfg, t)

torch.set_num_threads(1)
LAYOUTS = ("dense", "int8", "paged", "paged_int8")
MAX_LEN = 64
CHUNK = 16


@functools.lru_cache(maxsize=None)
def pair():
    """(JAX cfg, JAX params, the port's cfg, its params) for reduced
    qwen2-vl-2b in f32; one JAX init for the file."""
    jcfg = JC.reduced(JC.get_config("qwen2_vl_2b"), dtype="float32")
    jparams = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.lm_params_from_jax(jax_to_numpy(jparams))
    return jcfg, jparams, port_cfg(jcfg), params


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=what)


def _vision(cfg, seed, L, offset=2):
    """One request's seeded patches and a mask over ``frontend_tokens``
    prompt positions from ``offset``."""
    rng = np.random.RandomState(200 + seed)
    emb = rng.randn(cfg.frontend_tokens, cfg.frontend_dim).astype(
        np.float32)
    mask = np.zeros((L,), bool)
    mask[offset:offset + cfg.frontend_tokens] = True
    return {"vision_embeds": emb, "vision_mask": mask}


def _positions3(B, L, seed=0):
    """Distinct temporal / height / width streams (a 2-D patch grid in
    the middle of a text prompt)."""
    rng = np.random.RandomState(seed)
    base = np.arange(L)
    p3 = np.stack([base, base + rng.randint(0, 3, L),
                   base - rng.randint(0, 3, L)])
    return np.broadcast_to(p3[:, None], (3, B, L)).astype(np.int32).copy()


def test_mrope_vs_jax():
    jcfg, _, cfg, _ = pair()
    hd = cfg.resolved_head_dim
    p3 = _positions3(2, 11)
    jc, js = JR.mrope_cos_sin(jnp.asarray(p3), hd, cfg.rope_theta,
                              jcfg.mrope_sections)
    pc, ps = PR.mrope_cos_sin(t(p3), hd, cfg.rope_theta,
                              cfg.mrope_sections)
    assert tuple(pc.shape) == jc.shape == (2, 11, hd // 2)
    _close(pc, jc, 1e-6, "cos")
    _close(ps, js, 1e-6, "sin")
    pos = np.arange(11, dtype=np.int32)[None].repeat(2, 0)
    jt = JR.text_positions3(jnp.asarray(pos))
    pt = PR.text_positions3(t(pos))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    tc, ts = PR.mrope_cos_sin(pt, hd, cfg.rope_theta, cfg.mrope_sections)
    rc, rs = PR.rope_cos_sin(t(pos), hd, cfg.rope_theta)
    _close(tc, rc, 1e-6, "text cos")
    _close(ts, rs, 1e-6, "text sin")
    with pytest.raises(ValueError, match="sum"):
        PR.mrope_cos_sin(t(p3), hd, cfg.rope_theta, (8, 4, 2))


def test_embed_inputs_vs_jax():
    jcfg, jparams, cfg, params = pair()
    toks = make_prompts(cfg, (13, 13), seed=1)
    v = [_vision(cfg, i, 13, offset=1 + 3 * i) for i in range(2)]
    emb = np.stack([x["vision_embeds"] for x in v])
    mask = np.stack([x["vision_mask"] for x in v])
    mask[1, 12] = True            # past the last patch: takes patch Tv - 1
    want = JLM.embed_inputs(jparams, jnp.asarray(np.stack(toks)), jcfg,
                            jnp.asarray(emb), jnp.asarray(mask))
    got = LM.embed_inputs(params, t(np.stack(toks)), cfg, t(emb), t(mask))
    _close(got, want, 1e-5, "embed_inputs")
    plain = LM.embed_inputs(params, t(np.stack(toks)), cfg)
    _close(got[~t(mask)], plain[~t(mask)], 0.0, "text positions")


def test_forward_and_prefill_with_vision_vs_jax():
    jcfg, jparams, cfg, params = pair()
    toks = np.stack(make_prompts(cfg, (21, 21), seed=2))
    v = [_vision(cfg, i, 21) for i in range(2)]
    emb = np.stack([x["vision_embeds"] for x in v])
    mask = np.stack([x["vision_mask"] for x in v])
    p3 = _positions3(2, 21)
    jl, _ = JLM.lm_forward(jparams, jnp.asarray(toks), jcfg,
                           positions3=jnp.asarray(p3),
                           vision_embeds=jnp.asarray(emb),
                           vision_mask=jnp.asarray(mask), remat=False)
    pl, _ = LM.lm_forward(params, t(toks), cfg, positions3=t(p3),
                          vision_embeds=t(emb), vision_mask=t(mask))
    _close(pl, jl, 1e-4, "lm_forward")
    # ModelAPI.forward reads what JAX's reads: no positions3
    api = build_model(cfg, device="cpu")
    fl, _ = api.forward(params, {"tokens": t(toks), "positions3": t(p3),
                                 "vision_embeds": emb, "vision_mask": mask})
    tl, _ = LM.lm_forward(params, t(toks), cfg, vision_embeds=t(emb),
                          vision_mask=t(mask))
    _close(fl, tl, 0.0, "ModelAPI.forward")
    jlg, jc = JLM.lm_prefill(jparams, jnp.asarray(toks), jcfg, 32,
                             vision_embeds=jnp.asarray(emb),
                             vision_mask=jnp.asarray(mask))
    plg, pc = LM.lm_prefill(params, t(toks), cfg, 32, vision_embeds=t(emb),
                            vision_mask=t(mask))
    _close(plg, jlg, 1e-4, "prefill logits")
    for f in ("k", "v"):
        _close(pc[f], jc[f], 1e-4, f)


@pytest.mark.parametrize("kind", LAYOUTS)
def test_decode_vs_jax(kind):
    """Slot 0 admitted with its vision inputs, slot 1 text-only, then 8
    steps on one layout against JAX's."""
    jcfg, jparams, cfg, params = pair()
    spec = dict(kind=kind, page_size=16)
    jdec = JAPI.build_decode(jcfg, JLT.LayoutSpec(**spec))
    pdec = build_decode(cfg, PLT.LayoutSpec(**spec), device="cpu")
    jst, pst = jdec.init_state(2, MAX_LEN), pdec.init_state(2, MAX_LEN)
    prompts = make_prompts(jcfg, (13, 9), seed=4)
    for slot, p in enumerate(prompts):
        extras = _vision(cfg, slot, len(p)) if slot == 0 else None
        jlg, jst = jdec.prefill_into_slot(
            jparams, jst, np.int32(slot), jnp.asarray(p),
            extras=None if extras is None else
            {k: jnp.asarray(x) for k, x in extras.items()})
        plg, pst = pdec.prefill_into_slot(params, pst, slot, p,
                                          extras=extras)
        _close(plg, jlg, 1e-4, f"admission of slot {slot}")
    if "int8" in kind:
        _adopt_jax_codes(pst, jst)
    step = jax.jit(jdec.step)
    token = np.array([3, 4], np.int32)
    for i in range(8):
        jlg, jst = step(jparams, jst, jnp.asarray(token))
        plg, pst = pdec.raw_step(params, pst, t(token))
        _close(plg, jlg, 1e-4, f"step {i}")
        if "int8" in kind and _code_flips(pst, jst):
            _adopt_jax_codes(pst, jst, scale_rtol=1e-4)
        token = np.asarray(jlg).argmax(-1).astype(np.int32)
    assert pst.bookkeeping["len"].tolist() == [21, 17]
    if "int8" not in kind:
        jm, pm = jst.merged(), pst.merged()
        for f in ("k", "v"):
            _close(pm[f], jm[f], 1e-4, f)


def test_vision_admission_falls_back_to_one_shot():
    """Under a prefill chunk a vision session is admitted one-shot (its
    whole prompt, unpadded) and a text-only one in chunks."""
    _, _, cfg, params = pair()
    dec = build_decode(cfg, device="cpu", prefill_chunk=CHUNK)
    extras = _vision(cfg, 0, 24, offset=0)
    assert not dec.supports_chunked_prefill(extras)
    assert dec.supports_chunked_prefill(None)
    sched = SlotScheduler(dec, params, slots=1, max_len=80, chunk_size=4)
    s = sched.submit(Session(np.arange(1, 25, dtype=np.int32),
                             max_new_tokens=5, extras=extras))
    s2 = sched.submit(Session(np.arange(1, 25, dtype=np.int32),
                              max_new_tokens=5))
    sched.run()
    assert s.done and len(s.tokens) == 5 and len(s2.tokens) == 5
    assert [a.forward_tokens for a in sched.admit_stats] == [24, 32]
    assert s.tokens != s2.tokens     # the image changed the stream


def test_different_images_never_share_pages():
    _, _, cfg, params = pair()
    (p,) = make_prompts(cfg, (40,), seed=6)
    spec = PLT.LayoutSpec(kind="paged", page_size=16)

    def admit(images):
        sched = SlotScheduler(build_decode(cfg, spec, device="cpu"), params,
                              slots=2, max_len=128, chunk_size=4,
                              prefix_sharing=True)
        ss = [sched.submit(Session(p, max_new_tokens=4,
                                   extras=_vision(cfg, i, 40)))
              for i in images]
        sched.admit_pending()
        shared = int((sched.page_refcounts() > 1).sum())
        sched.run()
        return shared, [s.tokens for s in ss]

    shared, streams = admit([0, 1])
    assert shared == 0
    same, twins = admit([0, 0])
    assert same == 2 and twins[0] == twins[1] == streams[0]


def test_scheduler_streams_with_vision_equal_jax_scheduler():
    jcfg, jparams, cfg, params = pair()
    prompts = make_prompts(jcfg, (21, 34, 17, 25))
    # sessions 0-2 carry their own image, session 3 is text-only
    extras = [_vision(cfg, i, len(p)) if i < 3 else None
              for i, p in enumerate(prompts)]

    def run(sched, session_cls):
        ss = []
        for p, e in zip(prompts, extras):
            ss.append(sched.submit(session_cls(p, max_new_tokens=10,
                                               extras=e)))
            sched.step()
        sched.run()
        return [list(s.tokens) for s in ss]

    ref = run(JScheduler(JAPI.build_decode(jcfg), jparams, slots=2,
                         max_len=128, chunk_size=4), JSession)
    got = run(SlotScheduler(build_decode(cfg, device="cpu"), params,
                            slots=2, max_len=128, chunk_size=4), Session)
    assert got == ref


def test_input_specs_equal_jax_and_the_vlm_trains():
    """``input_specs`` equal JAX's; ``launch.train.load`` takes the arch
    and its batch (JAX launcher's: zero patches over the first Tv
    positions) gives ``ModelAPI.loss`` a finite loss; ``train`` uses the
    patches a batch of its data carries."""
    jcfg, _, cfg, params = pair()
    api = build_model(cfg, device="cpu")
    shape = get_shape("train_4k")
    want = JAPI.build_model(jcfg).input_specs(shape)
    got = api.input_specs(shape)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
    args = train.build_parser().parse_args(
        ["--arch", "qwen2_vl_2b", "--reduced", "--device", "cpu"])
    tcfg, tapi, tparams = train.load(args)
    extra = train.extra_inputs(tcfg, 2, 12, "cpu")
    assert extra["vision_embeds"].shape == (2, tcfg.frontend_tokens,
                                            tcfg.frontend_dim)
    assert extra["vision_embeds"].dtype == getattr(torch, tcfg.dtype)
    assert extra["vision_mask"].sum(1).tolist() == [tcfg.frontend_tokens] * 2
    assert bool(extra["vision_mask"][:, :tcfg.frontend_tokens].all())
    toks = torch.ones((2, 12), dtype=torch.int32)
    zero_loss, _ = tapi.loss(bridge.unstack_params(tparams),
                             {"tokens": toks, **extra})
    assert torch.isfinite(zero_loss)
    # patches a batch of ``data`` carries are used as given
    v = _train_batch(tcfg, 2, 12, 7)
    want, _ = tapi.loss(bridge.unstack_params(tparams),
                        {"tokens": toks, **{k: t(v[k]) for k in (
                            "vision_embeds", "vision_mask")}})
    args.steps, args.batch, args.seq = 1, 2, 12
    got = train.train(tcfg, tapi, tparams, args,
                      data=[{"tokens": toks.numpy(),
                             "vision_embeds": v["vision_embeds"],
                             "vision_mask": v["vision_mask"]}],
                      log=lambda _: None)["losses"]
    assert got == [float(want)] and float(want) != float(zero_loss)


def _train_batch(cfg, B, L, seed):
    """Seeded tokens and, for each row, seeded patches over a marked span
    of ``frontend_tokens`` positions from ``1 + 2 * row``."""
    rs = np.random.RandomState(seed)
    v = [_vision(cfg, seed + i, L, offset=1 + 2 * i) for i in range(B)]
    return {"tokens": rs.randint(0, cfg.vocab_size,
                                 size=(B, L)).astype(np.int32),
            "vision_embeds": np.stack([x["vision_embeds"] for x in v]),
            "vision_mask": np.stack([x["vision_mask"] for x in v])}


def test_loss_and_gradients_match_jax():
    jcfg, jparams, cfg, params = pair()
    batch = _train_batch(cfg, 2, 20, 5)
    assert_loss_grads_match_jax(JAPI.build_model(jcfg), jparams,
                                build_model(cfg, device="cpu"), params,
                                batch, "qwen2-vl")


def test_train_step_n_micro_2_matches_jax():
    jcfg, jparams, cfg, params = pair()
    assert_train_step_matches_jax(JAPI.build_model(jcfg), jparams,
                                  build_model(cfg, device="cpu"), params,
                                  _train_batch(cfg, 4, 16, 6), "qwen2-vl")


def test_train_cli_checkpoint_equals_jax(tmp_path, capsys):
    assert_train_cli_checkpoint_equals_jax("qwen2_vl_2b", pair()[1],
                                           tmp_path, capsys)


def test_serve_engine_and_sessions_on_the_cpu():
    """The Engine path with zero patches over the first Tv positions (JAX
    launcher's batch), and the sessions demo, each session with its own
    seeded patches, against its solo run."""
    args = serve.parse_args(["--arch", "qwen2_vl_2b", "--reduced",
                             "--batch", "2", "--prompt-len", "12", "--gen",
                             "4", "--device", "cpu"])
    cfg, api, params = serve.load(args)
    rep = serve.run_batch(cfg, api, params, args)
    assert rep["tokens"].shape == (2, 4)
    args = serve.parse_args(["--arch", "qwen2_vl_2b", "--reduced",
                             "--sessions", "3", "--slots", "2", "--gen", "6",
                             "--prompt-len", "12", "--device", "cpu"])
    served = serve.serve_sessions(cfg, api, params, args)
    ex = [s.extras for s in served["sessions"]]
    assert all(e["vision_mask"][:cfg.frontend_tokens].all() for e in ex)
    assert not np.array_equal(ex[0]["vision_embeds"], ex[1]["vision_embeds"])
    assert serve.check_sessions(api, params, served, args)["rc"] == 0
