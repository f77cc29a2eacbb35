"""The port's hybrid family (hymba-1.5b, reduced: 2 layers, d 128, 4
query heads over 1 KV head of 32 -- G 4 --, window 8, parallel mamba2
heads of 16 with state 16, chunk 8) against the JAX package, on the CPU,
f32.  One JAX family for the file: ``init_lm`` from PRNGKey 0, carried
across by ``bridge.lm_params_from_jax``.

* ``lm_forward`` (21 tokens: past the window) and ``lm_prefill`` (logits
  and its four cache fields) at 1e-4.
* Two slots admitted past the window of 8 (prompts of 13 and 9), then 8
  decode steps on each of the four layouts against JAX's
  ``DenseDecode`` on the same layout at 1e-4 (int8: JAX's stored codes
  adopted where an f32 rounding flips one, as ``test_torch_lm.py``
  does); the ``ssm`` / ``conv`` state stays dense on every layout.
* ``lm_prefill_chunk`` chunk by chunk against JAX's (logits, the row's
  K/V and recurrent state), the last chunk zero-padded: its padding must
  not advance ``ssm`` / ``conv`` (the state after it equals the one-shot
  prefill's); chunked admission token-identical to one-shot
  (``tests/test_prefill_chunked.py:309-323``).
* A sharing admission adopts the shared pages but forwards from 0, its
  stream equal to its solo run (``tests/test_prefill_chunked.py:
  346-367``).
* Greedy ``SlotScheduler`` streams equal the JAX scheduler's on dense and
  paged_int8 (an under-sized pool: an admission waits for pages).
* The bridge round-trips a layer holding ``attn`` and ``ssm``
  (``stack_params`` / ``unstack_params`` / ``params_to_jax``); the loss
  and every gradient leaf against ``jax.value_and_grad`` (past the
  window), and the train launcher on the CPU; the ``serve`` demo on the
  CPU.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from parity import make_prompts, serve_streams, shared_prompts
from repro import config as JC
from repro.models import api as JAPI
from repro.models import layouts as JLT
from repro.models import lm as JLM
from repro_torch import bridge
from repro_torch.launch import serve, train
from repro_torch.models import layouts as PLT
from repro_torch.models import lm as LM
from repro_torch.models.api import build_decode, build_model
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session
from test_torch_lm import _adopt_jax_codes, _code_flips
from torch_parity import (assert_loss_grads_match_jax, jax_to_numpy,
                          port_cfg, port_streams, t)

torch.set_num_threads(1)
LAYOUTS = ("dense", "int8", "paged", "paged_int8")
MAX_LEN = 64
CHUNK = 16


@functools.lru_cache(maxsize=None)
def pair():
    """(JAX cfg, JAX params, the port's cfg, its params) for reduced
    hymba-1.5b in f32; one JAX init for the file."""
    jcfg = JC.reduced(JC.get_config("hymba_1_5b"), dtype="float32")
    jparams = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.lm_params_from_jax(jax_to_numpy(jparams))
    return jcfg, jparams, port_cfg(jcfg), params


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=what)


def test_reduced_config_is_the_hybrid():
    jcfg, _, cfg, params = pair()
    assert cfg.hybrid_parallel and cfg.q_per_kv == 4
    assert LM.layer_windows(cfg) == [8, 8]
    assert sorted(params["layers"][0]) == ["attn", "ffn", "ln1", "ln2",
                                           "ssm"]
    cache = LM.init_kv_cache(cfg, 2, MAX_LEN)
    jc = JLM.init_kv_cache(jcfg, 2, MAX_LEN)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jc.items()}


def test_forward_and_prefill_vs_jax():
    jcfg, jparams, cfg, params = pair()
    toks = np.random.RandomState(1).randint(
        1, cfg.vocab_size, size=(2, 21)).astype(np.int32)
    jl, _ = JLM.lm_forward(jparams, jnp.asarray(toks), jcfg, remat=False)
    pl, aux = LM.lm_forward(params, t(toks), cfg)
    _close(pl, jl, 1e-4, "lm_forward")
    assert aux.item() == 0.0
    jlg, jc = JLM.lm_prefill(jparams, jnp.asarray(toks[:, :13]), jcfg, 32)
    plg, pc = LM.lm_prefill(params, t(toks[:, :13]), cfg, 32)
    _close(plg, jlg, 1e-4, "prefill logits")
    assert sorted(pc) == sorted(jc) == ["conv", "done", "k", "len", "ssm",
                                        "v"]
    for f in ("k", "v", "ssm", "conv"):
        _close(pc[f], jc[f], 1e-4, f)
    assert pc["len"].tolist() == [13, 13]


@pytest.mark.parametrize("kind", LAYOUTS)
def test_decode_past_the_window_vs_jax(kind):
    """Prompts of 13 and 9 and 8 steps under a window of 8: K1's ``lo >
    0`` and K3's ``window > 0`` paths, beside the recurrent step."""
    jcfg, jparams, cfg, params = pair()
    spec = dict(kind=kind, page_size=16)
    jdec = JAPI.build_decode(jcfg, JLT.LayoutSpec(**spec))
    pdec = build_decode(cfg, PLT.LayoutSpec(**spec), device="cpu")
    jst, pst = jdec.init_state(2, MAX_LEN), pdec.init_state(2, MAX_LEN)
    for slot, p in enumerate(make_prompts(jcfg, (13, 9), seed=4)):
        jlg, jst = jdec.prefill_into_slot(jparams, jst, np.int32(slot),
                                          jnp.asarray(p))
        plg, pst = pdec.prefill_into_slot(params, pst, slot, p)
        _close(plg, jlg, 1e-4, f"admission of slot {slot}")
    for f in ("ssm", "conv"):      # dense on every layout
        assert pst.kv[f].dtype == torch.float32
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
    jm, pm = jst.merged(), pst.merged()
    assert pm["len"].tolist() == [21, 17]
    for f in ("ssm", "conv"):
        _close(pm[f], jm[f], 1e-4, f)
    if "int8" not in kind:
        for f in ("k", "v"):
            _close(pm[f], jm[f], 1e-4, f)


def test_prefill_chunk_vs_jax_padding_keeps_the_state():
    """A 37-token prompt in chunks of 16 (the last holds 5 real tokens):
    every chunk's logits, the row's K/V and recurrent state equal JAX's;
    after the padded chunk ``ssm`` / ``conv`` equal the one-shot
    prefill's, so the padding advanced nothing."""
    jcfg, jparams, cfg, params = pair()
    (p,) = make_prompts(jcfg, (37,), seed=5)
    buf = np.zeros((1, 48), np.int32)
    buf[0, :37] = p
    jrow = JLM.init_kv_cache(jcfg, 1, MAX_LEN)
    prow = LM.init_kv_cache(cfg, 1, MAX_LEN)
    for start in range(0, 48, CHUNK):
        toks = buf[:, start:start + CHUNK]
        jlg, jrow, jkv = JLM.lm_prefill_chunk(
            jparams, jrow, jnp.asarray(toks), jnp.int32(start),
            jnp.int32(37), jcfg)
        plg, prow, pkv = LM.lm_prefill_chunk(params, prow, t(toks), start,
                                             37, cfg)
        _close(plg, jlg, 1e-4, f"chunk at {start}")
        for f in ("k", "v"):
            _close(pkv[f], jkv[f], 1e-4, f"chunk K/V {f} at {start}")
        for f in ("ssm", "conv"):
            _close(prow[f], jrow[f], 1e-4, f"row {f} at {start}")
    _, one = LM.lm_prefill(params, t(p[None]), cfg, MAX_LEN)
    for f in ("ssm", "conv"):
        _close(prow[f], one[f], 1e-5, f"{f} after the padded chunk")
    for f in ("k", "v"):
        _close(prow[f][:, :, :37], one[f][:, :, :37], 1e-5, f)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_chunked_admission_equals_one_shot(kind):
    _, _, cfg, params = pair()
    prompts = make_prompts(cfg, (19, 33), seed=2)
    spec = PLT.LayoutSpec(kind=kind, page_size=16)

    def run(chunk):
        sched = SlotScheduler(build_decode(cfg, spec, device="cpu"),
                              params, slots=2, max_len=128, chunk_size=4,
                              prefill_chunk=chunk)
        ss = []
        for p in prompts:
            ss.append(sched.submit(Session(p, max_new_tokens=5)))
            sched.step()
        sched.run()
        return [s.tokens for s in ss], sched

    ref, _ = run(None)
    got, sched = run(CHUNK)
    assert got == ref
    assert [a.forward_tokens for a in sched.admit_stats] == [32, 48]


def test_sharing_admission_forwards_from_zero():
    """The ssm / conv state is a function of the whole prompt: a hybrid
    sharer adopts the shared pages (their writes go to TRASH) but
    forwards from position 0, and its stream equals its solo run."""
    _, _, cfg, params = pair()
    prompts = shared_prompts(cfg, 2, common_len=32, seed=7)   # 40 tokens
    spec = PLT.LayoutSpec(kind="paged", page_size=16)
    sched = SlotScheduler(build_decode(cfg, spec, device="cpu"), params,
                          slots=2, max_len=128, chunk_size=4,
                          prefix_sharing=True, prefill_chunk=CHUNK)
    ss = [sched.submit(Session(p, max_new_tokens=6)) for p in prompts]
    sched.admit_pending()
    assert (sched.page_refcounts() > 1).sum() == 2     # pages adopted
    fwd = [a.forward_tokens for a in sched.admit_stats]
    assert fwd[1] >= len(prompts[1]) and fwd == [48, 48]
    sched.run()
    for s, p in zip(ss, prompts):
        solo, _ = port_streams(cfg, params, [p], spec, gen=6,
                               stagger=False)
        assert s.tokens == solo[0], "sharing corrupted the ssm state"


@pytest.mark.parametrize("kind,pool", [("dense", None), ("paged_int8", 7)])
def test_scheduler_streams_equal_jax_scheduler(kind, pool):
    jcfg, jparams, cfg, params = pair()
    prompts = make_prompts(jcfg, (21, 34, 17))
    ref, _ = serve_streams(jcfg, jparams, prompts, None if kind == "dense"
                           else JLT.LayoutSpec(kind=kind, page_size=16,
                                               pool_pages=pool),
                           gen=12, slots=3)
    got, sched = port_streams(cfg, params, prompts, PLT.LayoutSpec(
        kind=kind, page_size=16, pool_pages=pool), gen=12, slots=3)
    assert got == ref
    if pool:
        assert sched.page_waits >= 1, "no admission waited for pages"
        assert sorted(sched.free_pages) == list(range(pool))


def test_bridge_round_trips_hybrid_layers():
    _, jparams, _, params = pair()
    stacked = bridge.stack_params(params)
    ref = jax_to_numpy(jparams)
    for name in ("attn", "ssm", "ffn"):
        for k, v in ref["layers"][name].items():
            np.testing.assert_array_equal(
                stacked["layers"][name][k].numpy(), v, err_msg=k)
    back = bridge.unstack_params(stacked)
    for a, b in zip(back["layers"], params["layers"]):
        for name in ("attn", "ssm"):
            for k in b[name]:
                assert torch.equal(a[name][k], b[name][k])
    jback = bridge.params_to_jax(params)
    assert jax.tree_util.tree_structure(jback) == \
        jax.tree_util.tree_structure(ref)


def test_loss_and_gradients_match_jax():
    """L 20 past the window of 8: K2's backward under the window beside
    the mixer's (JAX's chunk halves from 8 to 4)."""
    jcfg, jparams, cfg, params = pair()
    batch = {"tokens": np.random.RandomState(5).randint(
        0, cfg.vocab_size, size=(2, 20)).astype(np.int32)}
    assert_loss_grads_match_jax(JAPI.build_model(jcfg), jparams,
                                build_model(cfg, device="cpu"), params,
                                batch, "hymba")


def test_train_cli_runs_the_hybrid(capsys):
    assert train.main(["--arch", "hymba_1_5b", "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--log-every", "1",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_serve_sessions_demo_matches_solo_runs():
    args = serve.parse_args(["--arch", "hymba_1_5b", "--reduced",
                             "--sessions", "3", "--slots", "2", "--gen", "8",
                             "--prompt-len", "12", "--device", "cpu",
                             "--layout", "paged", "--page-size", "16"])
    cfg, api, params = serve.load(args)
    served = serve.serve_sessions(cfg, api, params, args)
    assert serve.check_sessions(api, params, served, args)["rc"] == 0
