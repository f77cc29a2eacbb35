"""The port's serving stack: scheduler, engine, launcher.

* Greedy session streams from the port's ``SlotScheduler`` equal the JAX
  ``SlotScheduler``'s on the same (bridged) weights at
  ``reduced(tconst_41m)``, f32, with staggered admission and resyncs
  inside a chunk.
* ``repro_torch.launch.serve --sessions`` on the CPU matches its solo
  runs; unported flags are refused with their ROADMAP item.
* Frozen rows (inactive or EOS-finished) come through a decode chunk
  bit-identical although the port updates the cache in place.
"""
import jax
import numpy as np
import pytest
import torch

from parity import family, make_prompts, serve_streams
from repro_torch import bridge
from repro_torch import config as PC
from repro_torch.launch import serve
from repro_torch.models.api import DecodeState, build_model, decode_chunk
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session

torch.set_num_threads(1)
PROMPT_LENS = (21, 34, 17)


@pytest.fixture(scope="module")
def port41():
    """reduced(tconst_41m) in f32 on the CPU, with the JAX family's
    weights (tests/parity.py builds them from PRNGKey(0))."""
    _, _, jparams = family("tconst")
    cfg = PC.reduced(PC.get_config("tconst_41m"), dtype="float32")
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jparams))
    return cfg, build_model(cfg, device="cpu"), params


def port_streams(cfg, api, params, prompts, gen, slots=2, max_len=128,
                 chunk_size=4, stagger=True, **session_kw):
    sched = SlotScheduler(api.decode, params, slots=slots, max_len=max_len,
                          chunk_size=chunk_size)
    sessions = []
    for p in prompts:
        sessions.append(sched.submit(Session(p, max_new_tokens=gen,
                                             **session_kw)))
        if stagger:
            sched.step()
    sched.run()
    return [s.tokens for s in sessions], sched


def test_scheduler_streams_equal_jax_scheduler(port41):
    cfg, api, params = port41
    jcfg, _, jparams = family("tconst")
    prompts = make_prompts(jcfg, PROMPT_LENS)
    ref, _ = serve_streams(jcfg, jparams, prompts, gen=14)
    got, sched = port_streams(cfg, api, params, prompts, gen=14)
    assert got == ref
    # every session crossed a window boundary, several inside a chunk
    assert all(n >= 1 for n in sched.resyncs.values())


def test_engine_chunked_equals_instrumented(port41):
    cfg, api, params = port41
    prompts = np.stack(make_prompts(cfg, (13, 13), seed=8))
    eng = Engine(api, params, max_len=64, device="cpu")
    fast = eng.generate({"tokens": prompts}, 20)
    slow = eng.generate({"tokens": prompts}, 20, record_stats=True)
    np.testing.assert_array_equal(fast, slow)
    # g0 = 5: 19 steps resync before steps 4 and 12 (every W_og = 8)
    assert sum(s.kind == "miss" for s in eng.stats) == 2
    assert sum(s.kind == "hit" for s in eng.stats) == 19


def _snapshot(state, slot):
    return {n: t.select(state.axes[n], slot).clone()
            for n, t in state.merged().items()}


def test_frozen_rows_stay_bit_identical(port41):
    """Inactive and EOS-finished rows: every cache entry unchanged, even
    across a chunk where the live row resyncs."""
    cfg, api, params = port41
    dec = api.decode
    state = dec.init_state(3, 64)
    prompts = make_prompts(cfg, (13, 9, 16), seed=12)
    for slot, p in enumerate(prompts):
        _, state = dec.prefill_into_slot(params, state, slot, p)
    state.bookkeeping["done"][1] = True          # EOS-finished row
    before = [_snapshot(state, s) for s in (1, 2)]
    token = torch.tensor([3, 4, 5], dtype=torch.int32)
    active = np.array([True, True, False])
    toks, state, resyncs = decode_chunk(
        dec, params, state, token, [None] * 3, np.zeros(3), active=active,
        n_steps=6, eos=np.full(3, -1, np.int32))
    assert resyncs[0] == 1, "the live row must resync inside the chunk"
    # the host mirror of gen_len agrees with the device's pending rows
    np.testing.assert_array_equal(
        dec.sync_candidates(state, active),
        dec.sync_mask(state).numpy() & active)
    for slot, snap in zip((1, 2), before):
        after = _snapshot(state, slot)
        for name, t in snap.items():
            assert torch.equal(t, after[name]), (slot, name)
    assert toks[1].eq(4).all() and toks[2].eq(5).all()
    # a done row whose window is full is never resynced, never written
    state.bookkeeping["gen_len"][1] = cfg.tconst.w_og
    state.host["gen_len"][1] = cfg.tconst.w_og
    snap = _snapshot(state, 1)
    decode_chunk(dec, params, state, token, [None] * 3, np.zeros(3),
                 active=np.array([True, True, False]), n_steps=2)
    after = _snapshot(state, 1)
    assert all(torch.equal(t, after[n]) for n, t in snap.items())


def _clone(state):
    return DecodeState({n: t.clone() for n, t in state.kv.items()},
                       {n: t.clone() for n, t in state.bookkeeping.items()},
                       state.axes, {n: v.copy() for n, v in
                                    state.host.items()})


def test_masked_writes_equal_copy_and_select(port41):
    """The port's in-place step with masked writes equals the JAX way:
    step every row, then ``where_rows`` back to the old state."""
    cfg, api, params = port41
    dec = api.decode
    state = dec.init_state(3, 64)
    for slot, p in enumerate(make_prompts(cfg, (13, 9, 20), seed=16)):
        _, state = dec.prefill_into_slot(params, state, slot, p)
    token = torch.tensor([7, 8, 9], dtype=torch.int32)
    live = torch.tensor([True, False, True])
    before, masked, full = _clone(state), _clone(state), _clone(state)
    lm, _ = dec.raw_step(params, masked, token, live=live)
    lf, _ = dec.raw_step(params, full, token)
    selected = full.where_rows(live, before)
    for name, t in masked.merged().items():
        assert torch.equal(t, selected.merged()[name]), name
    assert torch.equal(lm[live], lf[live])


def test_eos_freezes_a_session(port41):
    cfg, api, params = port41
    prompts = make_prompts(cfg, (13,), seed=14)
    free, _ = port_streams(cfg, api, params, prompts, gen=12)
    eos = free[0][4]
    got, sched = port_streams(cfg, api, params, prompts, gen=12, eos_id=eos)
    assert got[0] == free[0][:free[0].index(eos) + 1]
    assert not sched.active.any()


def test_sampled_streams_replay_identically(port41):
    """temperature > 0: each session draws from its own seeded generator,
    so its stream does not depend on slot placement or co-runners."""
    cfg, api, params = port41
    prompts = make_prompts(cfg, (11, 19, 14), seed=15)
    kw = dict(gen=10, temperature=0.9)
    a, _ = port_streams(cfg, api, params, prompts, seed=7, **kw)
    b, _ = port_streams(cfg, api, params, prompts[::-1], seed=7, slots=3,
                        stagger=False, **kw)
    assert a == b[::-1]
    c, _ = port_streams(cfg, api, params, prompts, seed=8, **kw)
    assert a != c


def test_serve_sessions_cli_matches_solo_runs(capsys):
    rc = serve.main(["--arch", "tconst-41m", "--reduced", "--sessions", "3",
                     "--slots", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("matches solo run: True") == 3, out


def test_serve_batch_cli_times_hits_and_misses(capsys):
    rc = serve.main(["--reduced", "--batch", "2", "--prompt-len", "12",
                     "--gen", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "cache-hit steps" in out and "cache-miss resyncs" in out


@pytest.mark.parametrize("flag", [
    ["--prefix-sharing"], ["--prefill-chunk", "-16"],
    ["--spill-capacity-mb", "-1"], ["--spill-dir", "x"],
    ["--workload", "bursty"], ["--policy", "slo"],
    ["--slo-ttft-chunks", "3"], ["--speculate", "4"],
    ["--drafter", "tconst"], ["--mesh", "2x4"]])
def test_unported_flags_error(flag, capsys):
    """Flags of features not ported yet argparse-error with their ROADMAP
    item.  ``--prefix-sharing``, ``--prefill-chunk``,
    ``--spill-capacity-mb`` and ``--spill-dir`` are ported: on the dense
    layout the first, a chunk that is not positive the second, a negative
    capacity the third and a spill directory without a capacity the last
    are refused as the JAX launcher refuses them."""
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--sessions", "2"] + flag)
    assert e.value.code == 2
    err = capsys.readouterr().err
    if flag == ["--prefix-sharing"]:
        assert "--prefix-sharing shares pool pages" in err
    elif flag[0] == "--prefill-chunk":
        assert "--prefill-chunk -16 must be positive" in err
    elif flag[0] == "--spill-capacity-mb":
        assert "--spill-capacity-mb -1.0 must be positive" in err
    elif flag[0] == "--spill-dir":
        assert "--spill-dir is the tier below a bounded host-RAM store" \
            in err
    else:
        assert "ROADMAP Queue 1 item" in err


# sessions 2 x (prompt 64 / 69 + gen 64 + 64) -> max_len 197 -> 13 pages of
# 16 per slot, 26 in the full pool of 2 slots; the uniform batch (4 rows,
# max_len 192) needs 48
@pytest.mark.parametrize("flags,accepted", [
    (["--sessions", "2", "--pool-pages", "26"], True),     # the full pool
    (["--sessions", "2", "--pool-pages", "27"], False),    # over-full
    (["--pool-pages", "10"], False)])                      # no --sessions
def test_layout_flags_validated_like_jax(flags, accepted, capsys):
    """The port's paged-layout flag validation gives the JAX launcher's
    verdict (``repro.launch.serve.validate_layout_args``) on the same
    arguments."""
    from repro.config import get_config as jax_get_config
    from repro.launch import serve as jax_serve
    argv = ["--layout", "paged", "--page-size", "16"] + flags

    def verdict(fn):
        try:
            fn()
        except SystemExit as e:
            assert e.code == 2
            return False
        return True

    ap = serve.build_parser()
    args = ap.parse_args(argv)
    max_len = serve.sessions_max_len(args) if args.sessions \
        else serve.batch_max_len(args)
    jax_ok = verdict(lambda: jax_serve.validate_layout_args(
        ap, jax_get_config(args.arch), args, max_len))
    assert verdict(lambda: serve.parse_args(argv)) == jax_ok == accepted
    if not accepted:
        assert "--pool-pages" in capsys.readouterr().err


def test_serve_without_gpu_raises_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device works here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--reduced", "--batch", "1", "--gen", "2"])


def test_profile_step_runs_on_cpu(capsys):
    from repro_torch.launch import profile_step
    assert profile_step.main(["--reduced", "--batch", "1", "--prompt-len",
                              "12", "--steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[profile] hit: wall" in out and "[profile] resync: wall" in out
