"""The port's scheduling-policy seam and scheduler telemetry, against the
JAX package (``tests/test_serving_policy.py`` is the suite mirrored) and
within the port.

Within the port (its own seeded init, f32, no JAX compile):

1. **Overtake accounting** -- every admission of a session other than the
   arrival-order head counts against ``max_head_skips``, resumes of
   spilled sessions too; a spent budget offers the head alone, whatever
   the policy proposes.
2. **Stream identity** -- at temperature > 0, through spill / resume
   cycles, ``fifo`` and ``slo`` give the same stream at every trace
   position (one test runs both: no ``request.config.cache``, which
   ``-p no:cacheprovider`` disables), and so do two runs; a
   session without a seed draws from (scheduler seed, ``sid``), never its
   slot.
3. **Cost-aware victims** -- ``spill_cost`` counts a paged LM slot's live
   pages and its re-admission bytes, a TConst slot re-admits for free, and
   the deadline policy spills the cheapest slot and the ITL-bound one
   last; it orders admissions by slack, then priority.
4. **Telemetry** -- every submitted session is recorded to retirement;
   the policy and telemetry hooks dispatch no tensor operation (they read
   host state and tensor metadata only).

Against JAX (one module-scoped JAX scheduler run): a reduced LM (one
layer) on paged pages of 8 with prefix sharing, chunked admission, a tier
store and ``preempt_chunks=1`` replays a bursty trace under ``slo``; the
port's run equals it in the greedy streams by trace position,
``spill_stats``, admission sources and forward tokens, the deferrals the
policy made, and the telemetry summary but its wall-clock TTFT.

The serve CLI's ``--workload`` mode runs reduced on the CPU.  On the card
(``cuda`` marker; skips without a GPU): both policies through spills on
tconst / dense and an LM on paged, equal streams, only the layout's
kernels launched.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

try:    # the GPU machine has no JAX: only the cuda tests run there
    import jax
    from repro import config as JC
    from repro.models import api as JAPI
    from repro.models import layouts as JLT
    from repro.models import lm as JLM
    from repro.serving import metrics as JM
    from repro.serving import tier_store as JTS
    from repro.serving import workload as JW
    from repro.serving.scheduler import SlotScheduler as JScheduler
    from repro_torch import bridge
    from torch_parity import jax_to_numpy, port_cfg
except ImportError:
    jax = None
from repro_torch import config as PC
from repro_torch import runtime
from repro_torch.launch import serve
from repro_torch.models import layouts as LT
from repro_torch.models.api import build_decode, build_model
from repro_torch.serving.metrics import ServingTelemetry
from repro_torch.serving.policy import (DeadlineCostPolicy, FifoPolicy,
                                        get_policy, ttft_slack)
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session
from repro_torch.serving.tier_store import TierStore
from repro_torch.serving.workload import WorkloadSpec, generate_workload

torch.set_num_threads(1)
PAGE = 8
_MODELS = {}


def _model(name):
    """(cfg, params) of the port's reduced f32 tconst-41m ("tconst") or
    llama3 ("lm", one KV head over four), its own seeded init."""
    if name not in _MODELS:
        arch = {"tconst": "tconst_41m", "lm": "llama3_405b"}[name]
        cfg = PC.reduced(PC.get_config(arch), dtype="float32")
        _MODELS[name] = cfg, build_model(cfg, device="cpu").init(0)
    return _MODELS[name]


def _prompt(rng, cfg, n):
    return rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)


def _decode(cfg, kind="dense", pool_pages=None, device="cpu"):
    spec = None if kind == "dense" else LT.LayoutSpec(
        kind=kind, page_size=PAGE, pool_pages=pool_pages)
    return build_decode(cfg, spec, device=device)


# ---------------------------------------------------------------------------
# 1. overtake accounting: resumes count against the head-skip budget
# ---------------------------------------------------------------------------


def test_resume_overtakes_count_toward_head_skip_budget():
    cfg, params = _model("lm")
    sched = SlotScheduler(_decode(cfg, "paged", 12), params, slots=3,
                          max_len=96, chunk_size=2, tier_store=TierStore(),
                          max_head_skips=1)
    rng = np.random.RandomState(0)
    small_a = sched.submit(Session(_prompt(rng, cfg, 10), max_new_tokens=8))
    small_b = sched.submit(Session(_prompt(rng, cfg, 10), max_new_tokens=8))
    sched.step()                                 # both admitted, 6 free
    assert small_a.slot is not None and small_b.slot is not None
    big = sched.submit(Session(_prompt(rng, cfg, 60), max_new_tokens=16))
    # big needs 10 pages; spilling one small leaves 9 free: the head is
    # still page-blocked, but the spilled session's resume (3 pages) fits
    sched.spill(small_a.slot)
    assert sched.pending[0] is big and sched.pending[1] is small_a
    sched.admit_pending()
    assert small_a.slot is not None              # resumed past the head
    assert sched.admit_stats[-1].source == "resume"
    assert sched._head_skips == 1                # the overtake was counted
    # the budget (1) is spent: no further resume overtakes the head
    sched.spill(small_a.slot)
    waits = sched.page_waits
    sched.admit_pending()
    assert small_a.slot is None and big.slot is None
    assert sched.page_waits == waits + 1         # a free slot waited
    # freeing the other small's pages lets the head in; the budget resets
    sched.spill(small_b.slot)
    sched.admit_pending()
    assert big.slot is not None
    assert sched._head_skips == 0


def test_strict_mode_is_policy_proof():
    """A spent budget offers the head alone: a policy that proposes the
    tail first (and would defer everything) is not asked."""
    class TailFirst(FifoPolicy):
        asked = 0

        def order_pending(self, pending, sched):
            TailFirst.asked += 1
            return list(reversed(pending))

        def defer_admission(self, sched, session, plan):
            return True

    cfg, params = _model("tconst")
    sched = SlotScheduler(_decode(cfg, "paged", 8), params, slots=1,
                          max_len=64, chunk_size=2, max_head_skips=0,
                          policy=TailFirst())
    rng = np.random.RandomState(1)
    first = sched.submit(Session(_prompt(rng, cfg, 6), max_new_tokens=4))
    second = sched.submit(Session(_prompt(rng, cfg, 6), max_new_tokens=4))
    sched.admit_pending()
    assert first.slot is not None and second.slot is None
    assert TailFirst.asked == 0


# ---------------------------------------------------------------------------
# 2. per-session sampling: identity across policies and runs
# ---------------------------------------------------------------------------


def _drive(sched, sessions):
    for s in sessions:
        sched.submit(s)
    sched.run()
    return [tuple(s.tokens) for s in sessions]


def _make_sessions(cfg, n=5):
    rng = np.random.RandomState(7)
    return [Session(_prompt(rng, cfg, int(rng.randint(4, 12))),
                    max_new_tokens=int(rng.randint(4, 9)),
                    temperature=0.8, seed=100 + i) for i in range(n)]


def test_streams_identical_across_policies_through_spills():
    """Five sessions through two slots, spilled every chunk, at
    temperature 0.8: ``fifo`` and ``slo`` spill different victims in a
    different order, and every trace position streams the same tokens."""
    cfg, params = _model("tconst")
    streams, spills = {}, {}
    for policy in ("fifo", "slo"):
        sched = SlotScheduler(_decode(cfg), params, slots=2, max_len=64,
                              chunk_size=4, tier_store=TierStore(),
                              preempt_chunks=1, policy=policy)
        streams[policy] = _drive(sched, _make_sessions(cfg))
        spills[policy] = sched.spill_stats["spills"]
        assert spills[policy] == sched.spill_stats["resumes"] > 0
    assert streams["fifo"] == streams["slo"], \
        "token streams changed with the scheduling policy"
    assert all(len(set(s)) > 1 for s in streams["fifo"])    # sampled


def test_streams_identical_across_runs_same_seed():
    cfg, params = _model("tconst")

    def once():
        sched = SlotScheduler(_decode(cfg), params, slots=2, max_len=64,
                              chunk_size=4)
        return _drive(sched, _make_sessions(cfg, n=3))

    assert once() == once()


def test_sessions_without_seed_fall_back_to_sid_fold():
    """No explicit seed: the generator derives from (scheduler seed,
    ``sid``), deterministic for a fixed sid whatever its slot."""
    cfg, params = _model("tconst")
    rng = np.random.RandomState(3)
    prompt = _prompt(rng, cfg, 8)

    def run_at_slot(occupy_first):
        sched = SlotScheduler(_decode(cfg), params, slots=2, max_len=64,
                              chunk_size=4, seed=9)
        if occupy_first:                   # push the probe to slot 1
            sched.submit(Session(_prompt(rng, cfg, 6), max_new_tokens=20,
                                 temperature=0.9, seed=1))
        probe = Session(prompt, max_new_tokens=6, temperature=0.9)
        probe.sid = 12345                  # pin identity across runs
        sched.submit(probe)
        sched.run()
        return probe.slot, tuple(probe.tokens)

    a, b = run_at_slot(False), run_at_slot(True)
    assert a[1] == b[1]


# ---------------------------------------------------------------------------
# 3. cost model + victim selection
# ---------------------------------------------------------------------------


def test_spill_cost_scales_with_live_pages_and_readmit():
    cfg, params = _model("lm")
    sched = SlotScheduler(_decode(cfg, "paged", 24), params, slots=2,
                          max_len=128, chunk_size=2)
    rng = np.random.RandomState(2)
    short = sched.submit(Session(_prompt(rng, cfg, 6), max_new_tokens=4))
    long = sched.submit(Session(_prompt(rng, cfg, 60), max_new_tokens=4))
    sched.admit_pending()
    c_short = sched.spill_cost(short.slot)
    c_long = sched.spill_cost(long.slot)
    assert c_long["bytes"] > c_short["bytes"]
    # an LM's admission is not prompt-pure: re-admission pays the bytes
    assert c_short["readmit"] == c_short["bytes"] > 0
    assert c_long["total"] == 2 * c_long["bytes"]
    # per live page: the K and V pages of every layer (f32)
    page = 2 * cfg.n_layers * PAGE * cfg.n_kv_heads * cfg.resolved_head_dim * 4
    assert c_long["bytes"] - c_short["bytes"] == \
        page * (sched._live_pages(long) - sched._live_pages(short))


def test_spill_cost_tconst_readmits_free():
    cfg, params = _model("tconst")
    sched = SlotScheduler(_decode(cfg), params, slots=1, max_len=64,
                          chunk_size=2)
    rng = np.random.RandomState(2)
    s = sched.submit(Session(_prompt(rng, cfg, 8), max_new_tokens=4))
    sched.admit_pending()
    cost = sched.spill_cost(s.slot)
    assert cost["readmit"] == 0                  # admission_key: O(1) redo
    assert cost["total"] == cost["bytes"] == sched.kv_bytes() > 0


def test_deadline_policy_spills_cheapest_and_protects_itl():
    cfg, params = _model("lm")
    sched = SlotScheduler(_decode(cfg, "paged", 24), params, slots=3,
                          max_len=128, chunk_size=2, policy="slo")
    rng = np.random.RandomState(4)
    cheap = sched.submit(Session(_prompt(rng, cfg, 6), max_new_tokens=4))
    costly = sched.submit(Session(_prompt(rng, cfg, 60), max_new_tokens=4))
    bound = sched.submit(Session(_prompt(rng, cfg, 6), max_new_tokens=4,
                                 slo_itl_chunks=1))
    sched.admit_pending()
    ripe = [cheap.slot, costly.slot, bound.slot]
    picks = sched.policy.select_victims(sched, ripe, 3)
    assert picks[0] == cheap.slot                # cheapest bytes first
    assert picks[-1] == bound.slot               # ITL-bound spilled last
    # the FIFO baseline: longest resident first, ties by slot order
    sched._slot_chunks[:] = [1, 3, 2]
    assert FifoPolicy().select_victims(sched, ripe, 2) == \
        [costly.slot, bound.slot]


def test_deadline_policy_orders_by_slack_then_priority():
    class Clocked:
        clock = 10

    def sess(submit, slo, prio):
        s = Session(np.ones(4, np.int32), max_new_tokens=2, priority=prio,
                    slo_ttft_chunks=slo)
        s.submit_clock = submit
        return s

    tight = sess(9, 4, 0)              # slack 3
    loose = sess(0, 30, 0)             # slack 20
    free = sess(0, None, 0)            # slack inf
    vip = sess(9, 4, 2)                # slack 3, higher priority
    order = DeadlineCostPolicy().order_pending(
        [free, loose, tight, vip], Clocked())
    assert order == [vip, tight, loose, free]
    assert ttft_slack(free, 10) == float("inf")
    assert ttft_slack(tight, 10) == 3


def test_get_policy_registry():
    assert get_policy("fifo").name == "fifo"
    assert get_policy("slo").name == "slo"
    assert get_policy("slo").defer_slack == 4
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        get_policy("lifo")
    with pytest.raises(ValueError):
        DeadlineCostPolicy(defer_slack=-1)
    cfg, params = _model("tconst")
    sched = SlotScheduler(_decode(cfg), params, slots=1, max_len=32)
    assert isinstance(sched.policy, FifoPolicy)
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        SlotScheduler(_decode(cfg), params, slots=1, max_len=32,
                      policy="lifo")


# ---------------------------------------------------------------------------
# 4. telemetry through the scheduler
# ---------------------------------------------------------------------------


class _NoTensorOps(TorchDispatchMode):
    """Records every tensor operation dispatched while active."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _watched(obj, names, mode, calls):
    """Wrap ``obj``'s methods ``names`` so each call runs under ``mode``
    and is counted in ``calls``."""
    for name in names:
        orig = getattr(obj, name)

        def hook(*a, _orig=orig, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            with mode:
                return _orig(*a, **kw)

        setattr(obj, name, hook)


def test_telemetry_tracks_every_session_to_retirement():
    """Four sessions over two slots, spilled every chunk, under ``slo``:
    every session is recorded to retirement with the scheduler's counts,
    one occupancy sample a tick, and neither a policy hook, ``spill_cost``
    nor a telemetry hook dispatches a tensor operation."""
    cfg, params = _model("tconst")
    tel = ServingTelemetry()
    sched = SlotScheduler(_decode(cfg), params, slots=2, max_len=64,
                          chunk_size=4, tier_store=TierStore(),
                          preempt_chunks=1, telemetry=tel, policy="slo")
    mode, calls = _NoTensorOps(), {}
    _watched(sched.policy, ("order_pending", "defer_admission",
                            "select_victims"), mode, calls)
    _watched(sched, ("spill_cost",), mode, calls)
    _watched(tel, ("on_submit", "on_admit", "on_spill", "on_tokens",
                   "on_retire", "on_tick"), mode, calls)
    sessions = _make_sessions(cfg, n=4)
    _drive(sched, sessions)
    assert mode.ops == []
    assert calls["select_victims"] > 0 and calls["spill_cost"] > 0
    assert calls["on_tick"] == sched.clock
    assert len(tel.records) == 4
    for s in sessions:
        rec = tel.records[s.sid]
        assert rec.done and rec.tokens_out == len(s.tokens)
        assert rec.ttft_chunks is not None and rec.ttft_chunks >= 1
        assert rec.queue_wait_chunks is not None
        assert rec.spills == s.spills and rec.resumes == s.resumes
    summary = tel.summary()
    assert summary["finished"] == 4
    assert summary["spills"] == sched.spill_stats["spills"] > 0
    assert len(tel.occupancy) == sched.clock
    # the admissions' first dispatches taint their sessions' wall TTFT
    assert summary["ttft_compile_excluded"] >= 1
    assert summary["ttft_seconds_warm"]["n"] == \
        4 - summary["ttft_compile_excluded"]


# ---------------------------------------------------------------------------
# one scheduler run against JAX's
# ---------------------------------------------------------------------------

POOL = 12
TRACE_SEED = 0
# a bursty trace over 3 slots: half the prompts share one 2-page system
# prompt, a fifth repeat an earlier prompt, half carry a 3-chunk TTFT
# deadline; the pool of 12 pages of 8 holds a long session (up to 10
# pages) or two short ones, so the slo policy defers slack-rich sessions
# for page-blocked deadline ones
TRACE = dict(n_sessions=10, arrival="bursty", burst_size=4,
             burst_every=3.0, shared_frac=0.5, n_prefixes=1, prefix_len=16,
             repeat_frac=0.2, slo_frac=0.5, slo_ttft_chunks=3,
             prompt_mix=((0.7, 4, 12), (0.3, 20, 30)),
             output_mix=((0.8, 6, 12), (0.2, 16, 24)))
SCHED_KW = dict(slots=3, max_len=96, chunk_size=4, prefix_sharing=True,
                prefill_chunk=PAGE, preempt_chunks=1, policy="slo")


def _jax_replay(sched, arrivals):
    """``serve.drive``'s open-loop replay, on JAX's scheduler."""
    i = 0
    while i < len(arrivals) or sched.pending or sched.active.any():
        while i < len(arrivals) and arrivals[i].at_chunk <= sched.clock:
            sched.submit(arrivals[i].session)
            i += 1
        sched.step()
    return sched


def _count_deferrals(policy):
    """Wrap ``policy.defer_admission``; returns the list of its answers."""
    answers, orig = [], policy.defer_admission

    def defer(sched, session, plan):
        answers.append(orig(sched, session, plan))
        return answers[-1]

    policy.defer_admission = defer
    return answers


def _chunk_units(summary):
    """The telemetry summary without its wall-clock TTFT."""
    return {k: v for k, v in summary.items() if k != "ttft_seconds_warm"}


@pytest.fixture(scope="module")
def jax_policy_run():
    """JAX's scheduler on the trace, once: (its scheduler, telemetry,
    arrivals, deferral answers) and the port's cfg and params bridged
    from the same init."""
    if jax is None:
        pytest.skip("the JAX reference needs JAX (absent on the GPU "
                    "machine)")
    jcfg = JC.reduced(JC.get_config("llama3_405b"), dtype="float32",
                      n_layers=1)
    jparams = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.lm_params_from_jax(jax_to_numpy(jparams))
    arrivals = JW.generate_workload(
        JW.WorkloadSpec(vocab=jcfg.vocab_size, **TRACE), TRACE_SEED,
        max_prompt_len=48)
    tel = JM.ServingTelemetry()
    jsched = JScheduler(JAPI.build_decode(jcfg, JLT.LayoutSpec(
        kind="paged", page_size=PAGE, pool_pages=POOL)), jparams,
        tier_store=JTS.TierStore(), telemetry=tel, **SCHED_KW)
    answers = _count_deferrals(jsched.policy)
    _jax_replay(jsched, arrivals)
    return port_cfg(jcfg), params, jsched, tel, arrivals, answers


def test_slo_workload_scheduler_equals_jax(jax_policy_run):
    """The port replays JAX's trace under ``slo`` exactly as JAX's
    scheduler does: the same deferrals, spills, resumes, retired and
    re-adopted pages, admission sources and forward tokens, greedy
    streams at every trace position, and the telemetry in chunk units."""
    cfg, params, jsched, jtel, jarrivals, janswers = jax_policy_run
    arrivals = generate_workload(WorkloadSpec(vocab=cfg.vocab_size, **TRACE),
                                 TRACE_SEED, max_prompt_len=48)
    tel = ServingTelemetry()
    sched = SlotScheduler(_decode(cfg, "paged", POOL), params,
                          tier_store=TierStore(), telemetry=tel, **SCHED_KW)
    answers = _count_deferrals(sched.policy)
    serve.drive(sched, arrivals)
    assert answers == janswers and sum(answers) > 0
    assert sched.spill_stats == jsched.spill_stats
    st = sched.spill_stats
    assert st["spills"] == st["resumes"] > 0 and st["pages_readopted"] > 0
    assert [a.source for a in sched.admit_stats] == \
        [a.source for a in jsched.admit_stats]
    assert [a.forward_tokens for a in sched.admit_stats] == \
        [a.forward_tokens for a in jsched.admit_stats]
    assert [a.session.tokens for a in arrivals] == \
        [a.session.tokens for a in jarrivals]
    assert sched.clock == jsched.clock
    summary = tel.summary()
    assert summary["finished"] == summary["sessions"] == len(arrivals)
    assert _chunk_units(summary) == _chunk_units(jtel.summary())
    assert tel.occupancy == jtel.occupancy
    assert (sched.page_refcounts() == 0).all()
    assert sorted(sched.free_pages) == list(range(POOL))
    assert not tuple(sched.store.pinned_keys())


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

WORKLOAD_ARGV = ["--arch", "tconst-41m", "--reduced", "--device", "cpu",
                 "--dtype", "float32", "--sessions", "8", "--slots", "2",
                 "--chunk", "4", "--max-len", "104", "--workload", "bursty",
                 "--slo-ttft-chunks", "6", "--temperature", "0.7",
                 "--spill-capacity-mb", "64"]


def test_serve_cli_workload_both_policies(capsys):
    """``--workload bursty`` through the normal entry point under both
    policies: the summary JSON and ``workload drained: ok`` with rc 0;
    the same trace, and (spilling, at temperature 0.7) the same streams
    at every position."""
    streams = {}
    for policy in ("fifo", "slo"):
        args = serve.parse_args(WORKLOAD_ARGV + ["--policy", policy])
        rep = serve.run_workload(*serve.load(args), args)
        out = capsys.readouterr().out
        assert rep["rc"] == 0
        assert f"policy={policy} served 8 sessions" in out
        assert '"ttft_chunks"' in out and "workload drained: ok" in out
        assert rep["summary"]["finished"] == 8
        assert rep["summary"]["spills"] == rep["sched"].spill_stats[
            "spills"] > 0
        streams[policy] = [a.session.tokens for a in rep["arrivals"]]
    assert streams["fifo"] == streams["slo"]
    assert serve.main(WORKLOAD_ARGV[:-2] + ["--policy", "slo"]) == 0
    assert "workload drained: ok" in capsys.readouterr().out


@pytest.mark.parametrize("flags,message", [
    (["--workload", "bursty"], "add --sessions N"),
    (["--sessions", "2", "--workload", "poisson", "--slo-ttft-chunks", "0"],
     "must be >= 1"),
    (["--sessions", "2", "--speculate", "2"], "not ported"),
    (["--sessions", "2", "--workload", "poisson", "--policy", "slo"],
     None)])
def test_serve_workload_flags_validated_like_jax(flags, message, capsys):
    if message is None:
        args = serve.parse_args(flags)
        assert (args.workload, args.policy) == ("poisson", "slo")
        assert set(serve.UNPORTED) == {"speculate", "drafter", "mesh"}
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
                    "CPU mode (the policy runs' CPU versions are above)")


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind,kernels", [
    ("tconst", "dense", {"decode_attention", "flash_attention"}),
    ("lm", "paged", {"flash_attention", "paged_decode_attention"})])
def test_cuda_policies_equal_streams_through_spills(name, kind, kernels):
    """On the card, at temperature 0.8 through spills: ``fifo`` and
    ``slo`` stream the same tokens at every position, and each run
    launches exactly its layout's kernels and no plain version."""
    _need_cuda()
    cfg, params = _model(name)
    streams = {}
    for policy in ("fifo", "slo"):
        tel = ServingTelemetry()
        sched = SlotScheduler(_decode(cfg, kind, 24, device="cuda"), params,
                              slots=2, max_len=64, chunk_size=4,
                              tier_store=TierStore(), preempt_chunks=1,
                              policy=policy, telemetry=tel)
        runtime.reset_counters()
        streams[policy] = _drive(sched, _make_sessions(cfg))
        torch.cuda.synchronize()
        counts = runtime.read_counters()
        assert {n for n, c in counts.items() if c["kernel"]} == kernels
        assert all(c["plain"] == 0 for c in counts.values())
        assert sched.spill_stats["spills"] > 0
        assert tel.summary()["finished"] == 5
    assert streams["fifo"] == streams["slo"]
