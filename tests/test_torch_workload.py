"""The port's workload generator and serving telemetry against the JAX
package's (``tests/test_workload.py`` is the suite mirrored; no model, no
device).

The serving comparisons mean something only if (1) the traffic trace is a
function of ``(spec, seed)`` alone, in both packages: the same spec and
seed give the same prompts, arrival chunks, output budgets, sampling
seeds, priorities and SLO targets at every trace position (session ids
are process-global, so identity is by position, never by ``sid``); and (2)
the telemetry's aggregation is exact on known hook sequences, equal to
JAX's but for the wall-clock TTFT.  Each test of the JAX suite runs here
on the port's modules; the generator and the hook sequences also run
through JAX's, field by field.
"""
import numpy as np
import pytest

from repro.serving import metrics as JM
from repro.serving import workload as JW
from repro.serving.session import Session as JSession
from repro_torch.serving.metrics import (ServingTelemetry, SessionRecord,
                                         percentile)
from repro_torch.serving.session import Session
from repro_torch.serving.workload import (Arrival, WorkloadSpec,
                                          generate_workload)

VOCAB = 512


def _spec(**kw):
    base = dict(n_sessions=40, vocab=VOCAB)
    base.update(kw)
    return WorkloadSpec(**base)


def _fields(arrival):
    """Every field of an arrival that the trace fixes (not ``sid``)."""
    s = arrival.session
    return (arrival.at_chunk, s.prompt.tolist(), s.prompt.dtype.str,
            s.max_new_tokens, s.temperature, s.seed, s.priority,
            s.slo_ttft_chunks, s.slo_itl_chunks, s.eos_id)


# ---------------------------------------------------------------------------
# the port's generator against JAX's
# ---------------------------------------------------------------------------

# specs over both arrival processes and every population: shared system
# prompts (page-aligned and not), verbatim repeats, SLO slices with and
# without an inter-token target, a temperature
TRACES = {
    "poisson": dict(),
    "poisson_mixed": dict(rate=1.5, shared_frac=0.3, n_prefixes=3,
                          prefix_len=16, repeat_frac=0.25, slo_frac=0.4,
                          slo_ttft_chunks=5, slo_itl_chunks=2,
                          temperature=0.7),
    "bursty": dict(arrival="bursty", burst_size=5, burst_every=6.0,
                   repeat_frac=0.2, slo_frac=0.5),
    "bursty_shared": dict(arrival="bursty", burst_size=3, burst_every=2.5,
                          shared_frac=0.5, n_prefixes=2, prefix_len=64,
                          repeat_frac=0.25, slo_frac=0.4, slo_priority=3,
                          prompt_mix=((0.6, 600, 760), (0.4, 940, 1000)),
                          output_mix=((0.7, 64, 96), (0.3, 128, 160))),
}


@pytest.mark.parametrize("max_prompt_len", [None, 12])
@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("trace", sorted(TRACES))
def test_generate_workload_equals_jax(trace, seed, max_prompt_len):
    """The same spec and seed give JAX's trace at every position: the
    draw order of ``np.random.RandomState`` is JAX's."""
    kw = dict(n_sessions=24, vocab=VOCAB, **TRACES[trace])
    mine = generate_workload(WorkloadSpec(**kw), seed,
                             max_prompt_len=max_prompt_len)
    ref = JW.generate_workload(JW.WorkloadSpec(**kw), seed,
                               max_prompt_len=max_prompt_len)
    assert len(mine) == len(ref) == 24
    for i, (a, b) in enumerate(zip(mine, ref)):
        assert _fields(a) == _fields(b), f"{trace}: position {i}"
    assert any(a.session.slo_ttft_chunks for a in mine) == \
        (TRACES[trace].get("slo_frac", 0.5) > 0)


# ---------------------------------------------------------------------------
# workload generation (JAX's suite on the port)
# ---------------------------------------------------------------------------


def test_workload_deterministic_in_spec_and_seed():
    a = generate_workload(_spec(), seed=7)
    b = generate_workload(_spec(), seed=7)
    assert len(a) == len(b) == 40
    for x, y in zip(a, b):
        assert _fields(x) == _fields(y)
    c = generate_workload(_spec(), seed=8)
    assert any(x.at_chunk != z.at_chunk or
               not np.array_equal(x.session.prompt, z.session.prompt)
               for x, z in zip(a, c))
    assert all(isinstance(x, Arrival) and isinstance(x.session, Session)
               for x in a)


def test_workload_sorted_and_shaped_by_mixes():
    arrivals = generate_workload(_spec(
        prompt_mix=((1.0, 5, 9),), output_mix=((1.0, 3, 4),)), seed=0)
    chunks = [a.at_chunk for a in arrivals]
    assert chunks == sorted(chunks) and chunks[0] >= 0
    for a in arrivals:
        assert 5 <= len(a.session.prompt) <= 9
        assert 3 <= a.session.max_new_tokens <= 4
        assert a.session.prompt.dtype == np.int32
        assert int(a.session.prompt.max()) < VOCAB


def test_bursty_arrivals_pile_up_on_shared_chunks():
    arrivals = generate_workload(_spec(
        arrival="bursty", burst_size=8, burst_every=50.0), seed=1)
    chunks = [a.at_chunk for a in arrivals]
    assert len(set(chunks)) < len(chunks) // 2


def test_shared_prefix_population_reuses_the_common_heads():
    spec = _spec(shared_frac=1.0, n_prefixes=2, prefix_len=8,
                 prompt_mix=((1.0, 4, 6),))
    arrivals = generate_workload(spec, seed=2)
    heads = {a.session.prompt[:8].tobytes() for a in arrivals}
    assert len(heads) <= 2
    assert all(len(a.session.prompt) > 8 for a in arrivals)


def test_repeat_population_reissues_verbatim_prompts():
    arrivals = generate_workload(_spec(repeat_frac=0.9), seed=3)
    seen = set()
    repeats = 0
    for a in arrivals:
        key = a.session.prompt.tobytes()
        repeats += key in seen
        seen.add(key)
    assert repeats >= len(arrivals) // 2


def test_slo_slice_carries_targets_and_priority():
    every = generate_workload(_spec(slo_frac=1.0, slo_ttft_chunks=5,
                                    slo_itl_chunks=2, slo_priority=3),
                              seed=4)
    for a in every:
        assert a.session.slo_ttft_chunks == 5
        assert a.session.slo_itl_chunks == 2
        assert a.session.priority == 3
    none = generate_workload(_spec(slo_frac=0.0), seed=4)
    assert all(a.session.slo_ttft_chunks is None for a in none)
    assert all(a.session.priority == 0 for a in none)


def test_max_prompt_len_clips():
    arrivals = generate_workload(_spec(prompt_mix=((1.0, 30, 60),)),
                                 seed=5, max_prompt_len=12)
    assert max(len(a.session.prompt) for a in arrivals) <= 12


@pytest.mark.parametrize("bad", [
    dict(n_sessions=0), dict(arrival="uniform"), dict(rate=0.0),
    dict(arrival="bursty", burst_size=0), dict(slo_frac=1.5),
    dict(prompt_mix=()), dict(prompt_mix=((1.0, 9, 4),)),
    dict(output_mix=((0.0, 1, 2),)),
])
def test_workload_spec_validation(bad):
    """The port refuses what JAX refuses, with the same message."""
    with pytest.raises(ValueError) as mine:
        _spec(**bad)
    with pytest.raises(ValueError) as ref:
        JW.WorkloadSpec(**{**dict(n_sessions=40, vocab=VOCAB), **bad})
    assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------------------
# telemetry aggregation, through both packages
# ---------------------------------------------------------------------------


def test_percentile_nearest_rank():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert percentile(xs, 50) == 3.0
    assert percentile(xs, 99) == 5.0
    assert percentile(xs, 0) == 1.0
    assert percentile([], 50) is None
    for q in (0, 1, 25, 50, 75, 99, 100):
        for n in (1, 2, 7, 100):
            ys = list(np.random.RandomState(n).rand(n))
            assert percentile(ys, q) == JM.percentile(ys, q)


def _session(mod_session=Session, **kw):
    base = dict(prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=4)
    base.update(kw)
    return mod_session(**base)


def _both(script):
    """Run ``script(telemetry, make_session)`` on the port's telemetry with
    port sessions and on JAX's with JAX sessions; returns both."""
    mine, ref = ServingTelemetry(), JM.ServingTelemetry()
    script(mine, lambda **kw: _session(Session, **kw))
    script(ref, lambda **kw: _session(JSession, **kw))
    return mine, ref


def _no_wall(summary):
    """A summary without the wall-clock TTFT (its count stays)."""
    out = dict(summary)
    out["ttft_seconds_warm"] = {"n": summary["ttft_seconds_warm"]["n"]}
    return out


def _records(tel):
    """Every record's fields but ``sid`` and the wall TTFT, in order."""
    keep = [f for f in SessionRecord.__dataclass_fields__
            if f not in ("sid", "ttft_seconds")]
    return [({f: getattr(r, f) for f in keep}, r.ttft_seconds is None,
             r.queue_wait_chunks, r.ttft_ok, r.itl_ok, r.slo_ok,
             r.acceptance_rate) for r in tel.records.values()]


def _ttft_itl_slo(tel, make):
    s = make(slo_ttft_chunks=3, slo_itl_chunks=2)
    tel.on_submit(s, clock=2)
    tel.on_admit(s, clock=4, source="cold")
    tel.on_tokens(s, 1, clock=4, compiled=True)
    tel.on_tokens(s, 2, clock=6, compiled=False)
    tel.on_tokens(s, 1, clock=9, compiled=False)
    tel.on_retire(s, clock=9)
    return s


def test_telemetry_ttft_itl_and_slo_accounting():
    tel = ServingTelemetry()
    s = _ttft_itl_slo(tel, lambda **kw: _session(**kw))
    rec = tel.records[s.sid]
    assert rec.queue_wait_chunks == 2
    assert rec.ttft_chunks == 2 and rec.ttft_ok is True
    assert rec.ttft_compiled and rec.ttft_seconds is None
    assert rec.itl_gaps_chunks == [2, 0, 3]
    assert rec.itl_ok is False and rec.slo_ok is False
    assert rec.tokens_out == 4 and rec.done
    mine, ref = _both(_ttft_itl_slo)
    assert _records(mine) == _records(ref)
    assert _no_wall(mine.summary()) == _no_wall(ref.summary())


def _starved(tel, make):
    tel.on_submit(make(slo_ttft_chunks=4), clock=0)
    tel.on_submit(make(), clock=0)


def test_telemetry_starved_slo_session_counts_as_miss():
    mine, ref = _both(_starved)
    recs = list(mine.records.values())
    assert recs[0].ttft_ok is False
    assert recs[1].slo_ok is None
    summary = mine.summary()
    assert summary["sessions"] == 2
    assert summary["slo"]["sessions_with_slo"] == 1
    assert summary["slo"]["attainment"] == 0.0
    assert summary == ref.summary()
    assert _records(mine) == _records(ref)


def _two_sessions(tel, make):
    for clock, s in enumerate([make(), make(slo_ttft_chunks=9)]):
        tel.on_submit(s, clock=clock)
        tel.on_admit(s, clock=clock + 1, source="cold")
        tel.on_tokens(s, 1, clock=clock + 1, compiled=False)
        tel.on_tokens(s, 1, clock=clock + 2, compiled=False)
        tel.on_retire(s, clock=clock + 2)
    tel.on_tick(1, n_active=2, n_pending=0, free_pages=4, total_pages=8)
    tel.on_tick(2, n_active=1, n_pending=0, free_pages=None,
                total_pages=None)


def test_telemetry_summary_shapes():
    mine, ref = _both(_two_sessions)
    s = mine.summary()
    assert s["finished"] == 2 and s["tokens_out"] == 4
    assert s["ttft_chunks"]["p50"] == 1.0
    assert s["itl_chunks"]["p99"] == 1.0
    assert s["queue_wait_chunks"]["p50"] == 1.0
    assert s["ttft_seconds_warm"]["n"] == 2
    assert all(v >= 0.0 for k, v in s["ttft_seconds_warm"].items()
               if k != "n")
    assert s["slo"]["ttft_attainment"] == 1.0
    assert s["pool_occupancy_mean"] == 0.5
    assert s["spec_decode"] is None
    assert _no_wall(s) == _no_wall(ref.summary())
    assert mine.occupancy == ref.occupancy


def test_session_record_single_token_stream_meets_itl():
    rec = SessionRecord(sid=0, slo_itl_chunks=1)
    rec.tokens_out = 1
    assert rec.itl_ok is True
    ref = JM.SessionRecord(sid=0, slo_itl_chunks=1)
    ref.tokens_out = 1
    assert (rec.itl_ok, rec.slo_ok, rec.ttft_ok) == \
        (ref.itl_ok, ref.slo_ok, ref.ttft_ok)


def _spills_and_spec(tel, make):
    """Spills, resumes and speculative rounds (the block that stays None
    in the port's scheduler until it decodes speculatively)."""
    s = make(slo_itl_chunks=1)
    tel.on_submit(s, clock=0)
    tel.on_admit(s, clock=0, source="cold")
    tel.on_tokens(s, 1, clock=0, compiled=False)
    tel.on_spill(s, clock=1)
    tel.on_admit(s, clock=3, source="resume")
    tel.on_tokens(s, 3, clock=3, compiled=False)
    tel.on_spec(s, drafted=4, accepted=2)
    tel.on_spec(s, drafted=4, accepted=0)
    tel.on_retire(s, clock=3)


def test_telemetry_spills_resumes_and_spec_equal_jax():
    mine, ref = _both(_spills_and_spec)
    s = mine.summary()
    assert s["spills"] == s["resumes"] == 1
    assert s["slo"]["attainment"] == 0.0            # a gap of 3 chunks
    assert s["spec_decode"]["rounds"] == 2
    assert s["spec_decode"]["acceptance_rate"] == 0.25
    assert _no_wall(s) == _no_wall(ref.summary())
    assert _records(mine) == _records(ref)
