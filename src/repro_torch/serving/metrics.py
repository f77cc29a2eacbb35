"""Per-session serving telemetry for the slot scheduler.

The engine-level ``StepStats`` answer "how fast is one decode chunk";
they say nothing about what a *request* experienced — how long it sat in
the queue, when its first token landed, how spill gaps stretched its
inter-token latency, whether it met its SLO.  This module adds that
request-level view: :class:`ServingTelemetry` is an observer the
scheduler drives through small ``on_*`` hooks, accumulating one
:class:`SessionRecord` per session plus a pool-occupancy timeline, and
summarising to p50/p99 on demand.

Two clocks are recorded side by side:

* **chunks** — the scheduler's deterministic tick (one ``step()`` = one
  chunk).  TTFT / queue-wait / inter-token gaps in chunk units are a
  pure function of the trace and policy, identical across hosts, and
  the basis for SLO attainment (SLO targets are expressed in chunks).
* **wall seconds** — measured TTFT per session, *excluding* sessions
  whose first chunk was a first dispatch, following the
  ``StepStats.compiled`` convention: the scheduler reports whether each
  tick was the first of its (kind, signature) (``engine.tag_compiled``:
  on the card, a kernel library's first load and the first launch of a
  shape; in JAX, a fresh jit signature) and ``on_tokens`` taints the
  TTFT of sessions whose first token rode such a dispatch.  The wall
  clock is read after the host sync that delivers the token.

Percentiles use the nearest-rank method on sorted samples — no
interpolation, so a p99 is always a latency some real session saw.
(A copy of the JAX package's ``serving/metrics.py``, whole: the
speculative-decoding block stays None until the port decodes
speculatively; the port imports nothing of it.)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

__all__ = ["SessionRecord", "ServingTelemetry", "percentile"]


def percentile(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on no samples."""
    if not samples:
        return None
    xs = sorted(samples)
    rank = max(1, -(-len(xs) * q // 100))        # ceil(n * q / 100)
    return float(xs[min(int(rank), len(xs)) - 1])


@dataclasses.dataclass
class SessionRecord:
    """Everything telemetry knows about one session's lifetime."""

    sid: int
    prompt_len: int = 0
    max_new_tokens: int = 0
    priority: int = 0
    slo_ttft_chunks: Optional[int] = None
    slo_itl_chunks: Optional[int] = None
    submit_clock: Optional[int] = None
    first_admit_clock: Optional[int] = None      # first time in a slot
    ttft_chunks: Optional[int] = None            # submit -> first token
    ttft_seconds: Optional[float] = None         # wall; None if compile-hit
    ttft_compiled: bool = False                  # first token hit a compile
    itl_gaps_chunks: List[int] = dataclasses.field(default_factory=list)
    last_token_clock: Optional[int] = None
    tokens_out: int = 0
    spills: int = 0
    resumes: int = 0
    retire_clock: Optional[int] = None
    done: bool = False
    # speculative decoding: per-slot draft/accept totals (verify-exact,
    # so these are throughput figures — never stream content)
    spec_rounds: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Accepted draft tokens / drafted tokens (the bonus token is
        excluded from both sides: it is sequential progress, not a
        speculation win).  None when the session never speculated."""
        if self.spec_drafted == 0:
            return None
        return self.spec_accepted / self.spec_drafted

    @property
    def queue_wait_chunks(self) -> Optional[int]:
        if self.submit_clock is None or self.first_admit_clock is None:
            return None
        return self.first_admit_clock - self.submit_clock

    @property
    def ttft_ok(self) -> Optional[bool]:
        """SLO attainment for TTFT; None when the session has no TTFT
        SLO or never produced a token (a starved SLO session counts as
        a miss, not a non-sample — see ``met`` below)."""
        if self.slo_ttft_chunks is None:
            return None
        if self.ttft_chunks is None:
            return False
        return self.ttft_chunks <= self.slo_ttft_chunks

    @property
    def itl_ok(self) -> Optional[bool]:
        if self.slo_itl_chunks is None:
            return None
        if not self.itl_gaps_chunks:
            return True                          # single-token stream
        return max(self.itl_gaps_chunks) <= self.slo_itl_chunks

    @property
    def slo_ok(self) -> Optional[bool]:
        """Joint attainment over whichever SLOs the session carries."""
        parts = [p for p in (self.ttft_ok, self.itl_ok) if p is not None]
        if not parts:
            return None
        return all(parts)


class ServingTelemetry:
    """Scheduler observer: one record per session + pool timeline.

    The scheduler calls the ``on_*`` hooks; nothing here touches device
    state, so telemetry can never perturb token streams.  All hooks are
    idempotent-by-sid where re-entry is possible (re-admission after a
    spill updates counters, not identity).
    """

    def __init__(self):
        self.records: Dict[int, SessionRecord] = {}
        self.occupancy: List[dict] = []          # one sample per tick
        self._submit_wall: Dict[int, float] = {}

    # -- lifecycle hooks (called by SlotScheduler) ------------------------
    def on_submit(self, session, clock: int) -> None:
        rec = self.records.get(session.sid)
        if rec is None:
            rec = SessionRecord(sid=session.sid)
            self.records[session.sid] = rec
            rec.prompt_len = len(session.prompt)
            rec.max_new_tokens = session.max_new_tokens
            rec.priority = session.priority
            rec.slo_ttft_chunks = session.slo_ttft_chunks
            rec.slo_itl_chunks = session.slo_itl_chunks
            rec.submit_clock = clock
            self._submit_wall[session.sid] = time.perf_counter()

    def on_admit(self, session, clock: int, source: str) -> None:
        rec = self.records[session.sid]
        if rec.first_admit_clock is None:
            rec.first_admit_clock = clock
        if source == "resume":
            rec.resumes += 1

    def on_spill(self, session, clock: int) -> None:
        self.records[session.sid].spills += 1

    def on_tokens(self, session, n_new: int, clock: int,
                  compiled: bool) -> None:
        """``n_new`` tokens delivered to ``session`` at tick ``clock``;
        ``compiled`` is whether the dispatch that produced them was the
        first of its signature (taints wall-TTFT, ``tag_compiled``)."""
        if n_new <= 0:
            return
        rec = self.records[session.sid]
        if rec.tokens_out == 0:
            rec.ttft_chunks = (clock - rec.submit_clock
                               if rec.submit_clock is not None else None)
            rec.ttft_compiled = compiled
            wall = self._submit_wall.get(session.sid)
            rec.ttft_seconds = None if (compiled or wall is None) \
                else time.perf_counter() - wall
        elif rec.last_token_clock is not None:
            # n_new tokens landed this tick: the inter-tick gap belongs
            # to the first of them, the rest arrived within one chunk
            rec.itl_gaps_chunks.append(clock - rec.last_token_clock)
            rec.itl_gaps_chunks.extend([0] * (n_new - 1))
        rec.last_token_clock = clock
        rec.tokens_out += n_new

    def on_spec(self, session, drafted: int, accepted: int) -> None:
        """One speculative verify round for ``session``: ``drafted``
        tokens proposed, ``accepted`` of them verified-exact (bonus
        token excluded from both counts)."""
        rec = self.records[session.sid]
        rec.spec_rounds += 1
        rec.spec_drafted += drafted
        rec.spec_accepted += accepted

    def on_retire(self, session, clock: int) -> None:
        rec = self.records[session.sid]
        rec.retire_clock = clock
        rec.done = True

    def on_tick(self, clock: int, n_active: int, n_pending: int,
                free_pages: Optional[int], total_pages: Optional[int]
                ) -> None:
        self.occupancy.append({
            "clock": clock, "active": n_active, "pending": n_pending,
            "free_pages": free_pages, "total_pages": total_pages,
        })

    # -- aggregation ------------------------------------------------------
    def summary(self) -> dict:
        """Aggregate to the serving bench's per-run block: p50/p99
        TTFT (chunks + warm wall-seconds), inter-token gaps, queue wait,
        SLO attainment, spill/resume totals, mean pool occupancy."""
        recs = list(self.records.values())
        ttft_c = [r.ttft_chunks for r in recs if r.ttft_chunks is not None]
        ttft_s = [r.ttft_seconds for r in recs if r.ttft_seconds is not None]
        waits = [r.queue_wait_chunks for r in recs
                 if r.queue_wait_chunks is not None]
        gaps = [g for r in recs for g in r.itl_gaps_chunks]
        slo = [r.slo_ok for r in recs if r.slo_ok is not None]
        ttft_slo = [r.ttft_ok for r in recs if r.ttft_ok is not None]
        occ = [o for o in self.occupancy if o["total_pages"]]
        return {
            "sessions": len(recs),
            "finished": sum(r.done for r in recs),
            "tokens_out": sum(r.tokens_out for r in recs),
            "ttft_chunks": {"p50": percentile(ttft_c, 50),
                            "p99": percentile(ttft_c, 99)},
            "ttft_seconds_warm": {"p50": percentile(ttft_s, 50),
                                  "p99": percentile(ttft_s, 99),
                                  "n": len(ttft_s)},
            "ttft_compile_excluded": sum(r.ttft_compiled for r in recs),
            "itl_chunks": {"p50": percentile(gaps, 50),
                           "p99": percentile(gaps, 99)},
            "queue_wait_chunks": {"p50": percentile(waits, 50),
                                  "p99": percentile(waits, 99)},
            "slo": {
                "sessions_with_slo": len(slo),
                "attainment": (sum(slo) / len(slo)) if slo else None,
                "ttft_attainment": (sum(ttft_slo) / len(ttft_slo))
                if ttft_slo else None,
            },
            "spills": sum(r.spills for r in recs),
            "resumes": sum(r.resumes for r in recs),
            "spec_decode": self._spec_summary(recs),
            "pool_occupancy_mean": (
                sum(1.0 - o["free_pages"] / o["total_pages"] for o in occ)
                / len(occ)) if occ else None,
        }

    @staticmethod
    def _spec_summary(recs) -> Optional[dict]:
        """Speculative-decoding block: None when nothing speculated."""
        spec = [r for r in recs if r.spec_rounds]
        if not spec:
            return None
        rates = [r.acceptance_rate for r in spec
                 if r.acceptance_rate is not None]
        drafted = sum(r.spec_drafted for r in spec)
        accepted = sum(r.spec_accepted for r in spec)
        rounds = sum(r.spec_rounds for r in spec)
        return {
            "sessions": len(spec),
            "rounds": rounds,
            "drafted": drafted,
            "accepted": accepted,
            "acceptance_rate": (accepted / drafted) if drafted else None,
            "acceptance_rate_p50": percentile(rates, 50),
            "tokens_per_round": (
                (accepted + rounds) / rounds) if rounds else None,
        }
