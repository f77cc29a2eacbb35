"""Seeded, deterministic serving-workload generator.

The scheduler benches need *realistic traffic*, not a handful of
hand-rolled sessions: arrival bursts that oversubscribe the pool,
prompt/output-length mixes, a population of requests sharing a system
prompt (exercising the prefix-sharing pages), and verbatim repeats of
earlier prompts (exercising the O(1) tconst re-admission from the tier
store).
This module turns a :class:`WorkloadSpec` plus one integer seed into a
reproducible list of :class:`Arrival` events — the SAME spec and seed
always produce the same prompts, lengths, arrival chunks, SLO targets
and per-session sampling seeds, so two scheduler runs (e.g. the FIFO
baseline vs the deadline policy) can replay one trace and be compared
session-by-session.  (A copy of the JAX package's ``serving/workload.py``:
the same ``np.random.RandomState`` draws in the same order, so a spec and
seed give the same trace in both packages; the port imports nothing of
it.)

Time is denominated in scheduler *chunks* (one ``SlotScheduler.step``
call = one tick): ``Arrival.at_chunk`` is when the session is submitted
and every SLO target (``slo_ttft_chunks`` / ``slo_itl_chunks``) counts
the same clock, which keeps the workload deterministic across hosts —
wall-clock telemetry rides on top in ``repro_torch.serving.metrics``.

Two arrival processes:

* ``poisson`` — i.i.d. exponential inter-arrival gaps with mean
  ``1 / rate`` chunks (classic open-loop traffic).
* ``bursty`` — an on/off process: burst starts are Poisson with mean
  ``burst_every`` chunks apart and each burst drops
  ``1 + Poisson(burst_size - 1)`` sessions on the same chunk — the
  oversubscription pattern the tier-store spill path exists for.

Length mixes are weighted uniform components ``(weight, lo, hi)`` —
e.g. a 70/30 chat/document mix.  A ``shared_frac`` slice of sessions
prefixes one of ``n_prefixes`` common system prompts (page-align
``prefix_len`` to share whole pages); a ``repeat_frac`` slice re-issues
a previously generated prompt verbatim.  An ``slo_frac`` slice carries
a TTFT deadline and elevated priority (the rest ride best-effort).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.session import Session

Mix = Sequence[Tuple[float, int, int]]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Declarative description of one traffic trace (see module doc)."""

    n_sessions: int
    vocab: int
    # arrival process ------------------------------------------------------
    arrival: str = "poisson"             # "poisson" | "bursty"
    rate: float = 0.5                    # poisson: mean arrivals per chunk
    burst_size: int = 6                  # bursty: mean sessions per burst
    burst_every: float = 24.0            # bursty: mean chunks between bursts
    # request shape --------------------------------------------------------
    prompt_mix: Mix = ((0.7, 8, 24), (0.3, 32, 56))
    output_mix: Mix = ((0.8, 8, 16), (0.2, 20, 32))
    # populations ----------------------------------------------------------
    shared_frac: float = 0.0             # share one of n_prefixes prefixes
    n_prefixes: int = 2
    prefix_len: int = 16                 # page-align to share whole pages
    repeat_frac: float = 0.0             # verbatim re-issue of a past prompt
    # SLOs / priority ------------------------------------------------------
    slo_frac: float = 0.5                # fraction carrying a TTFT SLO
    slo_ttft_chunks: int = 8
    slo_itl_chunks: int = 0              # 0 = no inter-token SLO
    slo_priority: int = 1                # priority for the SLO slice
    temperature: float = 0.0

    def __post_init__(self):
        if self.n_sessions < 1:
            raise ValueError("n_sessions must be >= 1")
        if self.arrival not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival process {self.arrival!r} "
                             f"(poisson | bursty)")
        if self.arrival == "poisson" and self.rate <= 0:
            raise ValueError("poisson arrivals need rate > 0")
        if self.arrival == "bursty" and (self.burst_size < 1 or
                                         self.burst_every <= 0):
            raise ValueError("bursty arrivals need burst_size >= 1 and "
                             "burst_every > 0")
        for frac in (self.shared_frac, self.repeat_frac, self.slo_frac):
            if not 0.0 <= frac <= 1.0:
                raise ValueError("population fractions must be in [0, 1]")
        for mix in (self.prompt_mix, self.output_mix):
            if not mix or any(w <= 0 or lo < 1 or hi < lo
                              for w, lo, hi in mix):
                raise ValueError(f"malformed length mix {mix!r}")


@dataclasses.dataclass
class Arrival:
    """One workload event: submit ``session`` at chunk ``at_chunk``."""

    at_chunk: int
    session: Session


def _sample_mix(rng: np.random.RandomState, mix: Mix) -> int:
    w = np.asarray([m[0] for m in mix], np.float64)
    i = int(rng.choice(len(mix), p=w / w.sum()))
    return int(rng.randint(mix[i][1], mix[i][2] + 1))


def _arrival_chunks(rng: np.random.RandomState,
                    spec: WorkloadSpec) -> np.ndarray:
    if spec.arrival == "poisson":
        gaps = rng.exponential(1.0 / spec.rate, size=spec.n_sessions)
        return np.floor(np.cumsum(gaps)).astype(np.int64)
    # bursty: Poisson burst starts, Poisson(+1) burst sizes
    chunks: List[int] = []
    t = 0.0
    while len(chunks) < spec.n_sessions:
        t += rng.exponential(spec.burst_every)
        size = 1 + rng.poisson(max(spec.burst_size - 1, 0))
        chunks.extend([int(t)] * size)
    return np.asarray(chunks[: spec.n_sessions], np.int64)


def generate_workload(spec: WorkloadSpec, seed: int,
                      max_prompt_len: Optional[int] = None
                      ) -> List[Arrival]:
    """Generate the trace: a list of :class:`Arrival` sorted by
    ``at_chunk``.  Deterministic in ``(spec, seed)`` — session ids are
    process-global, so cross-run identity is by trace POSITION, and each
    session carries its own ``seed`` so its sampled stream is a pure
    function of the trace, not of slot placement or policy (see
    ``Session.seed``).  ``max_prompt_len`` optionally clips prompts (the
    caller knows its ``max_len`` budget)."""
    rng = np.random.RandomState(seed)
    arrivals = _arrival_chunks(rng, spec)
    prefixes = [rng.randint(1, spec.vocab, size=spec.prefix_len)
                .astype(np.int32) for _ in range(spec.n_prefixes)]
    out: List[Arrival] = []
    history: List[np.ndarray] = []
    for i in range(spec.n_sessions):
        u = rng.rand()
        if history and u < spec.repeat_frac:
            prompt = history[int(rng.randint(len(history)))].copy()
        else:
            n = _sample_mix(rng, spec.prompt_mix)
            if u < spec.repeat_frac + spec.shared_frac:
                head = prefixes[int(rng.randint(spec.n_prefixes))]
                tail = rng.randint(1, spec.vocab, size=n).astype(np.int32)
                prompt = np.concatenate([head, tail])
            else:
                prompt = rng.randint(1, spec.vocab,
                                     size=max(n, 1)).astype(np.int32)
        if max_prompt_len is not None:
            prompt = prompt[:max_prompt_len]
        history.append(prompt)
        tight = rng.rand() < spec.slo_frac
        out.append(Arrival(int(arrivals[i]), Session(
            prompt,
            max_new_tokens=_sample_mix(rng, spec.output_mix),
            temperature=spec.temperature,
            seed=int(rng.randint(1 << 31)),
            priority=spec.slo_priority if tight else 0,
            slo_ttft_chunks=spec.slo_ttft_chunks if tight else None,
            slo_itl_chunks=(spec.slo_itl_chunks or None) if tight
            else None)))
    out.sort(key=lambda a: a.at_chunk)
    return out
