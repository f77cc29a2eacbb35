"""Pluggable scheduling policies for the slot scheduler.

The :class:`~repro_torch.serving.scheduler.SlotScheduler` owns the *mechanism*
of serving — slot surgery, page accounting, spill/restore, the
starvation-free overtake budget — and delegates three *decisions* to a
:class:`SchedulingPolicy`:

* **admission order** (``order_pending``) — which pending session to try
  first when slots/pages free up.  The scheduler still enforces FIFO
  fairness underneath: every admission past the oldest blocked session
  (cold or resume-sourced) consumes one unit of its bounded overtake
  budget, and a spent budget forces strict arrival order until that
  session admits — so no policy can starve a request, only re-order
  within the budget.
* **admission control** (``defer_admission``) — whether to hold back an
  admissible session anyway, e.g. to keep pool pages free for a
  tighter-deadline request that does not fit yet.  Deferral is advisory:
  it is never applied to the protected queue head, so it cannot
  deadlock the scheduler.
* **preemption victims** (``select_victims``) — which ripe slots to
  spill when sessions wait.  The scheduler reports a per-slot
  ``spill_cost`` (estimated snapshot bytes + re-admission cost) so a
  policy can prefer cheap victims: a tconst slot's physical KV is O(1)
  and its admission is a pure function of the prompt
  (``DecodeAPI.admission_key``), so spilling it is nearly free, while a
  long-resident dense-LM slot pays O(tokens) bytes both ways.

Two policies ship:

* :class:`FifoPolicy` — the baseline: arrival order with the bounded
  skip-ahead, ripe-longest-resident-first preemption (exactly the
  pre-policy scheduler behaviour).
* :class:`DeadlineCostPolicy` — SLO-aware: admissions ordered by TTFT
  deadline slack then priority, cost-aware victim selection, and
  pool-pressure admission control that defers slack-rich sessions when
  a tighter-deadline session is blocked on pages.

Every hook is a pure function of host-side scheduler state — policies
never touch device tensors (``spill_cost`` is arithmetic on tensor
metadata), so switching policies can never change a session's token
stream (asserted per trace position by the port's policy tests and
``chip_smoke.py``).  (A copy of the JAX package's ``serving/policy.py``;
the port imports nothing of it.)
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, List

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serving.scheduler import SlotScheduler
    from repro_torch.serving.session import Session


class SchedulingPolicy:
    """Decision seam consumed by ``SlotScheduler`` (see module doc)."""

    name = "base"

    def order_pending(self, pending: List["Session"],
                      sched: "SlotScheduler") -> List["Session"]:
        """Return the pending sessions in the order admission should try
        them.  Must be a permutation of ``pending`` (the scheduler keeps
        the arrival-order queue itself — this is only the try order)."""
        return list(pending)

    def defer_admission(self, sched: "SlotScheduler", session: "Session",
                        plan: dict) -> bool:
        """True to hold back an admissible ``session`` this round (pool-
        pressure admission control).  Never consulted for the protected
        arrival-order head, so deferral cannot starve or deadlock."""
        return False

    def select_victims(self, sched: "SlotScheduler", ripe: List[int],
                       n: int) -> List[int]:
        """Choose up to ``n`` slots to preempt-spill out of the ``ripe``
        candidates (slots that decoded >= ``preempt_chunks`` chunks this
        residency)."""
        return ripe[:n]


class FifoPolicy(SchedulingPolicy):
    """Baseline: FIFO admission with the scheduler's bounded skip-ahead,
    ripe-longest-resident-first preemption — the pre-policy behaviour,
    kept as an explicit object so benches can name it."""

    name = "fifo"

    def select_victims(self, sched: "SlotScheduler", ripe: List[int],
                       n: int) -> List[int]:
        return sorted(ripe, key=lambda s: -int(sched._slot_chunks[s]))[:n]


def ttft_slack(session: "Session", now: int) -> float:
    """Chunks until the session's TTFT deadline (negative = missed);
    sessions without a TTFT SLO have infinite slack."""
    if session.slo_ttft_chunks is None or session.submit_clock is None:
        return math.inf
    return (session.submit_clock + session.slo_ttft_chunks) - now


class DeadlineCostPolicy(SchedulingPolicy):
    """Deadline- and cost-aware scheduling.

    * Admission tries pending sessions by ``(TTFT slack, -priority)``
      (stable, so equal-urgency sessions keep arrival order).
    * ``defer_admission`` holds back a session with ``defer_slack`` or
      more chunks of headroom when admitting it would leave the free
      pool too small for a *tighter*-slack session that is still
      blocked on pages.
    * Victims are the cheapest ripe slots by ``SlotScheduler.spill_cost``
      (snapshot bytes + re-admission bytes; a family whose admission is
      prompt-pure — tconst/tlin via ``admission_key`` — re-admits for
      free, so its cost is the tiny O(1) snapshot alone).  Slots whose
      session carries an inter-token SLO are spilled last: a spill gap
      is exactly what breaks that SLO.
    """

    name = "slo"

    def __init__(self, defer_slack: int = 4):
        if defer_slack < 0:
            raise ValueError("defer_slack must be >= 0 chunks")
        self.defer_slack = defer_slack

    def order_pending(self, pending, sched):
        now = sched.clock
        return sorted(pending, key=lambda s: (ttft_slack(s, now),
                                              -s.priority))

    def defer_admission(self, sched, session, plan):
        if not sched._paged or sched.n_active == 0:
            # deferral only manages POOL pressure, and deferring with
            # nothing active could stall the scheduler outright
            return False
        mine = ttft_slack(session, sched.clock)
        if mine < self.defer_slack:
            return False                       # too urgent to hold back
        adopted = len(plan.get("adopted", ()))
        free_after = len(sched.free_pages) - (plan.get("total", 0) - adopted)
        for other in sched.pending:
            if other is session:
                continue
            if ttft_slack(other, sched.clock) >= mine:
                continue
            need = sched._pages_needed(other)
            if need > len(sched.free_pages):   # other is page-blocked now
                if free_after < need:          # and we'd keep it blocked
                    return True
        return False

    def select_victims(self, sched, ripe, n):
        def cost(slot: int):
            session = sched.sessions[slot]
            itl_bound = session is not None and \
                session.slo_itl_chunks is not None
            return (itl_bound, sched.spill_cost(slot)["total"],
                    -int(sched._slot_chunks[slot]))
        return sorted(ripe, key=cost)[:n]


_POLICIES = {"fifo": FifoPolicy, "slo": DeadlineCostPolicy}


def get_policy(name: str) -> SchedulingPolicy:
    """Instantiate a policy by its registry name ("fifo" | "slo")."""
    try:
        return _POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown scheduling policy {name!r} — "
                         f"choose from {sorted(_POLICIES)}") from None
