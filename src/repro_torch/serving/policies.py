"""Scheduler policies of the port (the JAX package's ``serving/policies.py``):
the ``SchedulerPolicy`` protocol and ``FifoPolicy``.

``serving/scheduler.py`` keeps the mechanisms (page allocation, slot
bookkeeping, state transitions) and delegates every decision to a policy:
which queued request takes a vacated slot and in which tier, which slot
holder is recomputed away when a grower runs out of pages, and which rows
escalate or de-escalate between arena tiers. ``PriorityPolicy`` and
``SloAwarePolicy`` are not ported yet (ROADMAP A10).
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Optional, Protocol, runtime_checkable

from repro_torch.serving.paged_cache import pages_needed
from repro_torch.serving.request import STANDARD, SloClass

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serving.scheduler import Request, Scheduler


def slo_of(req: "Request") -> SloClass:
    """A request's service class (STANDARD when unset)."""
    return req.slo if req.slo is not None else STANDARD


def derive_deadlines(sampling, slo: SloClass, arrival: float,
                     scale: float) -> tuple[float, float]:
    """(ttft_deadline, deadline) in absolute engine ticks, ``math.inf`` =
    none. An explicit ``SamplingParams.deadline`` budget wins for the total
    deadline; otherwise, with ``scale > 0`` and finite class targets, the
    scaled class targets become the budgets."""
    ttft_deadline = deadline = math.inf
    if math.isfinite(sampling.deadline):
        deadline = arrival + sampling.deadline
    elif scale > 0 and math.isfinite(slo.ttft_target) \
            and math.isfinite(slo.itl_target):
        deadline = arrival + scale * (slo.ttft_target
                                      + sampling.max_tokens * slo.itl_target)
    if scale > 0 and math.isfinite(slo.ttft_target):
        ttft_deadline = arrival + scale * slo.ttft_target
    return ttft_deadline, deadline


@runtime_checkable
class SchedulerPolicy(Protocol):
    """Decision interface consulted by ``Scheduler``. Implementations must
    be deterministic functions of scheduler state (serving is replayable)."""

    name: str

    def admission_order(self, sched: "Scheduler", now: float
                        ) -> list["Request"]:
        """Admission preference order over queued requests (may contain
        not-yet-arrived requests; ``select_admission`` filters those)."""
        ...

    def select_admission(self, sched: "Scheduler", now: float
                         ) -> Optional[tuple["Request", int]]:
        """(request to admit, tier), or None to leave the slot empty."""
        ...

    def preemption_victim(self, sched: "Scheduler", exclude: "Request"
                          ) -> Optional["Request"]:
        ...

    def escalation_candidate(self, sched: "Scheduler") -> Optional["Request"]:
        ...

    def deescalation_candidate(self, sched: "Scheduler") -> Optional["Request"]:
        ...


class FifoPolicy:
    """Head-of-queue admission (no bypass), watermark tier assignment,
    youngest-same-arena preemption, longest-dense escalation, and no
    de-escalation unless ``deescalate=True``."""

    name = "fifo"

    def __init__(self, deescalate: bool = False):
        self.deescalate = deescalate

    def _arrived(self, sched: "Scheduler", now: float) -> list["Request"]:
        return [r for r in sched.queue if r.arrival <= now]

    def admission_order(self, sched: "Scheduler", now: float
                        ) -> list["Request"]:
        return list(sched.queue)[:1] if self._arrived(sched, now) else []

    def _fit_tier(self, sched: "Scheduler", req: "Request") -> Optional[int]:
        """Watermark tier assignment plus arena fit; a de-escalation replay
        (``req.recovering``) is pinned to the dense tier."""
        tier = 0
        if (sched.tiered and not req.recovering
                and sched.free_frac() < sched.cfg.low_watermark):
            tier = 1
        need = pages_needed(len(req.context), sched.cfg.page_size)
        if not sched._arena(tier).can_alloc(need):
            if (tier == 0 and sched.tiered and not req.recovering
                    and sched.cpq_alloc.can_alloc(need)):
                tier = 1
            else:
                return None
        return tier

    def select_admission(self, sched, now):
        for req in self.admission_order(sched, now):
            if req.arrival > now:
                continue
            tier = self._fit_tier(sched, req)
            if tier is None:
                return None  # no bypass: the chosen request blocks the slot
            return req, tier
        return None

    def preemption_victim(self, sched, exclude):
        """Youngest slot holder in the same arena as the blocked request."""
        cands = [r for r in sched.occupied()
                 if r is not exclude and r.tier == exclude.tier]
        return max(cands, key=lambda r: r.admitted_step, default=None)

    @staticmethod
    def _cpq_fits(sched, r) -> bool:
        need = pages_needed(r.length + 1, sched.cfg.page_size)
        return (need <= sched.cfg.max_blocks_per_slot
                and sched.cpq_alloc.can_alloc(need))

    def escalation_candidate(self, sched):
        """Under critical pressure: the longest running dense request whose
        compressed footprint fits the CPQ arena."""
        if sched.free_frac() >= sched.cfg.critical_watermark:
            return None
        cands = [r for r in sched.running() if r.tier == 0]
        for r in sorted(cands, key=lambda r: -r.length):
            if self._cpq_fits(sched, r):
                return r
        return None

    def deescalation_candidate(self, sched):
        if not self.deescalate:
            return None
        if sched.free_frac() <= sched.cfg.high_watermark:
            return None
        cands = [r for r in sched.running() if r.tier == 1]
        for r in sorted(cands, key=lambda r: r.length):
            need = pages_needed(len(r.context) + 1, sched.cfg.page_size)
            if sched.dense_alloc.can_alloc(need):
                return r
        return None


def make_policy(name: str, **kw) -> SchedulerPolicy:
    """Policy factory for config strings. Only ``fifo`` is ported."""
    if name == "fifo":
        return FifoPolicy(**kw)
    if name in ("priority", "slo"):
        raise NotImplementedError(
            f"scheduler policy {name!r} is not ported yet (ROADMAP A10)")
    raise ValueError(f"unknown scheduler policy {name!r}; choose from "
                     "['fifo', 'priority', 'slo']")
