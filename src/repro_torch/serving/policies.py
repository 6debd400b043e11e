"""Scheduler and placement policies of the port (the JAX package's
``serving/policies.py``): the ``SchedulerPolicy`` protocol, ``FifoPolicy``,
``PriorityPolicy`` and ``SloAwarePolicy``; the router's ``PlacementPolicy``
protocol over ``ReplicaView`` and ``make_placement``.

``serving/scheduler.py`` keeps the mechanisms (page allocation, slot
bookkeeping, state transitions) and delegates every decision to a policy:
which queued request takes a vacated slot and in which tier, which slot
holder is recomputed away when a grower runs out of pages, and which rows
escalate or de-escalate between arena tiers.

  ``FifoPolicy``      head-of-queue admission (no bypass), watermark tier
                      assignment, youngest-same-arena preemption,
                      longest-dense escalation, no de-escalation unless
                      opted in.
  ``PriorityPolicy``  strict ``SloClass.priority`` classes with aging: a
                      queued request gains one effective level per
                      ``aging_ticks`` waited; preemption and escalation pick
                      low-priority rows first.
  ``SloAwarePolicy``  earliest-deadline-first admission by projected TTFT
                      slack, low-priority victims, and de-escalation on by
                      default.

The replica placement policies decide where ``ReplicaRouter`` places a
new request, over ``ReplicaView`` snapshots of the replicas:

  ``RoundRobinPlacement``   cycles over the offered replicas.
  ``LeastLoadedPlacement``  least outstanding tokens first.
  ``SloPressurePlacement``  latency-bound requests to the freest arena,
                            batch work by least outstanding tokens.
"""
from __future__ import annotations

import dataclasses
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

    def _deesc_order(self, cands: list["Request"]) -> list["Request"]:
        """Recovery preference among escalated rows: shortest context first
        (cheapest recompute)."""
        return sorted(cands, key=lambda r: r.length)

    def deescalation_candidate(self, sched):
        if not self.deescalate:
            return None
        if sched.free_frac() <= sched.cfg.high_watermark:
            return None  # hysteresis: recover only with real headroom
        cands = [r for r in sched.running() if r.tier == 1]
        for r in self._deesc_order(cands):
            need = pages_needed(len(r.context) + 1, sched.cfg.page_size)
            if sched.dense_alloc.can_alloc(need):
                return r
        return None


class PriorityPolicy(FifoPolicy):
    """Strict priority classes with aging. Admission picks the highest
    effective priority, ``priority + waited // aging_ticks``, ties by
    arrival order; preemption and escalation spend low-priority rows
    first."""

    name = "priority"

    def __init__(self, aging_ticks: int = 64, deescalate: bool = False):
        super().__init__(deescalate=deescalate)
        assert aging_ticks >= 1
        self.aging_ticks = aging_ticks

    def effective_priority(self, req: "Request", now: float) -> float:
        return slo_of(req).priority + (max(0.0, now - req.arrival)
                                       // self.aging_ticks)

    def admission_order(self, sched, now):
        arrived = self._arrived(sched, now)
        order = {id(r): i for i, r in enumerate(sched.queue)}
        return sorted(arrived,
                      key=lambda r: (-self.effective_priority(r, now),
                                     r.arrival, order[id(r)]))[:1]

    def preemption_victim(self, sched, exclude):
        cands = [r for r in sched.occupied()
                 if r is not exclude and r.tier == exclude.tier]
        return max(cands,
                   key=lambda r: (-slo_of(r).priority, r.admitted_step),
                   default=None)

    def escalation_candidate(self, sched):
        if sched.free_frac() >= sched.cfg.critical_watermark:
            return None
        cands = [r for r in sched.running() if r.tier == 0]
        for r in sorted(cands, key=lambda r: (slo_of(r).priority, -r.length)):
            if self._cpq_fits(sched, r):
                return r
        return None

    def _deesc_order(self, cands):
        """Restore full-quality (dense) attention to important rows first."""
        return sorted(cands, key=lambda r: (-slo_of(r).priority, r.length))


class SloAwarePolicy(PriorityPolicy):
    """Earliest-deadline-first admission by projected TTFT slack: slack =
    ``ttft_target - (waited + the context's prefill chunk ticks)``, least
    slack first, infinite targets last (by priority, then arrival).
    Victims as ``PriorityPolicy``; de-escalation on by default."""

    name = "slo"

    def __init__(self, aging_ticks: int = 64, deescalate: bool = True):
        super().__init__(aging_ticks=aging_ticks, deescalate=deescalate)

    def projected_ttft(self, sched: "Scheduler", req: "Request",
                       now: float) -> float:
        quantum = sched.cfg.prefill_chunk or sched.cfg.prefill_bucket
        chunks = -(-len(req.context) // quantum)
        return (now - req.arrival) + chunks

    def admission_order(self, sched, now):
        arrived = self._arrived(sched, now)
        order = {id(r): i for i, r in enumerate(sched.queue)}

        def key(r):
            slo = slo_of(r)
            slack = slo.ttft_target - self.projected_ttft(sched, r, now)
            return (math.isinf(slack), slack, -slo.priority, r.arrival,
                    order[id(r)])

        return sorted(arrived, key=key)[:1]


_POLICIES = {"fifo": FifoPolicy, "priority": PriorityPolicy,
             "slo": SloAwarePolicy}


def make_policy(name: str, **kw) -> SchedulerPolicy:
    """Policy factory for config strings: fifo | priority | slo."""
    try:
        return _POLICIES[name](**kw)
    except KeyError:
        raise ValueError(f"unknown scheduler policy {name!r}; "
                         f"choose from {sorted(_POLICIES)}") from None


# --------------------------------------------------- replica placement (router)


@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """Read-only snapshot of one engine replica at placement time (built by
    ``ReplicaRouter`` from public engine surfaces; draining replicas are
    never offered). ``outstanding_tokens`` is the replica's owed work
    (``engine.outstanding_tokens()``: unprefilled context + undelivered
    generation budget); ``free_frac`` its dense free-page fraction
    (``engine.arena_stats()``); ``queued`` the number of requests waiting
    in its admission queue (saturation signal for backpressure)."""

    index: int
    outstanding_tokens: int
    free_frac: float
    queued: int = 0


@runtime_checkable
class PlacementPolicy(Protocol):
    """Where a request runs: consulted by ``ReplicaRouter.add_request`` with
    the non-draining replicas (ordered by index, never empty) after session
    affinity. Must return the ``.index`` of one offered view,
    deterministically."""

    name: str

    def select(self, views: list[ReplicaView], req: "Request") -> int:
        ...


class RoundRobinPlacement:
    """Cycle over the offered replicas in order; a drained replica drops out
    of the rotation."""

    name = "rr"

    def __init__(self):
        self._turn = 0

    def select(self, views, req):
        v = views[self._turn % len(views)]
        self._turn += 1
        return v.index


class LeastLoadedPlacement:
    """Least outstanding tokens first (ties by replica index): balances the
    owed work (remaining prefill plus undelivered generation budget), not
    request counts."""

    name = "load"

    def select(self, views, req):
        return min(views, key=lambda v: (v.outstanding_tokens, v.index)).index


class SloPressurePlacement:
    """SLO- and arena-pressure-aware placement.

    Latency-bound requests (a finite ``ttft_target`` or priority at or above
    ``interactive_priority``) go to the replica with the most free pages
    (ties: least outstanding); deadline-free batch work packs by least
    outstanding tokens (ties: most free pages)."""

    name = "slo"

    def __init__(self, interactive_priority: int = 2):
        self.interactive_priority = interactive_priority

    def select(self, views, req):
        slo = slo_of(req)
        latency_bound = (math.isfinite(slo.ttft_target)
                         or slo.priority >= self.interactive_priority)
        if latency_bound:
            return max(views, key=lambda v: (v.free_frac,
                                             -v.outstanding_tokens,
                                             -v.index)).index
        return min(views, key=lambda v: (v.outstanding_tokens,
                                         -v.free_frac, v.index)).index


_PLACEMENTS = {"rr": RoundRobinPlacement, "load": LeastLoadedPlacement,
               "slo": SloPressurePlacement}


def make_placement(name: str, **kw) -> PlacementPolicy:
    """Placement factory for config strings: rr | load | slo."""
    try:
        return _PLACEMENTS[name](**kw)
    except KeyError:
        raise ValueError(f"unknown placement policy {name!r}; "
                         f"choose from {sorted(_PLACEMENTS)}") from None
