"""Deterministic fault injection of the port (the JAX package's
``serving/faults.py``): ``FaultEvent``, ``FaultPlan`` and ``FaultyReplica``.

A fault is part of the simulation, not of the wall clock, so a chaos run
can be replayed, bisected and held token for token against a fault-free
run:

  ``FaultEvent``     one scheduled fault: from tick ``tick`` of the
                     wrapper's own event clock, behave as ``kind`` for
                     ``duration`` consecutive clock advances.
  ``FaultPlan``      an immutable schedule of events. ``FaultPlan.random``
                     derives one from a seed through
                     ``np.random.default_rng``, exactly as the reference
                     does, so a seed gives the reference's events.
  ``FaultyReplica``  a transparent wrapper around a
                     ``ContinuousServeEngine`` that consults the plan on
                     every ``step()`` and ``health()`` call and misbehaves
                     on schedule. Everything else forwards to the engine.

Fault kinds:

  ``crash``    ``step()`` / ``health()`` raise ``ReplicaFault`` before
               touching the engine, whose state stays as the previous tick
               left it (fail-stop), so a later ``drain()`` snapshot replays
               token for token. A crashed tick launches nothing.
  ``stall``    ``step()`` returns no outputs and does no work; ``health()``
               succeeds but shows no progress.
  ``exhaust``  the replica reports a full arena (``free_frac`` 0.0 and an
               ``exhausted`` flag) while stepping normally.

The wrapper clock advances once per ``step()`` and once per ``health()``
probe. A drained replica is no longer stepped, but the health monitor
keeps probing it on backoff, and those probes move its clock through the
fault window: a crashed replica recovers a fixed number of probes later.

Only ``ReplicaFault`` stands for an injected failure. The router catches
nothing else from ``step()``: a kernel's build or launch error, or any
CUDA error, leaves the router and fails the run.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FAULT_KINDS = ("crash", "stall", "exhaust")


class ReplicaFault(RuntimeError):
    """Raised by a ``FaultyReplica`` during an active ``crash`` window.

    The router catches it per replica (``HealthMonitor.note_fault``); it
    escaping a test means a caller stepped a replica outside the router."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault window: [tick, tick + duration) on the wrapper's
    event clock."""

    tick: int
    kind: str
    duration: int = 1

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, self.kind
        assert self.tick >= 0 and self.duration >= 1

    def active_at(self, clock: int) -> bool:
        return self.tick <= clock < self.tick + self.duration


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable fault schedule. Overlapping windows resolve to the
    earliest event (ties by position in ``events``). An empty plan is a
    no-op wrapper (the control arm)."""

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    def active_at(self, clock: int):
        """The governing FaultEvent at ``clock``, or None."""
        live = [e for e in self.events if e.active_at(clock)]
        return min(live, key=lambda e: e.tick) if live else None

    def horizon(self) -> int:
        """First clock tick past every window (0 for the empty plan)."""
        return max((e.tick + e.duration for e in self.events), default=0)

    @classmethod
    def random(cls, seed: int, horizon: int = 32, n_events: int = 2,
               kinds=FAULT_KINDS, max_duration: int = 3) -> "FaultPlan":
        """Seed-derived schedule: ``n_events`` faults at ticks in
        [1, horizon) with durations in [1, max_duration]. Same seed, same
        plan, and the reference's plan."""
        rng = np.random.default_rng(seed)
        kinds = tuple(kinds)
        events = []
        for _ in range(n_events):
            events.append(FaultEvent(
                tick=int(rng.integers(1, max(horizon, 2))),
                kind=kinds[int(rng.integers(len(kinds)))],
                duration=int(rng.integers(1, max_duration + 1))))
        return cls(tuple(sorted(events, key=lambda e: (e.tick, e.kind))))


class FaultyReplica:
    """Transparent fault-injecting wrapper around a serve engine.

    Every attribute not intercepted here forwards to the wrapped engine, so
    ``adopt_compiled``, ``drain``, ``stats`` and the rest behave as the
    engine's. Only ``step`` / ``health`` / ``arena_stats`` consult the plan.
    ``faults_injected`` counts fired windows by kind."""

    def __init__(self, engine, plan: FaultPlan):
        self.engine = engine
        self.plan = plan
        self.clock = 0
        self.faults_injected = {k: 0 for k in FAULT_KINDS}

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def _advance(self):
        ev = self.plan.active_at(self.clock)
        self.clock += 1
        if ev is not None:
            self.faults_injected[ev.kind] += 1
        return ev

    # -- intercepted surface ----------------------------------------------

    def step(self):
        ev = self._advance()
        if ev is not None and ev.kind == "crash":
            # raise before the inner step: fail-stop, state untouched
            raise ReplicaFault(
                f"injected crash (tick {self.clock - 1}, event @{ev.tick})")
        if ev is not None and ev.kind == "stall":
            return []  # wedged: alive, no work done, no outputs
        return self.engine.step()

    def health(self) -> dict:
        ev = self._advance()
        if ev is not None and ev.kind == "crash":
            raise ReplicaFault(
                f"injected crash on probe (tick {self.clock - 1})")
        h = self.engine.health()
        if ev is not None and ev.kind == "exhaust":
            h = dict(h, free_frac=0.0, exhausted=True)
        return h

    def arena_stats(self) -> dict:
        ev = self.plan.active_at(self.clock)  # peek: stats don't advance
        st = self.engine.arena_stats()
        if ev is not None and ev.kind == "exhaust":
            st = dict(st, free_frac=0.0)
        return st
