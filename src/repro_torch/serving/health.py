"""Health probing and auto-drain of the port's router (the JAX package's
``serving/health.py``): ``ReplicaHealth``, ``HealthMonitor`` and
``BACKOFF_CAP_MULT``.

``ReplicaRouter`` ticks a ``HealthMonitor`` once per ``step()`` on the
router's own clock. Every ``probe_interval`` ticks the monitor probes each
supervised replica through its ``health()``, which is host bookkeeping
only (no device tensor is read, nothing syncs). A probe fails on any of:

  liveness   ``health()`` raises (an injected ``ReplicaFault``)
  pressure   the replica reports an exhausted arena while holding queued
             work: the ``exhausted`` flag, or ``free_frac`` at or below
             ``probe_exhaust_frac`` with a non-empty queue
  progress   the replica had work at the previous probe, still has work,
             and its progress counter (engine tick + admitted + retired)
             has not moved

State machine per replica (``ReplicaHealth.state``):

    healthy --probe fail--> suspect --fail_threshold consecutive--> down
       ^                       |                                      |
       +----probe success------+        (auto_drain: router._auto_drain)
       ^                                                              |
       +------------- recovery probe succeeds (readmit) --------------+

``down`` replicas are probed on exponential backoff (doubling from
``backoff`` up to ``BACKOFF_CAP_MULT`` times it); one successful recovery
probe re-admits the replica through ``router.readmit``. A fault raised
from ``step()`` (``note_fault``) counts as an immediate probe failure.
Replicas the caller drained by hand are neither probed nor re-admitted.
"""
from __future__ import annotations

import dataclasses

BACKOFF_CAP_MULT = 8  # down-replica probe backoff doubles up to 8x base


@dataclasses.dataclass
class ReplicaHealth:
    """Per-replica probe bookkeeping (exposed via router stats)."""

    state: str = "healthy"            # healthy | suspect | down
    consecutive_failures: int = 0
    probe_failures: int = 0           # lifetime count
    probes: int = 0                   # lifetime probe count
    last_probe: int = -1              # monitor clock of last probe
    next_probe: int = 0               # earliest clock of the next probe
    backoff: int = 0                  # current down-state probe gap
    last_progress: int = -1           # progress counter at last good probe
    had_work: bool = False
    drained_at: int = -1              # monitor clock of the auto-drain
    last_error: str = ""


class HealthMonitor:
    """Probes a router's replicas and (optionally) auto-drains the sick.

    ``interval`` 0 disables periodic probing: ``note_fault`` still records
    step() faults, and with ``auto_drain`` it still drains on the threshold
    (recovery probes then run on the backoff schedule)."""

    def __init__(self, router, interval: int = 4, fail_threshold: int = 3,
                 backoff: int = 4, exhaust_frac: float = 0.0,
                 auto_drain: bool = False):
        assert fail_threshold >= 1 and backoff >= 1 and interval >= 0
        self.router = router
        self.interval = interval
        self.fail_threshold = fail_threshold
        self.base_backoff = backoff
        self.exhaust_frac = exhaust_frac
        self.auto_drain = auto_drain
        self.replicas = [ReplicaHealth() for _ in router.engines]
        self.auto_drains = 0
        self.recoveries = 0

    # ------------------------------------------------------------- queries

    def state(self, i: int) -> str:
        return self.replicas[i].state

    def is_down(self, i: int) -> bool:
        return self.replicas[i].state == "down"

    def stats(self) -> dict:
        return {"auto_drains": self.auto_drains,
                "recoveries": self.recoveries,
                "down": sum(1 for r in self.replicas if r.state == "down")}

    # ------------------------------------------------------------- failures

    def note_fault(self, i: int, err: BaseException, now: int) -> None:
        """A replica's ``step()`` raised ``ReplicaFault``: immediate failure
        credit."""
        self._fail(i, f"step: {err}", now)

    def _fail(self, i: int, why: str, now: int) -> None:
        rh = self.replicas[i]
        rh.consecutive_failures += 1
        rh.probe_failures += 1
        rh.last_error = why
        if rh.state == "down":
            # still sick: back off harder (doubling, capped)
            rh.backoff = min(rh.backoff * 2,
                             self.base_backoff * BACKOFF_CAP_MULT)
            rh.next_probe = now + rh.backoff
            return
        rh.state = "suspect"
        if rh.consecutive_failures >= self.fail_threshold:
            rh.state = "down"
            rh.backoff = self.base_backoff
            rh.next_probe = now + rh.backoff
            rh.drained_at = now
            if self.auto_drain:
                self.auto_drains += 1
                self.router._auto_drain(i)

    def _recover(self, i: int, now: int) -> None:
        rh = self.replicas[i]
        was_down = rh.state == "down"
        rh.state = "healthy"
        rh.consecutive_failures = 0
        rh.backoff = 0
        rh.last_error = ""
        if was_down:
            self.recoveries += 1
            if self.auto_drain:
                self.router.readmit(i)

    # --------------------------------------------------------------- probes

    def _probe(self, i: int, now: int) -> None:
        rh = self.replicas[i]
        rh.probes += 1
        rh.last_probe = now
        eng = self.router.engines[i]
        try:
            h = eng.health()  # host bookkeeping only: no device work to fail
        except BaseException as e:  # liveness: any raise is a failure
            self._fail(i, f"probe: {e}", now)
            return
        if h.get("exhausted") or (h["queued"] > 0
                                  and h["free_frac"] <= self.exhaust_frac):
            self._fail(i, "arena exhausted with queued work", now)
            return
        if (rh.had_work and h["has_work"]
                and h["progress"] == rh.last_progress):
            self._fail(i, "no progress since last probe", now)
            return
        rh.last_progress = h["progress"]
        rh.had_work = h["has_work"]
        self._recover(i, now)

    def tick(self, now: int) -> None:
        """Called by ``router.step()`` with the router's monitor clock.
        Probes every supervised replica that is due: down replicas on their
        backoff schedule, healthy and suspect ones every ``interval``."""
        for i, rh in enumerate(self.replicas):
            if i in self.router._manual_drained:
                continue  # caller-managed: never probe or re-admit
            if rh.state == "down":
                if now >= rh.next_probe:
                    self._probe(i, now)
            elif self.interval and now >= rh.next_probe:
                # schedule first: a probe that takes the replica down
                # overwrites this with its backoff inside _fail
                rh.next_probe = now + self.interval
                self._probe(i, now)
