"""Multi-replica serving router of the port (the JAX package's
``serving/router.py``): data-parallel scale-out of the continuous engine.

``ReplicaRouter`` owns N independent ``ContinuousServeEngine`` replicas,
each with its own scheduler, paged arenas and tick loop, and fronts them
with the engine's request-centric surface (``add_request() / step() /
pending_outputs() / results() / stats()`` and the ``serve()`` /
``generate()`` wrappers), so a caller written against one engine drives N
unchanged. One router ``step()`` ticks every healthy replica once. The
replicas share one device weight tree (``adopt_compiled``): N replicas hold
one copy of the weights and N arenas. On one card the replicas tick one
after the other, while ``stats()`` counts them as parallel, as the
reference does (aggregate tokens per step against the busiest replica's
decode clock).

What a single engine cannot express lives here:

  placement         where a new request runs: a ``PlacementPolicy``
                    (``rr``, ``load``, ``slo``; serving/policies.py).
  session affinity  a ``ServeRequest.session_id`` pins every later turn of
                    a conversation to the replica that served the earlier
                    ones, until that replica drains.
  drain             ``drain(i)``: placements stop, the replica's incomplete
                    requests are snapshotted by the engine's ``drain()``
                    (recompute-preemption replay: context = prompt +
                    generated so far, pinned SamplingParams) and re-queued
                    on healthy replicas, and its arenas are freed
                    (``release()``). Seeded draws are ``fold_in(seed,
                    token_index)``, so migrated streams go on token for
                    token.
  health            a ``HealthMonitor`` (serving/health.py) probes every
                    replica and, with ``auto_drain``, drains one that fails
                    ``probe_failures`` consecutive probes (or raises
                    ``ReplicaFault`` from ``step()``), then re-admits it
                    after a successful recovery probe. Fault injection
                    (serving/faults.py) drives this deterministically.
  rebalance         ``rebalance(rid, dst)`` migrates one request without
                    draining its replica, through the same replay path.
  backpressure      with no healthy replica (or every replica saturated,
                    for deadline-free batch work) new requests park in a
                    router backlog and place on the first recovery; a
                    bounded backlog (``ServingCfg.max_backlog``) sheds
                    batch-class overflow with a counted ``shed`` finish.

``step()`` catches ``ReplicaFault`` alone: a kernel's build or launch
error, or any CUDA error, leaves ``step()`` and fails the run. Request ids
are router-global, and every ``RequestOutput`` is delivered exactly once:
engine buffers drain into the router's each tick, and a drain hands its
un-emitted events over before the replica's session is dropped.

Like the engines, the router runs on the GPU unless ``device`` names
another device; a device mesh goes to every replica (serving/sharded.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np

from repro_torch.configs import AttentionRuntime, ModelConfig, ServingCfg
from repro_torch.serving.engine import ContinuousServeEngine, GenerationConfig
from repro_torch.serving.faults import FaultyReplica, ReplicaFault
from repro_torch.serving.health import HealthMonitor
from repro_torch.serving.policies import (PlacementPolicy, ReplicaView,
                                          derive_deadlines, make_placement, slo_of)
from repro_torch.serving.request import RequestOutput, SamplingParams, ServeRequest
from repro_torch.serving.scheduler import Request, SchedulerConfigError


@dataclasses.dataclass
class _Parked:
    """One backlog entry: the request, its stream override, and its absolute
    deadlines on the ROUTER clock (the monitor tick count — it upper-bounds
    no engine clock exactly, but every parked tick is a tick not served, so
    expiring against it is conservative in spirit and deterministic)."""

    req: Union[ServeRequest, Request]
    stream: object = None
    ttft_deadline: float = math.inf
    deadline: float = math.inf


class ReplicaRouter:
    """Front end over N data-parallel ``ContinuousServeEngine`` replicas.

    Construction builds replica 0, which moves the weights to ``device``;
    the others are built on replica 0's device tree and adopt it, so the
    weights are on the device once. ``placement`` is a ``PlacementPolicy``
    object or name (``rr`` | ``load`` | ``slo``); ``policy``, ``serving``,
    ``rt``, ``mesh`` and ``device`` go to every replica (under a mesh each
    replica splits its own arenas over the model axis; the replicas still
    share one weight tree, on the mesh's first device). ``fault_plans`` (one
    ``FaultPlan`` per replica, None for no faults) wraps replicas in
    ``FaultyReplica`` for deterministic chaos runs."""

    def __init__(self, cfg: ModelConfig, params, num_replicas: int = 2,
                 rt: Optional[AttentionRuntime] = None,
                 serving: ServingCfg = ServingCfg(),
                 placement: Union[str, PlacementPolicy] = "rr",
                 policy=None, mesh=None,
                 fault_plans: Optional[list] = None, device=None):
        if num_replicas < 1:
            raise SchedulerConfigError("num_replicas must be >= 1")
        self.serving = serving
        engines = []
        for _ in range(num_replicas):
            eng = ContinuousServeEngine(cfg, engines[0].params if engines else params,
                                        rt=rt, serving=serving, mesh=mesh, policy=policy,
                                        device=device)
            if engines:
                eng.adopt_compiled(engines[0])
            engines.append(eng)
        if fault_plans is not None:
            assert len(fault_plans) == num_replicas, (
                "fault_plans must have one entry (FaultPlan or None) "
                "per replica")
            engines = [e if p is None else FaultyReplica(e, p)
                       for e, p in zip(engines, fault_plans)]
        self.engines = engines
        self.placement = (make_placement(placement)
                          if isinstance(placement, str) else placement)
        self._fresh()

    # ------------------------------------------------------- session state

    def _fresh(self) -> None:
        self._draining: set[int] = set()        # manual + auto
        self._manual_drained: set[int] = set()  # caller drains: never probed
        self._auto_drained: set[int] = set()    # monitor drains: re-admitted
        self._sessions: dict[str, int] = {}     # session_id -> replica
        self._rid_replica: dict[int, int] = {}  # rid -> current replica
        self._archived: dict[int, dict] = {}    # results of drained replicas
        self._drained_stats: dict[int, dict] = {}
        self._stats_archive: list[dict] = []    # epochs of re-admitted drains
        self._router_results: dict[int, dict] = {}  # shed / parked-timeout
        self._backlog: list[_Parked] = []
        self._outputs: list[RequestOutput] = []
        self._next_rid = 0
        self._ticks = 0
        self._mclock = 0                        # monitor clock: every step()
        self._migrated = 0
        self._rebalanced = 0
        self._shed = 0
        self._backlog_timeouts = 0
        s = self.serving
        self.monitor = HealthMonitor(
            self, interval=s.probe_interval, fail_threshold=s.probe_failures,
            backoff=s.probe_backoff, exhaust_frac=s.probe_exhaust_frac,
            auto_drain=s.auto_drain)

    def reset(self, gen: GenerationConfig = GenerationConfig()) -> None:
        """Fresh serving session on every replica (drained replicas rejoin);
        clears the session map, rid registry, backlog, health state, and
        output buffer."""
        for eng in self.engines:
            eng.reset(gen)
        self._fresh()

    @property
    def num_replicas(self) -> int:
        return len(self.engines)

    @property
    def chunked(self) -> bool:
        """Admission-path flag, mirrored from the replicas (engine-surface
        compatibility for callers that report it)."""
        return self.engines[0].chunked

    def healthy(self) -> list[int]:
        """Replica indices currently accepting placements."""
        return [i for i in range(len(self.engines)) if i not in self._draining]

    def replica_of(self, rid: int) -> Optional[int]:
        """The replica currently (or last) responsible for ``rid`` — the
        placement record, updated on migration."""
        return self._rid_replica.get(rid)

    # ---------------------------------------------------------- placement

    def _views(self) -> list[ReplicaView]:
        return [ReplicaView(index=i,
                            outstanding_tokens=self.engines[i]
                            .outstanding_tokens(),
                            free_frac=self.engines[i]
                            .arena_stats()["free_frac"],
                            queued=len(self.engines[i].queued_requests()))
                for i in self.healthy()]

    def _try_place(self, req: Union[ServeRequest, Request]) -> Optional[int]:
        """Session affinity first (a mapped session bypasses placement while
        its replica is healthy), then the placement policy over the healthy
        replicas; a session's first request records the mapping. Returns
        None when the request must PARK: zero healthy replicas, or — for
        deadline-free batch-class work — every healthy replica saturated
        (free fraction under the low watermark AND a non-empty admission
        queue on all of them: admitting more batch work would only deepen
        the churn the latency classes are fighting)."""
        views = self._views()
        if not views:
            return None
        sid = req.session_id
        if sid is not None:
            pinned = self._sessions.get(sid)
            if pinned is not None and pinned not in self._draining:
                return pinned
        slo = slo_of(req) if isinstance(req, Request) else req.slo
        if (slo is not None and slo.priority <= 0
                and all(v.free_frac < self.serving.low_watermark
                        and v.queued > 0 for v in views)):
            return None
        target = self.placement.select(views, req)
        if sid is not None:
            self._sessions[sid] = target
        return target

    def _park_deadlines(self, req) -> tuple[float, float]:
        """Absolute (ttft, total) deadlines for a parked request, on the
        router's monitor clock (same derivation as the engine's)."""
        sp = req.sampling
        if sp is None:
            sp = SamplingParams(max_tokens=req.max_new_tokens)
        slo = slo_of(req) if isinstance(req, Request) else req.slo
        return derive_deadlines(sp, slo, req.arrival,
                                self.serving.deadline_scale)

    def _record_of(self, req, reason: str) -> dict:
        """Finished-request record for work that never reached an engine
        this epoch (shed arrivals, parked timeouts) — same shape the engine
        writes, with whatever history the snapshot carries."""
        slo = req.slo
        gen = getattr(req, "generated", [])
        steps = getattr(req, "token_steps", [])
        return {
            "tokens": np.asarray(gen, np.int32),
            "session": req.session_id,
            "finish_reason": reason,
            "arrival": req.arrival,
            "admitted_step": getattr(req, "admitted_step", -1),
            "first_token_step": getattr(req, "first_token_step", -1),
            "token_steps": np.asarray(steps, np.int64),
            "done_step": self._mclock,
            "preemptions": getattr(req, "preemptions", 0),
            "escalated": getattr(req, "escalated", False),
            "deescalations": getattr(req, "deescalations", 0),
            "slo": slo.name if slo is not None else "standard",
            "priority": slo.priority if slo is not None else 1,
            "ttft_target": slo.ttft_target if slo is not None else math.inf,
            "itl_target": slo.itl_target if slo is not None else math.inf,
        }

    def _finish_unplaced(self, entry: _Parked, reason: str) -> None:
        req = entry.req
        n = getattr(req, "num_generated", 0)
        self._router_results[req.rid] = self._record_of(req, reason)
        ev = RequestOutput(rid=req.rid, token=-1, index=n, step=self._mclock,
                           finished=True, finish_reason=reason)
        self._outputs.append(ev)
        stream = entry.stream or getattr(req, "stream", None)
        if stream is not None:
            stream(ev)

    def _park(self, req, stream) -> None:
        ttft, dl = self._park_deadlines(req)
        self._backlog.append(_Parked(req, stream, ttft, dl))

    def _flush_backlog(self) -> None:
        """Place parked requests in FIFO order onto recovered/unsaturated
        replicas; the first unplaceable entry stops the flush (arrival order
        is preserved — backpressure is a queue, not a lottery)."""
        while self._backlog:
            entry = self._backlog[0]
            target = self._try_place(entry.req)
            if target is None:
                return
            self._backlog.pop(0)
            self.engines[target].add_request(entry.req, stream=entry.stream)
            self._rid_replica[entry.req.rid] = target

    def _expire_backlog(self) -> None:
        """Parked requests past their deadline (router clock) finish with
        ``timeout`` — counted separately from engine timeouts so the stats
        can tell "waited too long for a replica" from "served too slowly"."""
        now = self._mclock
        blown = [e for e in self._backlog
                 if now >= e.deadline
                 or (getattr(e.req, "first_token_step", -1) < 0
                     and now >= e.ttft_deadline)]
        for entry in blown:
            self._backlog.remove(entry)
            self._backlog_timeouts += 1
            self._finish_unplaced(entry, "timeout")

    # ------------------------------------------------- request-centric API

    def add_request(self, req: Union[ServeRequest, Request], *,
                    stream=None) -> int:
        """Place one request on a replica (session affinity, then the
        placement policy) and submit it there. Request ids are router-global
        — an explicit rid colliding with any live or archived request
        raises; omitted rids auto-assign from the router's counter.

        NEVER raises for lack of capacity: with zero healthy replicas (or
        every replica saturated, for batch-class work) the request parks in
        the router backlog and places on the first recovery — unless the
        backlog is bounded (``ServingCfg.max_backlog``) and full, where
        deadline-free batch-class arrivals are shed with a counted ``shed``
        finish instead."""
        if isinstance(req, ServeRequest) and req.rid is None:
            req = dataclasses.replace(req, rid=self._next_rid)
        rid = req.rid
        if (rid in self._rid_replica or rid in self._archived
                or rid in self._router_results
                or any(e.req.rid == rid for e in self._backlog)):
            raise SchedulerConfigError(
                f"request id {rid} already in use this session "
                "(omit ServeRequest.rid to auto-assign)")
        self._next_rid = max(self._next_rid, rid + 1)
        target = self._try_place(req)
        if target is None:
            slo = req.slo if not isinstance(req, Request) else slo_of(req)
            if (self.serving.max_backlog
                    and len(self._backlog) >= self.serving.max_backlog
                    and slo is not None and slo.priority <= 0):
                self._shed += 1
                self._finish_unplaced(_Parked(req, stream), "shed")
                return rid
            self._park(req, stream)
            return rid
        self.engines[target].add_request(req, stream=stream)
        self._rid_replica[rid] = target
        return rid

    def step(self) -> list[RequestOutput]:
        """One router tick: probe health, flush/expire the parked backlog,
        then every healthy replica with work runs one engine tick (a real
        deployment's replicas tick in parallel — the router tick is the
        wall-clock unit). A replica whose ``step()`` raises ``ReplicaFault``
        is charged a health failure instead of propagating — with
        ``auto_drain`` it drains through the snapshot path once it hits the
        threshold. Any other error propagates. Returns the tick's merged
        ``RequestOutput`` events in replica order (also buffered for
        ``pending_outputs``; per-request ``stream`` callbacks fire inline,
        on the owning replica)."""
        start = len(self._outputs)      # everything this tick lands after
        now = self._mclock
        self._mclock += 1
        self.monitor.tick(now)          # may auto-drain / re-admit replicas
        self._flush_backlog()
        self._expire_backlog()
        worked = False
        for i, eng in enumerate(self.engines):
            if i in self._draining or not eng.has_unfinished():
                continue
            worked = True
            try:
                eng.step()
            except ReplicaFault as e:
                self.monitor.note_fault(i, e, now)
                continue
            self._outputs.extend(eng.pending_outputs())
        if worked:
            self._ticks += 1
        return list(self._outputs[start:])

    def has_unfinished(self) -> bool:
        return bool(self._backlog) or any(
            i not in self._draining and eng.has_unfinished()
            for i, eng in enumerate(self.engines))

    def pending_outputs(self) -> list[RequestOutput]:
        """Drain the router-level buffer of everything committed since the
        last drain (``step()`` also returns its tick's events directly)."""
        out, self._outputs = self._outputs, []
        return out

    def results(self) -> dict[int, dict]:
        """Merged finished-request records: drained replicas' archives,
        router-level finishes (shed / parked timeouts), plus every live
        replica's results. rids are router-global, so the merge is
        collision-free."""
        out = dict(self._archived)
        out.update(self._router_results)
        for eng in self.engines:
            out.update(eng.results())
        return out

    # --------------------------------------------------------------- drain

    def drain(self, replica: int, force: bool = False) -> int:
        """Take ``replica`` out of service: stop placements to it, snapshot
        its incomplete requests through ``engine.drain()`` (the recompute-
        preemption replay path), archive its finished results and stats,
        free its arenas (``engine.release()``), and re-queue the snapshot
        onto healthy replicas via the normal placement path — sessions
        pinned to the drained replica are remapped with their requests.
        Returns the number of requests migrated.

        A manual drain (``force=False``) refuses to drain the last healthy
        replica (its work would have nowhere to go) and is permanent: the
        HealthMonitor neither probes nor re-admits it. ``force=True`` (the
        auto-drain path) may drain the LAST replica — snapshots that cannot
        place park in the router backlog and place on recovery."""
        if replica in self._draining:
            return 0
        if not (0 <= replica < len(self.engines)):
            raise SchedulerConfigError(f"no replica {replica}")
        if not force and set(self.healthy()) == {replica}:
            raise SchedulerConfigError(
                "cannot drain the last healthy replica")
        eng = self.engines[replica]
        self._draining.add(replica)
        if not force:
            self._manual_drained.add(replica)
        had_state = eng._st is not None
        if had_state:
            self._outputs.extend(eng.pending_outputs())  # nothing left behind
            self._archived.update(eng.results())
        moved = eng.drain()
        if had_state:
            # snapshot AFTER drain: pages freed, drain preemptions counted
            self._drained_stats[replica] = eng.stats()
        eng.release()
        self._sessions = {s: r for s, r in self._sessions.items()
                          if r != replica}
        for req in moved:
            target = self._try_place(req)
            if target is None:
                self._park(req, None)
                continue
            self.engines[target].add_request(req)
            self._rid_replica[req.rid] = target
        self._migrated += len(moved)
        return len(moved)

    def _auto_drain(self, replica: int) -> None:
        """HealthMonitor-initiated drain: forced (may drain the last
        replica — work parks) and re-admittable (``readmit`` on a
        successful recovery probe)."""
        if replica in self._draining:
            return
        self._auto_drained.add(replica)
        self.drain(replica, force=True)

    def readmit(self, replica: int) -> None:
        """Return a recovered auto-drained replica to service: it rejoins
        placement immediately (the next ``step()`` flushes parked work onto
        it). Its pre-drain counters move to the cumulative stats archive —
        the replica starts a fresh engine session, and the aggregate stats
        keep summing both epochs."""
        if replica not in self._auto_drained:
            return
        self._auto_drained.discard(replica)
        self._draining.discard(replica)
        epoch = self._drained_stats.pop(replica, None)
        if epoch is not None:
            self._stats_archive.append(epoch)

    # ----------------------------------------------------------- rebalance

    def rebalance(self, rid: int, dst: int) -> bool:
        """Migrate ONE request to replica ``dst`` WITHOUT draining its
        current replica: the engine's ``drain_request`` snapshots it (pages
        freed, context = prompt + generated-so-far, pinned SamplingParams)
        and it re-queues on ``dst`` through the same recompute-replay path
        a full drain uses — greedy and seeded streams continue token-exact.
        Works on queued, mid-prefill, and decoding requests alike. Returns
        False when ``rid`` is finished, unknown, or already on ``dst``;
        raises only for an invalid/draining destination."""
        if not (0 <= dst < len(self.engines)):
            raise SchedulerConfigError(f"no replica {dst}")
        if dst in self._draining:
            raise SchedulerConfigError(f"replica {dst} is draining")
        src = self._rid_replica.get(rid)
        if src is None or src == dst:
            return False
        snap = self.engines[src].drain_request(rid)
        if snap is None:
            return False  # already finished on src
        self.engines[dst].add_request(snap)
        self._rid_replica[rid] = dst
        if snap.session_id is not None:
            self._sessions[snap.session_id] = dst
        self._rebalanced += 1
        self._migrated += 1
        return True

    # --------------------------------------------------------------- stats

    _SUM_KEYS = ("generated_tokens", "prefill_tokens", "prefill_chunks",
                 "decode_steps", "arena_bytes_total", "arena_bytes_per_device",
                 "interconnect_bytes", "decode_traffic_bytes",
                 "prefill_write_bytes", "defrags", "preemptions",
                 "escalations", "deescalations", "admitted", "retired",
                 "timeouts", "dense_pages_leaked", "cpq_pages_leaked")
    _REPLICA_KEYS = ("tokens_per_step", "generated_tokens", "decode_steps",
                     "prefill_tokens", "arena_bytes_total",
                     "interconnect_bytes", "defrags", "preemptions",
                     "escalations", "deescalations", "timeouts",
                     "slot_utilization", "dense_arena_utilization", "policy")

    def stats(self) -> dict:
        """One aggregated surface over all replicas plus the per-replica
        breakdown. Counters sum — including archived epochs of replicas
        that were auto-drained and re-admitted; ``tokens_per_step`` is the
        AGGREGATE throughput — total generated tokens against the slowest
        replica's decode clock (replicas tick in parallel, so the busiest
        replica is the wall clock). Draining replicas contribute their
        drain-time snapshot. Health state (per replica and router-wide
        auto-drain/recovery counts), the parked backlog depth, and the
        ``timeouts``/``shed``/``rebalanced`` counters ride along."""
        per_replica = []
        for i, eng in enumerate(self.engines):
            s = self._drained_stats.get(i)
            if s is None:
                # a replica with no serving session yet (or released) has no
                # counters to report — don't build arenas just to read zeros
                s = eng.stats() if eng._st is not None else {}
            rh = self.monitor.replicas[i]
            row = {"replica": i, "draining": i in self._draining,
                   "health": rh.state,
                   "consecutive_failures": rh.consecutive_failures,
                   "probe_failures": rh.probe_failures,
                   "auto_drained": i in self._auto_drained}
            row.update({k: s.get(k) for k in self._REPLICA_KEYS})
            per_replica.append((row, s))
        epochs = [s for _, s in per_replica] + self._stats_archive
        agg: dict = {
            "replicas": len(self.engines),
            "placement": self.placement.name,
            "draining": sorted(self._draining),
            "drains": len(self._draining),
            "migrated_requests": self._migrated,
            "rebalanced": self._rebalanced,
            "shed": self._shed,
            "backlog": len(self._backlog),
            "backlog_timeouts": self._backlog_timeouts,
            "router_ticks": self._ticks,
            **self.monitor.stats(),
        }
        for k in self._SUM_KEYS:
            agg[k] = sum(s.get(k, 0) or 0 for s in epochs)
        agg["timeouts"] += self._backlog_timeouts
        busiest = max((s.get("decode_steps", 0) for _, s in per_replica),
                      default=0)
        agg["decode_steps_max"] = busiest
        agg["tokens_per_step"] = agg["generated_tokens"] / max(busiest, 1)
        agg["interconnect_bytes_per_token"] = (
            agg["interconnect_bytes"] / max(agg["generated_tokens"], 1))
        agg["wall_time_s"] = max((s.get("wall_time_s", 0.0)
                                  for _, s in per_replica), default=0.0)
        agg["tokens_per_s"] = agg["generated_tokens"] / max(
            agg["wall_time_s"], 1e-9)
        agg["per_replica"] = [row for row, _ in per_replica]
        return agg

    # ----------------------------------------------------- batch wrappers

    def serve(self, requests: list[Union[Request, ServeRequest]],
              gen: GenerationConfig = GenerationConfig()):
        """Batch-shaped wrapper, signature-compatible with the engine's:
        resets every replica, places and submits all requests in arrival
        order, ticks to completion. Returns (merged results, aggregate
        stats)."""
        self.reset(gen)
        for r in sorted(requests, key=lambda r: r.arrival):
            self.add_request(r)
        while self.has_unfinished():
            self.step()
        return self.results(), self.stats()

    def generate(self, batch: dict, gen: GenerationConfig = GenerationConfig()):
        """Static-engine-compatible convenience (same contract as
        ``ContinuousServeEngine.generate``), spread over the replicas."""
        prompt = np.asarray(batch["tokens"])
        reqs = [Request(rid=i, prompt=prompt[i],
                        max_new_tokens=gen.max_new_tokens)
                for i in range(prompt.shape[0])]
        results, stats = self.serve(reqs, gen)
        pad = gen.eos_id if gen.eos_id >= 0 else 0
        out = np.full((prompt.shape[0], gen.max_new_tokens), pad, np.int32)
        for i in range(prompt.shape[0]):
            t = results[i]["tokens"]
            out[i, :len(t)] = t[:gen.max_new_tokens]
        return out, stats
