"""Paged KV arenas, scheduler, policies, seeded sampling, speculative
decoding, serving traces, the engines and the replica router.

Modules:
  paged_cache  — block-paged arenas of the cache tiers
  request      — the request-centric API dataclasses (SamplingParams,
                 SloClass, ServeRequest, RequestOutput)
  policies     — SchedulerPolicy implementations (fifo / priority / slo)
                 and the router's PlacementPolicy implementations
                 (rr / load / slo)
  prefix_index — the content-addressed index of page-aligned prefixes
  scheduler    — host-side admission queue, slot table, watermarks
  engine       — ServeEngine (static batch) and ContinuousServeEngine
  router       — ReplicaRouter: data-parallel fan-out over N engine
                 replicas sharing one device weight tree, with placement,
                 session affinity, drain, rebalance and a parked backlog
  faults       — deterministic fault injection (FaultPlan / FaultyReplica:
                 crash / stall / exhaust on schedule)
  health       — HealthMonitor: liveness, progress and pressure probes,
                 auto-drain and backoff re-admission

The names below are exported lazily (PEP 562), as the reference's are, so
importing ``repro_torch.serving.paged_cache`` from the model stack does not
pull in the engine.
"""

_ENGINE_EXPORTS = ("GenerationConfig", "ServeEngine", "ContinuousServeEngine")
_SCHEDULER_EXPORTS = ("Request", "Scheduler", "SchedulerConfigError")
_REQUEST_EXPORTS = ("SamplingParams", "SloClass", "ServeRequest",
                    "RequestOutput", "INTERACTIVE", "STANDARD", "BATCH")
_POLICY_EXPORTS = ("SchedulerPolicy", "FifoPolicy", "PriorityPolicy",
                   "SloAwarePolicy", "make_policy", "PlacementPolicy",
                   "ReplicaView", "RoundRobinPlacement", "LeastLoadedPlacement",
                   "SloPressurePlacement", "make_placement")
_ROUTER_EXPORTS = ("ReplicaRouter",)
_PREFIX_EXPORTS = ("PrefixIndex",)
_FAULT_EXPORTS = ("FaultEvent", "FaultPlan", "FaultyReplica", "ReplicaFault")
_HEALTH_EXPORTS = ("HealthMonitor", "ReplicaHealth")

__all__ = list(_ENGINE_EXPORTS + _SCHEDULER_EXPORTS + _REQUEST_EXPORTS
               + _POLICY_EXPORTS + _ROUTER_EXPORTS + _PREFIX_EXPORTS
               + _FAULT_EXPORTS + _HEALTH_EXPORTS)

_MODULE_OF = {**{n: "engine" for n in _ENGINE_EXPORTS},
              **{n: "scheduler" for n in _SCHEDULER_EXPORTS},
              **{n: "request" for n in _REQUEST_EXPORTS},
              **{n: "policies" for n in _POLICY_EXPORTS},
              **{n: "router" for n in _ROUTER_EXPORTS},
              **{n: "prefix_index" for n in _PREFIX_EXPORTS},
              **{n: "faults" for n in _FAULT_EXPORTS},
              **{n: "health" for n in _HEALTH_EXPORTS}}


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f"repro_torch.serving.{_MODULE_OF[name]}"), name)
