"""The port's fault injection against the JAX package's (ROADMAP A17):
``FaultPlan.random`` over fixed seeds, event windows and overlap, the
``FaultyReplica`` wrapper (crash before touching the engine, stall, masked
exhaustion, forwarding), and router serves under faults (a crash window
auto-drained and recovered, an exhaustion probe, the last replica parked
and recovered, and seeded chaos schedules) with identical results, output
events and stats, each stream also the port's own fault-free engine's.
The chaos schedules run on fixed seeds, so every run checks the same
cases in the same time."""
import dataclasses

import pytest

from torch_paged_cases import (PROBED_SERVING, check_alloc, exactly_once, mixed_trace,
                               packages, router_pair, run_router, smoke_pair)

PLAN_SEEDS = tuple(range(16))
CHAOS_SEEDS = (0, 1, 2, 3, 4, 5, 6, 7)


@pytest.fixture(scope="module")
def model():
    return smoke_pair()


@pytest.fixture(scope="module")
def reference(model):
    """The port's fault-free streams of the mixed trace on one engine."""
    _, tcfg, _, tparams = model
    _, P = packages()
    eng = P.Engine(tcfg, tparams, serving=P.ServingCfg(**PROBED_SERVING), device="cpu")
    res, _ = eng.serve(mixed_trace(P))
    return {rid: list(rec["tokens"]) for rid, rec in res.items()}


def _tokens(results):
    return {rid: list(r["tokens"]) for rid, r in results.items()}


def _plan(ns, *events):
    return ns.faults.FaultPlan(tuple(ns.faults.FaultEvent(*e) for e in events))


# --------------------------------------------------------------- plan units


@pytest.mark.parametrize("seed", PLAN_SEEDS)
def test_fault_plan_random_matches_jax(seed):
    plans = [[dataclasses.astuple(e) for e in ns.faults.FaultPlan.random(
        seed, horizon=40, n_events=4).events] for ns in packages()]
    assert plans[0] == plans[1]
    assert all(k in ("crash", "stall", "exhaust") and 1 <= t < 40 for t, k, _ in plans[1])
    _, P = packages()
    assert P.faults.FaultPlan.random(seed, 40, 4) == P.faults.FaultPlan.random(seed, 40, 4)


def test_fault_windows_overlap_and_horizon_match_jax():
    seen = []
    for ns in packages():
        ev = ns.faults.FaultEvent(tick=3, kind="stall", duration=2)
        plan = _plan(ns, (2, "stall", 4), (3, "crash", 1), (9, "exhaust", 3))
        got = [[ev.active_at(c) for c in range(7)],
               [None if (e := plan.active_at(c)) is None else dataclasses.astuple(e)
                for c in range(14)],
               plan.horizon(), ns.faults.FaultPlan().horizon(),
               ns.faults.FaultPlan().active_at(0), ns.faults.FAULT_KINDS]
        for bad in ((0, "meteor"), (-1, "crash"), (0, "crash", 0)):
            with pytest.raises(AssertionError):
                ns.faults.FaultEvent(*bad)
        seen.append(got)
    assert seen[0] == seen[1]
    assert seen[1][1][3][1] == "stall"  # the earliest event governs an overlap


class _FakeEngine:
    """Counts steps, reports canned health."""

    def __init__(self):
        self.steps = 0
        self.tag = "fake"

    def step(self):
        self.steps += 1
        return ["tok"]

    def health(self):
        return {"alive": True, "has_work": True, "queued": 1, "progress": self.steps,
                "free_frac": 0.5, "exhausted": False}

    def arena_stats(self):
        return {"free_frac": 0.5}


def _replay(ns, events, calls):
    """Drive a FaultyReplica over a fake engine through ``calls``; each
    call's outcome (result or the fault's message), then the inner step
    count, the clock and the fired windows."""
    inner = _FakeEngine()
    rep = ns.faults.FaultyReplica(inner, _plan(ns, *events))
    out = []
    for call in calls:
        try:
            out.append(getattr(rep, call)())
        except ns.faults.ReplicaFault as e:
            out.append(("fault", str(e)))
    return out, inner.steps, rep.clock, rep.faults_injected, rep.tag


@pytest.mark.parametrize("events, calls", [
    (((1, "crash", 2),), ("step", "step", "health", "step", "arena_stats")),
    (((0, "stall", 1), (1, "exhaust", 1)), ("step", "health", "arena_stats", "step")),
    (((2, "exhaust", 3),), ("step", "arena_stats", "step", "arena_stats", "health",
                            "health", "arena_stats")),
    ((), ("step",) * 5 + ("arena_stats", "health")),
])
def test_faulty_replica_matches_jax(events, calls):
    got = [_replay(ns, events, calls) for ns in packages()]
    assert got[0] == got[1]
    out, steps, clock, fired, tag = got[1]
    assert tag == "fake" and clock == sum(c in ("step", "health") for c in calls)
    if events and events[0][1] == "crash":  # fail-stop: the engine untouched
        assert steps == 2 and fired["crash"] == 2
        assert out[1][0] == "fault" and out[2][0] == "fault" and out[3] == ["tok"]
    if events and events[0][1] == "stall":
        assert out[0] == [] and out[1]["exhausted"] and out[2] == {"free_frac": 0.5}


# ------------------------------------------------- router serves under faults


def _serve_trace(router, ns):
    router.reset()
    for r in mixed_trace(ns):
        router.add_request(r)
    run_router(router)


@pytest.mark.parametrize("replica", [0, 1])
def test_crash_auto_drains_and_recovers_as_jax(model, reference, replica):
    """A crash window on one replica: the monitor drains it, its work
    migrates, it is re-admitted after the window, and every stream is the
    fault-free run's, as in JAX."""
    plans = lambda ns: [_plan(ns, (3, "crash", 4)) if i == replica else None  # noqa: E731
                        for i in range(2)]
    (_, _), (_, tr) = router_pair(model, _serve_trace, PROBED_SERVING, plans=plans)
    assert _tokens(tr.results()) == reference
    st = tr.stats()
    assert st["auto_drains"] >= 1 and st["recoveries"] >= 1
    assert st["draining"] == [] and st["timeouts"] == 0 and st["shed"] == 0


def test_exhaust_fault_trips_the_pressure_probe_as_jax(model, reference):
    plans = lambda ns: [_plan(ns, (2, "exhaust", 10)), None]  # noqa: E731
    (_, _), (_, tr) = router_pair(model, _serve_trace, PROBED_SERVING, plans=plans)
    assert _tokens(tr.results()) == reference
    assert tr.monitor.replicas[0].probe_failures >= 1


def test_single_replica_parks_and_recovers_as_jax(model, reference):
    """One replica, a crash window that drains the whole fleet: arrivals
    park in the backlog and place on recovery."""
    plans = lambda ns: [_plan(ns, (2, "crash", 3))]  # noqa: E731
    (_, _), (_, tr) = router_pair(model, _serve_trace, PROBED_SERVING, n=1, plans=plans)
    assert _tokens(tr.results()) == reference
    st = tr.stats()
    assert st["auto_drains"] >= 1 and st["recoveries"] >= 1 and st["backlog"] == 0


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_schedule_exactly_once_and_parity(model, reference, seed):
    """Seeded fault schedules on both replicas (the reference's chaos
    property on fixed seeds): the port's router gives the JAX router's
    results, events and stats; every request finishes exactly once with
    the fault-free streams; every live replica's allocator is sound."""
    plans = lambda ns: [ns.faults.FaultPlan.random(seed, horizon=24, n_events=3),  # noqa: E731
                        ns.faults.FaultPlan.random(seed + 1, horizon=24, n_events=2)]

    def drive(router, ns):
        _serve_trace(router, ns)
        events = router.pending_outputs()
        exactly_once(events, router.results(), list(range(6)))
        for eng in router.engines:
            if eng._st is not None:
                check_alloc(eng)
        return [dataclasses.astuple(e) for e in events], [
            dict(eng.faults_injected) for eng in router.engines]

    (jv, _), (tv, tr) = router_pair(model, drive, PROBED_SERVING, plans=plans)
    assert jv == tv
    assert _tokens(tr.results()) == reference, f"diverged under schedule seed={seed}"
    st = tr.stats()
    assert st["dense_pages_leaked"] == 0 and st["cpq_pages_leaked"] == 0
    assert st["timeouts"] == 0 and st["shed"] == 0
