"""The port's health monitor, rebalance and backpressure against the JAX
package's (ROADMAP A17): the ``HealthMonitor`` state machine driven in
both packages by the same scripted fake replicas (threshold, backoff
doubling and its cap, stall and pressure probes, manual drains skipped),
then router serves (zero healthy replicas parking and placing, the forced
drain of the last replica, the health counters, rebalance mid-decode and
mid-prefill, a seeded double migration, parked and explicit deadline
timeouts, bounded-backlog shedding) with identical results, output events
and stats."""
import numpy as np
import pytest

from torch_paged_cases import (PROBED_SERVING, ROUTER_SERVING, packages, router_pair,
                               run_router, smoke_pair)


@pytest.fixture(scope="module")
def model():
    return smoke_pair()


@pytest.fixture(scope="module")
def alone(model):
    """The port's uninterrupted streams of a request list on one engine."""
    _, tcfg, _, tparams = model
    _, P = packages()

    def run(make):
        eng = P.Engine(tcfg, tparams, serving=P.ServingCfg(**ROUTER_SERVING), device="cpu")
        res, _ = eng.serve(make(P))
        return {rid: list(rec["tokens"]) for rid, rec in res.items()}
    return run


def _tokens(results):
    return {rid: list(r["tokens"]) for rid, r in results.items()}


# ----------------------------------------------- the probe state machine

_OK = {"alive": True, "has_work": False, "queued": 0, "progress": 0, "free_frac": 1.0,
       "exhausted": False}
_BUSY = dict(_OK, has_work=True, queued=1, progress=5)


class _ScriptedEngine:
    """health() replays a script of dict responses and exceptions."""

    def __init__(self, script):
        self.script = list(script)

    def health(self):
        item = self.script.pop(0) if self.script else _OK
        if isinstance(item, Exception):
            raise item
        return item


class _FakeRouter:
    def __init__(self, scripts, manual=()):
        self.engines = [_ScriptedEngine(s) for s in scripts]
        self._manual_drained = set(manual)
        self.drained, self.readmitted = [], []

    def _auto_drain(self, i):
        self.drained.append(i)

    def readmit(self, i):
        self.readmitted.append(i)


def _monitor_run(ns, scripts, ticks, manual=(), **kw):
    """Tick a HealthMonitor of ``ns`` over a fake router at ``ticks`` (None:
    each replica's next probe); its full record after every tick."""
    import dataclasses

    r = _FakeRouter(scripts, manual)
    mon = ns.health.HealthMonitor(r, **kw)
    seen = []
    for t in ticks:
        now = mon.replicas[0].next_probe if t is None else t
        mon.tick(now)
        seen.append((now, [dataclasses.asdict(h) for h in mon.replicas], mon.stats(),
                     list(r.drained), list(r.readmitted)))
    return seen, ns.health.BACKOFF_CAP_MULT


_BOOM = [RuntimeError("dead")]


@pytest.mark.parametrize("case", ["threshold", "backoff", "stall", "pressure", "manual",
                                  "two replicas"])
def test_monitor_state_machine_matches_jax(case):
    scripts, ticks, manual, kw = {
        "threshold": ([_BOOM * 2 + [_OK]], range(5), (),
                      dict(interval=1, fail_threshold=2, backoff=2, auto_drain=True)),
        "backoff": ([[RuntimeError(i) for i in range(10)]], [0] + [None] * 6, (),
                    dict(interval=1, fail_threshold=1, backoff=2, auto_drain=True)),
        "stall": ([[_BUSY, dict(_BUSY), dict(_BUSY)]], range(3), (),
                  dict(interval=1, fail_threshold=3, backoff=2)),
        "pressure": ([[dict(_OK, free_frac=0.0), dict(_BUSY, free_frac=0.0)]], range(2), (),
                     dict(interval=1, fail_threshold=3, exhaust_frac=0.0)),
        "manual": ([_BOOM * 5], range(4), (0,),
                   dict(interval=1, fail_threshold=1, auto_drain=True)),
        "two replicas": ([[_BUSY, _BOOM[0], _BOOM[0], _OK], [_OK, _BUSY, _BUSY, _BUSY]],
                         range(12), (), dict(interval=2, fail_threshold=2, backoff=1,
                                             auto_drain=True)),
    }[case]
    got = [_monitor_run(ns, scripts, ticks, manual, **kw) for ns in packages()]
    assert got[0] == got[1]
    seen, cap = got[1]
    last = seen[-1]
    if case == "threshold":
        assert last[2] == {"auto_drains": 1, "recoveries": 1, "down": 0}
        assert last[3] == [0] and last[4] == [0]
    if case == "backoff":
        gaps = [b[0] - a[0] for a, b in zip(seen[1:], seen[2:])]
        assert gaps == [4, 8, 16, 16, 16] and 16 == 2 * cap
    if case == "stall":
        assert "no progress" in seen[1][1][0]["last_error"]
    if case == "pressure":
        assert seen[0][1][0]["state"] == "healthy" and seen[1][1][0]["state"] == "suspect"
    if case == "manual":
        assert last[1][0]["probes"] == 0 and last[3] == []


# ------------------------------------------------------- router serves


def test_zero_healthy_replicas_parks_then_places(model):
    def drive(router, ns):
        router.reset()
        sp = ns.SamplingParams(max_tokens=4)
        rid0 = router.add_request(ns.ServeRequest(prompt=np.arange(1, 7), sampling=sp))
        for _ in range(30):
            router.step()
            if router.healthy() == []:
                break
        assert router.healthy() == [], "fault never tripped auto-drain"
        rid1 = router.add_request(ns.ServeRequest(prompt=np.arange(1, 7), sampling=sp))
        parked = router.stats()["backlog"]
        run_router(router)
        return rid0, rid1, parked

    plans = lambda ns: [ns.faults.FaultPlan((ns.faults.FaultEvent(1, "crash", 3),))]  # noqa: E731
    (jv, _), (tv, tr) = router_pair(model, drive, PROBED_SERVING, n=1, plans=plans)
    assert jv == tv and tv[2] >= 1
    res = tr.results()
    assert res[tv[1]]["finish_reason"] == "max_tokens"
    assert list(res[tv[0]]["tokens"]) == list(res[tv[1]]["tokens"])
    assert tr.stats()["backlog"] == 0


def test_forced_drain_may_take_the_last_replica(model):
    def drive(router, ns):
        router.reset()
        router.drain(1)
        try:
            router.drain(0)
        except Exception as e:  # noqa: BLE001 - compared across packages
            refused = (type(e).__name__, str(e))
        return refused, router.drain(0, force=True), router.healthy()

    (jv, _), (tv, _) = router_pair(model, drive, PROBED_SERVING)
    assert jv == tv and tv[0][0] == "SchedulerConfigError" and tv[1:] == (0, [])


def test_stats_expose_the_health_counters(model):
    def drive(router, ns):
        router.reset()
        router.add_request(ns.ServeRequest(prompt=np.arange(1, 6),
                                           sampling=ns.SamplingParams(max_tokens=3)))
        run_router(router)

    (_, _), (_, tr) = router_pair(model, drive, PROBED_SERVING)
    st = tr.stats()
    for key in ("timeouts", "shed", "rebalanced", "auto_drains", "recoveries", "backlog",
                "backlog_timeouts", "down"):
        assert key in st, key
    for row in st["per_replica"]:
        assert row["health"] == "healthy" and row["consecutive_failures"] == 0
        assert row["auto_drained"] is False and "probe_failures" in row


# ----------------------------------------------------------- rebalance


def _greedy3(ns):
    return [ns.ServeRequest(prompt=np.arange(1, 8), sampling=ns.SamplingParams(max_tokens=8),
                            rid=i) for i in range(3)]


def test_rebalance_mid_decode_as_jax(model, alone):
    def drive(router, ns):
        router.reset()
        for r in _greedy3(ns):
            router.add_request(r)
        for _ in range(6):
            router.step()
        src = router.replica_of(0)
        moved = router.rebalance(0, 1 - src)
        where = (src, router.replica_of(0), router.healthy())
        run_router(router)
        return moved, where

    (jv, _), (tv, tr) = router_pair(model, drive, ROUTER_SERVING)
    assert jv == tv and tv[0] is True and tv[1][1] == 1 - tv[1][0] and tv[1][2] == [0, 1]
    assert _tokens(tr.results()) == alone(_greedy3)
    assert tr.stats()["rebalanced"] == 1


def test_rebalance_mid_prefill_as_jax(model, alone):
    make = lambda ns: [ns.ServeRequest(prompt=np.arange(1, 25), rid=0,  # noqa: E731
                                       sampling=ns.SamplingParams(max_tokens=6))]

    def drive(router, ns):
        router.reset()
        router.add_request(make(ns)[0])
        src = router.replica_of(0)
        router.step()  # one chunk of six in
        row = [r for r in router.engines[src]._st.sched.occupied() if r.rid == 0]
        assert row and row[0].state == "prefilling"
        moved = router.rebalance(0, 1 - src)
        run_router(router)
        return moved

    (jv, _), (tv, tr) = router_pair(model, drive, ROUTER_SERVING)
    assert jv is tv is True
    assert _tokens(tr.results()) == alone(make)
    assert tr.results()[0]["finish_reason"] == "max_tokens"


def test_double_migration_seeded_as_jax(model, alone):
    make = lambda ns: [ns.ServeRequest(prompt=np.arange(1, 9), rid=0,  # noqa: E731
                                       sampling=ns.SamplingParams(temperature=0.9, top_k=12,
                                                                  seed=31, max_tokens=10))]

    def drive(router, ns):
        router.reset()
        router.add_request(make(ns)[0])
        path = [router.replica_of(0)]
        for hops in (4, 3):
            for _ in range(hops):
                router.step()
            assert router.rebalance(0, (path[-1] + 1) % 3) is True
            path.append(router.replica_of(0))
        run_router(router)
        return path

    (jv, _), (tv, tr) = router_pair(model, drive, ROUTER_SERVING, n=3)
    assert jv == tv and len(set(tv)) == 3
    assert _tokens(tr.results()) == alone(make)
    assert tr.results()[0]["preemptions"] >= 1 and tr.stats()["rebalanced"] == 2


def test_rebalance_guards_as_jax(model):
    def drive(router, ns):
        router.reset()
        rid = router.add_request(ns.ServeRequest(prompt=np.arange(1, 5),
                                                 sampling=ns.SamplingParams(max_tokens=2)))
        src = router.replica_of(rid)
        out = [router.rebalance(rid, src), router.rebalance(999, 1 - src)]
        try:
            router.rebalance(rid, 7)
        except Exception as e:  # noqa: BLE001 - compared across packages
            out.append((type(e).__name__, str(e)))
        run_router(router)
        return out + [router.rebalance(rid, 1 - src)]

    (jv, _), (tv, _) = router_pair(model, drive, ROUTER_SERVING)
    assert jv == tv and tv[0] is tv[1] is tv[3] is False and tv[2][0] == "SchedulerConfigError"


# -------------------------------------------------- deadlines and shedding


def test_explicit_deadline_times_out_through_the_router(model):
    def drive(router, ns):
        router.reset()
        events = []
        router.add_request(ns.ServeRequest(prompt=np.arange(1, 6), sampling=ns.SamplingParams(
            max_tokens=25, deadline=4.0)), stream=events.append)
        run_router(router)
        return [(e.token, e.index, e.finished, e.finish_reason) for e in events]

    (jv, _), (tv, tr) = router_pair(model, drive, ROUTER_SERVING)
    assert jv == tv
    res = tr.results()[0]
    assert res["finish_reason"] == "timeout" and len(res["tokens"]) < 25
    assert tv[-1] == (-1, len(res["tokens"]), True, "timeout")
    assert tr.stats()["timeouts"] == 1


def test_parked_request_times_out(model):
    def drive(router, ns):
        router.reset()
        router._auto_drain(0)
        rid = router.add_request(ns.ServeRequest(
            prompt=np.arange(1, 5), sampling=ns.SamplingParams(max_tokens=4, deadline=2.0)))
        for _ in range(4):
            router.step()
        return rid

    (jv, _), (tv, tr) = router_pair(model, drive, PROBED_SERVING, n=1)
    assert jv == tv
    assert tr.results()[tv]["finish_reason"] == "timeout"
    st = tr.stats()
    assert st["backlog_timeouts"] == 1 and st["backlog"] == 0 and st["timeouts"] == 1


def test_bounded_backlog_sheds_batch_class(model):
    def drive(router, ns):
        router.reset()
        router._auto_drain(0)
        sp = ns.SamplingParams(max_tokens=3)
        rids = [router.add_request(ns.ServeRequest(prompt=np.arange(1, 5), slo=slo,
                                                   sampling=sp))
                for slo in (ns.request.BATCH, ns.request.BATCH, ns.request.INTERACTIVE)]
        st = router.stats()
        before = (st["shed"], st["backlog"], sorted(router.results()))
        router.readmit(0)
        run_router(router)
        return rids, before

    (jv, _), (tv, tr) = router_pair(model, drive, dict(PROBED_SERVING, max_backlog=1), n=1)
    assert jv == tv
    (r0, r1, r2), (shed, backlog, finished) = tv
    assert shed == 1 and backlog == 2 and finished == [r1]
    res = tr.results()
    assert res[r1]["finish_reason"] == "shed" and len(res[r1]["tokens"]) == 0
    assert res[r0]["finish_reason"] == res[r2]["finish_reason"] == "max_tokens"
