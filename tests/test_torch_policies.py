"""The port's scheduling policies (``PriorityPolicy``, ``SloAwarePolicy``,
``make_policy``) against the JAX package's. The same queue gives the same
admission, preemption and escalation decisions; the engines serve the
reference's policy traces (``tests/test_serving_policies.py``) and
``make_slo_workload`` under each policy with identical streams, ticks and
counters, including de-escalation of a tiered engine and the timeouts of
deadline shedding (``ServingCfg.deadline_scale``). Float32, CPU."""
import numpy as np
import pytest

from repro.configs import ServingCfg as JServingCfg
from repro.serving import policies as jpol
from repro.serving.request import SloClass as JSloClass
from repro.serving.scheduler import Request as JRequest, Scheduler as JScheduler
import repro_torch as T
from repro_torch.serving import policies as tpol
from repro_torch.serving.request import SloClass
from repro_torch.serving.scheduler import Scheduler

from torch_paged_cases import serve_pair, smoke_pair

SERVING = dict(num_slots=3, page_size=4, num_pages=17, max_blocks_per_slot=4)

QUEUE = [  # rid, prompt length, arrival, priority, ttft target
    (0, 4, 0.0, 0, None), (1, 5, 0.0, 2, 3.0), (2, 3, 1.0, 1, 100.0),
    (3, 6, 2.0, 0, None), (4, 4, 40.0, 1, 8.0), (5, 2, 0.0, None, None),
]


def _queue(Req, Slo):
    out = []
    for rid, plen, arrival, prio, ttft in QUEUE:
        slo = (None if prio is None else
               Slo(f"c{prio}", priority=prio,
                   ttft_target=float("inf") if ttft is None else ttft))
        out.append(Req(rid=rid, prompt=np.arange(plen, dtype=np.int32) % 7,
                       max_new_tokens=4, arrival=arrival, slo=slo))
    return out


@pytest.mark.parametrize("name,kw", [("fifo", {}), ("priority", {}),
                                     ("priority", dict(aging_ticks=10)), ("slo", {})])
def test_scheduler_decisions_match_jax(name, kw):
    """Admissions over time, then the preemption victim of every slot
    holder, under each policy."""
    picks = []
    for Sched, Cfg, Req, Slo, pol in (
            (JScheduler, JServingCfg, JRequest, JSloClass, jpol.make_policy(name, **kw)),
            (Scheduler, T.ServingCfg, T.Request, SloClass, tpol.make_policy(name, **kw))):
        sched = Sched(Cfg(**SERVING), policy=pol)
        for r in _queue(Req, Slo):
            sched.submit(r)
        seen = []
        for now in (0, 0, 1, 20, 45):
            got = sched.admit_next(now=now, step=now)
            seen.append(None if got is None else got.rid)
        for r in sched.occupied():
            v = sched.preemption_victim(exclude=r)
            seen.append((r.rid, None if v is None else v.rid))
        seen.append([r.rid for r in pol.admission_order(sched, 50)])
        picks.append(seen)
    assert picks[0] == picks[1]


def test_make_policy():
    assert [tpol.make_policy(n).name for n in ("fifo", "priority", "slo")] == \
        ["fifo", "priority", "slo"]
    assert tpol.make_policy("slo").deescalate and not tpol.make_policy("priority").deescalate
    with pytest.raises(ValueError, match="unknown scheduler policy"):
        tpol.make_policy("round-robin")


@pytest.fixture(scope="module")
def model():
    return smoke_pair()


def test_policy_string_and_object(model):
    _, tcfg, _, tparams = model
    eng = T.ContinuousServeEngine(tcfg, tparams, serving=T.ServingCfg(policy="slo"),
                                  device="cpu")
    assert eng.make_policy().name == "slo"
    eng = T.ContinuousServeEngine(tcfg, tparams, policy=tpol.PriorityPolicy(),
                                  device="cpu")
    assert eng.make_policy().name == "priority"
    eng = T.ContinuousServeEngine(tcfg, tparams, policy="priority", device="cpu")
    assert eng.make_policy().name == "priority"


@pytest.mark.parametrize("policy", ["fifo", "priority", "slo"])
def test_contended_single_slot_serves_as_jax(model, policy):
    """Batch jobs first, an interactive request second, one slot."""
    def requests(ns):
        rng = np.random.default_rng(3)
        reqs = [ns.Request(rid=i, prompt=rng.integers(0, 256, 5).astype(np.int32),
                           max_new_tokens=8, slo=ns.SloClass("batch", priority=0))
                for i in range(3)]
        reqs.append(ns.Request(rid=9, prompt=rng.integers(0, 256, 4).astype(np.int32),
                               max_new_tokens=3, arrival=1.0,
                               slo=ns.SloClass("interactive", priority=2, ttft_target=8.0)))
        return reqs

    (jres, jst), _ = serve_pair(model, requests, dict(
        num_slots=1, page_size=4, num_pages=17, max_blocks_per_slot=4, prefill_bucket=4,
        prefill_chunk=4), policy=policy)
    assert jst["policy"] == policy


@pytest.mark.parametrize("case", ["restores", "sole_occupant"])
def test_deescalation_serves_as_jax(model, case):
    """``SloAwarePolicy`` re-admits an escalated T2 row dense once the dense
    arena recovers, on the reference's two de-escalation traces."""
    if case == "restores":
        serving = dict(num_slots=3, page_size=4, num_pages=13, escalated_pages=33,
                       max_blocks_per_slot=8, prefill_bucket=4, low_watermark=0.5,
                       critical_watermark=0.25, high_watermark=0.55,
                       enable_escalation=True)
        sizes, targets, seed = (8, 10, 6, 7, 9), (6, 16, 6, 6, 6), 2
    else:
        serving = dict(num_slots=2, page_size=4, num_pages=9, escalated_pages=33,
                       max_blocks_per_slot=8, prefill_bucket=4, prefill_chunk=4,
                       low_watermark=0.5, critical_watermark=0.25, high_watermark=0.6,
                       enable_escalation=True)
        sizes, targets, seed = (8, 8), (4, 20), 4

    def requests(ns):
        rng = np.random.default_rng(seed)
        return [ns.Request(rid=i, prompt=rng.integers(0, 256, s).astype(np.int32),
                           max_new_tokens=t) for i, (s, t) in enumerate(zip(sizes, targets))]

    (_, jst), _ = serve_pair(model, requests, serving, gen=dict(max_new_tokens=20),
                             policy=lambda ns: ns.policies.SloAwarePolicy())
    assert jst["deescalations"] >= 1


@pytest.mark.parametrize("policy,scale", [("fifo", 1.0), ("priority", 1.0),
                                          ("slo", 1.0), ("slo", 0.0)])
def test_slo_workload_timeouts_serve_as_jax(model, policy, scale):
    """``make_slo_workload`` with its classes: interactive requests carry
    tight deadlines, so with ``deadline_scale`` on, blown budgets retire as
    timeouts at the same ticks in both engines."""
    def requests(ns):
        work, slos = ns.trace.make_slo_workload(0, 14, 256, 0.5)
        return [ns.Request(rid=w.rid, prompt=w.prompt, max_new_tokens=w.target,
                           arrival=w.arrival, slo=s) for w, s in zip(work, slos)]

    (_, jst), _ = serve_pair(model, requests, dict(
        num_slots=2, page_size=4, num_pages=33, max_blocks_per_slot=32, prefill_chunk=8,
        deadline_scale=scale), gen=dict(max_new_tokens=80), policy=policy)
    assert (jst["timeouts"] > 0) == (scale > 0)
