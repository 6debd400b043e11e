"""The port's ``serving/trace.py`` against the JAX package's: every workload
generator gives the same items for the same seed, ``equal_arena_serving``
the same config, and ``run_trace`` the same metrics dict (timers aside) on a
greedy Poisson trace, on the templated trace with prefix sharing, on the
loopy trace with speculation, and on the SLO trace under each policy with
its per-class tails. Float32, CPU."""
import dataclasses

import numpy as np
import pytest

from repro.serving import trace as jtrace
from repro_torch.serving import trace as ttrace

from torch_paged_cases import assert_same, packages, share_compiled, smoke_pair

GENERATORS = [
    ("make_workload", dict(seed=0, n_requests=12, vocab=256, rate=0.5)),
    ("make_workload", dict(seed=3, n_requests=9, vocab=151936, rate=2.0,
                           long_prompt=(40, 90), p_long_prompt=0.3)),
    ("make_templated_workload", dict(seed=0, n_sessions=8, vocab=151936, rate=0.5,
                                     sys_tokens=256, turns=3, turn_step=64)),
    ("make_loopy_workload", dict(seed=0, n_requests=8, vocab=151936, motif=32, reps=4,
                                 target=64)),
    ("make_loopy_workload", dict(seed=1, n_requests=3, vocab=256, gap=7.5)),
    ("make_slo_workload", dict(seed=0, n_requests=24, vocab=151936, rate=0.5)),
    ("make_burst_workload", dict(seed=2, n_requests=16, vocab=256, rate=1.0)),
]


def _items(out):
    work, slos = out if isinstance(out, tuple) else (out, None)
    items = [dataclasses.astuple(w) for w in work]
    return items, None if slos is None else [dataclasses.astuple(s) for s in slos]


@pytest.mark.parametrize("name,kw", GENERATORS)
def test_generators_give_the_same_items(name, kw):
    (ji, js), (ti, ts) = (_items(getattr(m, name)(**kw)) for m in (jtrace, ttrace))
    assert js == ts and len(ji) == len(ti)
    for a, b in zip(ji, ti):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
            assert np.asarray(y).dtype == np.asarray(x).dtype


def test_equal_arena_serving():
    for args in ((4, 100, 16), (8, 64, 4, 0, 4)):
        assert (dataclasses.asdict(ttrace.equal_arena_serving(*args))
                == dataclasses.asdict(jtrace.equal_arena_serving(*args)))


@pytest.fixture(scope="module")
def model():
    return smoke_pair()


def _run_pair(model, make_work, serving, **kw):
    cfg, tcfg, params, tparams = model
    out = []
    for ns, c, p in zip(packages(), (cfg, tcfg), (params, tparams)):
        work, slos = make_work(ns)
        # the JAX engine adopts the process's donor of its (cfg, rt)
        donor = {} if ns.device else {"donor": share_compiled(ns.Engine(
            c, p, rt=kw.get("mode_rt"), serving=ns.ServingCfg(**serving)))}
        out.append(ns.trace.run_trace(c, p, work, ns.ServingCfg(**serving), slos=slos,
                                      **kw, **ns.device, **donor))
    jm, tm = out
    assert_same(jm, tm, "run_trace")
    return jm


SERVING = dict(num_slots=3, page_size=4, num_pages=97, max_blocks_per_slot=32,
               prefill_chunk=8)


def test_run_trace_poisson(model):
    m = _run_pair(model, lambda ns: (ns.trace.make_workload(0, 10, 256, 0.5), None),
                  SERVING)
    assert m["useful_tokens"] > 0


def test_run_trace_templated_with_sharing(model):
    m = _run_pair(model, lambda ns: (ns.trace.make_templated_workload(
        1, 4, 256, 0.5, sys_tokens=12, turns=2, turn_step=6), None),
        dict(SERVING, share_prefix=True, defrag_every=3))
    assert m["prefix_hits"] > 0


def test_run_trace_loopy_with_speculation(model):
    m = _run_pair(model, lambda ns: (ns.trace.make_loopy_workload(
        0, 3, 256, motif=6, reps=3, target=20), None), dict(SERVING, spec_len=3))
    assert m["spec_steps"] > 0


@pytest.mark.parametrize("policy", ["fifo", "slo"])
def test_run_trace_slo_tails(model, policy):
    m = _run_pair(model, lambda ns: ns.trace.make_slo_workload(0, 12, 256, 0.5),
                  dict(SERVING, num_slots=2), policy=policy)
    assert m["policy"] == policy and "ttft_p95_interactive" in m
