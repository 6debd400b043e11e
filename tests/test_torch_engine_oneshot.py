"""One-shot admission (``prefill_chunk=0``) of the port's
``ContinuousServeEngine`` against the JAX package's, in float32 on qwen's
smoke config with 2 layers: every admission prefills the bucket-padded
prompt into a B=1 contiguous cache (the contiguous kernels' plain versions,
or the plain path) and packs it into the slot's pages. Greedy streams, tick
stamps, every ``stats()`` counter and the clock's bucket charge are
identical in dense (with recompute preemption), decomposed, CPQ (streams
capped at 12 tokens, as in test_torch_engine_cpq.py), retrieval (``top_k``
below the prompt lengths) and the tiered engine, whose admissions under
memory pressure go into the CPQ tier. A bucket of 8 pads most prompts, so
the padding's writes go to the slot's last page or the null page
(``test_torch_contiguous.py`` holds the pack itself to the reference)."""
import dataclasses

import numpy as np
import pytest

import jax

from repro import configs as jconfigs
from repro.configs import ARCHS, smoke_config
from repro.configs.base import RetrievalCfg as JRetrievalCfg
from repro.models import model as JM
from repro.serving import engine as jeng
from repro.serving.scheduler import Request as JRequest
from repro.serving.trace import make_workload
import repro_torch as T
from repro_torch.configs import RetrievalCfg
from repro_torch.params import from_jax
from repro_torch.serving import scheduler as TS

from torch_paged_cases import share_compiled

TIMERS = ("wall_time_s", "tokens_per_s")


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(smoke_config(ARCHS["qwen1.5-0.5b"]), dtype="float32",
                              num_blocks=2)
    tcfg = dataclasses.replace(T.smoke_config(T.ARCHS["qwen1.5-0.5b"]), dtype="float32",
                               num_blocks=2)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _rt(mod, mode, fused=True):
    kw = {"paged_kernels": fused} if mod is T else {}
    if mode == "retrieval":
        cfg = (RetrievalCfg if mod is T else JRetrievalCfg)(top_k=8, recent_window=3)
        return mod.AttentionRuntime(mode=mode, retrieval=cfg, **kw)
    return mod.AttentionRuntime(mode=mode, **kw)


def _serve_both(model, requests, max_new, mode="dense", fused=True, **serving_kw):
    """Serve (rid, prompt, max_new_tokens, arrival) requests one-shot on both
    engines; assert identical results and stats. Returns (stats, the tiers
    the port's scheduler admitted into)."""
    cfg, tcfg, params, tparams = model
    kw = dict(prefill_chunk=0, **serving_kw)
    jres, jst = share_compiled(jeng.ContinuousServeEngine(
        cfg, params, rt=_rt(jconfigs, mode), serving=jconfigs.ServingCfg(**kw))).serve(
        [JRequest(rid=r, prompt=p, max_new_tokens=n, arrival=a) for r, p, n, a in requests],
        jeng.GenerationConfig(max_new_tokens=max_new))
    tiers, admit = [], TS.Scheduler.admit_next

    def admit_counted(sched, now, step):
        req = admit(sched, now, step)
        if req is not None:
            tiers.append(req.tier)
        return req

    TS.Scheduler.admit_next = admit_counted
    try:
        tres, tst = T.ContinuousServeEngine(
            tcfg, tparams, rt=_rt(T, mode, fused), serving=T.ServingCfg(**kw),
            device="cpu").serve(
            [T.Request(rid=r, prompt=p, max_new_tokens=n, arrival=a)
             for r, p, n, a in requests], T.GenerationConfig(max_new_tokens=max_new))
    finally:
        TS.Scheduler.admit_next = admit
    assert sorted(tres) == sorted(jres)
    for rid in jres:
        for key, val in jres[rid].items():
            np.testing.assert_array_equal(np.asarray(tres[rid][key]), np.asarray(val),
                                          err_msg=f"request {rid}: {key}")
    assert set(tst) == set(jst)
    for key in set(jst) - set(TIMERS):
        np.testing.assert_array_equal(np.asarray(tst[key]), np.asarray(jst[key]),
                                      err_msg=key)
    assert not tst["chunked_prefill"] and tst["prefill_chunks"] == 0
    assert tst["dense_pages_leaked"] == 0 and tst["cpq_pages_leaked"] == 0
    return tst, tiers


def _work(model, n, seed=0, cap=None):
    work = make_workload(seed, n, model[0].vocab_size, 0.5)
    return [(w.rid, w.prompt, min(w.target, cap or w.target), w.arrival) for w in work]


@pytest.mark.parametrize("num_pages,fused", [(65, True), (13, True), (13, False)])
def test_oneshot_dense_matches_jax(model, num_pages, fused):
    st, _ = _serve_both(model, _work(model, 8), 40, fused=fused, num_slots=3, page_size=4,
                        num_pages=num_pages, max_blocks_per_slot=32, prefill_bucket=8)
    if num_pages == 13:
        assert st["preemptions"] > 0   # recompute re-admits one-shot


@pytest.mark.parametrize("mode", ["decomposed", "cpq", "retrieval"])
def test_oneshot_modes_match_jax(model, mode):
    cap = 12 if mode == "cpq" else None
    st, _ = _serve_both(model, _work(model, 6, cap=cap), cap or 30, mode=mode,
                        num_slots=3, page_size=4, num_pages=65, max_blocks_per_slot=32,
                        prefill_bucket=8)
    assert st["cache_mode"] == mode


def test_oneshot_tiered_admits_into_cpq_and_matches_jax(model):
    """A dense arena of 10 pages behind a CPQ one: admissions while the
    dense free fraction is below 0.7 go into the CPQ tier (a B=1 CPQ prefill
    packed into the escalation arena), and running dense rows escalate."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model[0].vocab_size, size=s).astype(np.int32)
               for s in (8, 10, 6, 7, 9, 11)]
    st, tiers = _serve_both(
        model, [(i, p, 10, 0.0) for i, p in enumerate(prompts)], 10,
        num_slots=3, page_size=4, num_pages=11, escalated_pages=33, max_blocks_per_slot=8,
        prefill_bucket=4, low_watermark=0.7, critical_watermark=0.3,
        enable_escalation=True)
    assert st["tiered"] and 1 in tiers and 0 in tiers and st["escalations"] >= 1
