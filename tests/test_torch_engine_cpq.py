"""The port's ``ContinuousServeEngine`` against the JAX package's in the T2
configurations: ``mode="cpq"`` (the whole arena holds CPQ codes) and the
tiered engine (``enable_escalation=True``: a dense arena with a CPQ
escalation arena behind it). Greedy token streams, per-token ticks and
every ``stats()`` counter are identical, with the paged kernels (the port's
plain versions, the reference's Pallas kernels in interpret mode) and with
the gather path. Float32."""
import dataclasses

import numpy as np
import pytest

import jax

from repro import configs as jconfigs
from repro.configs import ARCHS, smoke_config
from repro.models import model as JM
from repro.serving import engine as jeng
from repro.serving.scheduler import Request as JRequest
from repro.serving.trace import make_workload
import repro_torch as T
from repro_torch.params import from_jax

TIMERS = ("wall_time_s", "tokens_per_s")


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(smoke_config(ARCHS["qwen1.5-0.5b"]), dtype="float32",
                              num_blocks=2)
    tcfg = dataclasses.replace(T.smoke_config(T.ARCHS["qwen1.5-0.5b"]), dtype="float32",
                               num_blocks=2)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _serve_both(model, requests, max_new, mode="dense", **serving_kw):
    """Serve the same (rid, prompt, max_new_tokens, arrival) requests on both
    engines; assert identical results and stats; return the stats."""
    cfg, tcfg, params, tparams = model
    jres, jst = jeng.ContinuousServeEngine(
        cfg, params, rt=jconfigs.AttentionRuntime(mode=mode),
        serving=jconfigs.ServingCfg(**serving_kw)).serve(
        [JRequest(rid=r, prompt=p, max_new_tokens=n, arrival=a) for r, p, n, a in requests],
        jeng.GenerationConfig(max_new_tokens=max_new))
    tres, tst = T.ContinuousServeEngine(
        tcfg, tparams, rt=T.AttentionRuntime(mode=mode),
        serving=T.ServingCfg(**serving_kw), device="cpu").serve(
        [T.Request(rid=r, prompt=p, max_new_tokens=n, arrival=a) for r, p, n, a in requests],
        T.GenerationConfig(max_new_tokens=max_new))
    assert sorted(tres) == sorted(jres)
    for rid in jres:
        for key, val in jres[rid].items():
            np.testing.assert_array_equal(np.asarray(tres[rid][key]), np.asarray(val),
                                          err_msg=f"request {rid}: {key}")
    assert set(tst) == set(jst)
    for key in set(jst) - set(TIMERS):
        np.testing.assert_array_equal(np.asarray(tst[key]), np.asarray(jst[key]),
                                      err_msg=key)
    assert tst["dense_pages_leaked"] == 0 and tst["cpq_pages_leaked"] == 0
    return tst


@pytest.mark.parametrize("num_pages,fused", [(65, True), (65, False), (13, True),
                                             (13, False)])
def test_cpq_streams_and_stats_match_jax(model, num_pages, fused):
    """mode="cpq" on a roomy arena and on one tight enough to force
    recompute preemption. Budgets are capped at 12 tokens: the two packages'
    K/V differ in the last ulp (matmuls summed in another order), and over a
    long enough stream CPQ turns that into a code one step apart, after
    which the streams may part at a near tie; the CPQ functions themselves
    are bit-exact (test_torch_cpq.py)."""
    cfg = model[0]
    work = make_workload(0, 8, cfg.vocab_size, 0.5)
    st = _serve_both(model, [(w.rid, w.prompt, min(w.target, 12), w.arrival) for w in work],
                     12, mode="cpq", num_slots=3, page_size=4, num_pages=num_pages,
                     max_blocks_per_slot=32, prefill_chunk=8, use_paged_kernels=fused)
    assert st["cache_mode"] == "cpq" and not st["tiered"]
    if num_pages == 13:
        assert st["preemptions"] > 0


def _prompts(vocab, sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=s).astype(np.int32) for s in sizes]


TIERED = dict(num_slots=3, page_size=4, num_pages=13, escalated_pages=33,
              max_blocks_per_slot=8, prefill_bucket=4, low_watermark=0.5,
              critical_watermark=0.25, enable_escalation=True)


@pytest.mark.parametrize("prefill_chunk,seed", [(16, 2), (8, 3)])
@pytest.mark.parametrize("fused", [True, False])
def test_tiered_streams_and_stats_match_jax(model, prefill_chunk, seed, fused):
    """The workloads of the reference's ``test_tier_escalation_under_pressure``
    (prompts seeded 2, default chunk) and
    ``test_chunked_tiered_matches_oneshot_and_escalates`` (seeded 3, chunks
    of 8): dense rows escalate into the CPQ arena mid-request, and both
    arenas end leak-free."""
    prompts = _prompts(model[0].vocab_size, (8, 10, 6, 7, 9), seed)
    st = _serve_both(model, [(i, p, 10, 0.0) for i, p in enumerate(prompts)], 10,
                     prefill_chunk=prefill_chunk, use_paged_kernels=fused, **TIERED)
    assert st["tiered"] and st["escalations"] >= 1
