"""The port's ``ContinuousServeEngine`` against the JAX package's in
``mode="retrieval"`` (T3: K, V and int8 proxy-code pages; decode attends the
top-k keys by proxy score plus a recent window, calibrated by the proxy's
estimate of the mass it drops). qwen1.5-0.5b smoke, two blocks, float32.

``RetrievalCfg(top_k=12, recent_window=4)`` makes every row past 12 keys
really select: with the default ``top_k=512`` every key of these prompts
would be picked and T3 would equal dense whatever the proxy codes are.
Greedy token streams, per-token ticks and every ``stats()`` counter are
identical, with the paged kernels (B7's plain version on the CPU, picking
by its scores) and with the gather path, with and without recompute
preemption. The JAX engine has one T3 decode, the gather path; the port's
kernel route scores the same codes in another float32 summation order, so
a key could swap at the top-k boundary where two proxy scores lie within an
ulp. No swap parts a stream on these workloads, and the test holds the
streams to be identical: it excuses none."""
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

from torch_paged_cases import share_compiled

TIMERS = ("wall_time_s", "tokens_per_s")
TOP_K, RECENT = 12, 4


@pytest.fixture(scope="module")
def qwen():
    cfg = dataclasses.replace(smoke_config(ARCHS["qwen1.5-0.5b"]), dtype="float32",
                              num_blocks=2)
    tcfg = dataclasses.replace(T.smoke_config(T.ARCHS["qwen1.5-0.5b"]), dtype="float32",
                               num_blocks=2)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _serve_both(model, work, max_new, **serving_kw):
    """Serve the same workload on both engines in T3; assert identical
    results and stats; return (port results, port stats)."""
    cfg, tcfg, params, tparams = model
    kw = dict(num_slots=3, page_size=4, max_blocks_per_slot=32, prefill_chunk=8)
    kw.update(serving_kw)
    jrt = jconfigs.AttentionRuntime(mode="retrieval", retrieval=JRetrievalCfg(
        top_k=TOP_K, recent_window=RECENT))
    trt = T.AttentionRuntime(mode="retrieval", retrieval=RetrievalCfg(
        top_k=TOP_K, recent_window=RECENT))
    jres, jst = share_compiled(jeng.ContinuousServeEngine(
        cfg, params, rt=jrt, serving=jconfigs.ServingCfg(**kw))).serve(
        [JRequest(rid=w.rid, prompt=w.prompt, max_new_tokens=w.target, arrival=w.arrival)
         for w in work], jeng.GenerationConfig(max_new_tokens=max_new))
    tres, tst = T.ContinuousServeEngine(
        tcfg, tparams, rt=trt, serving=T.ServingCfg(**kw), device="cpu").serve(
        [T.Request(rid=w.rid, prompt=w.prompt, max_new_tokens=w.target, arrival=w.arrival)
         for w in work], T.GenerationConfig(max_new_tokens=max_new))
    assert sorted(tres) == sorted(jres)
    for rid in jres:
        for key, val in jres[rid].items():
            np.testing.assert_array_equal(np.asarray(tres[rid][key]), np.asarray(val),
                                          err_msg=f"request {rid}: {key}")
    assert set(tst) == set(jst)
    for key in set(jst) - set(TIMERS):
        np.testing.assert_array_equal(np.asarray(tst[key]), np.asarray(jst[key]),
                                      err_msg=key)
    assert tst["dense_pages_leaked"] == 0
    return tres, tst


@pytest.mark.parametrize("num_pages,fused", [(65, True), (65, False), (13, True),
                                             (13, False)])
def test_retrieval_streams_and_stats_match_jax(qwen, num_pages, fused):
    work = make_workload(0, 10, qwen[0].vocab_size, 0.5)
    res, st = _serve_both(qwen, work, 80, num_pages=num_pages, use_paged_kernels=fused)
    assert st["cache_mode"] == "retrieval" and not st["tiered"]
    # K and V (4 kv heads x 16 floats each), one byte per proxy channel, and
    # a block-table entry per page of 4 tokens
    assert st["bytes_per_token_layer"] == 2 * 4 * 16 * 4 + 4 * 16 + 4 / 4
    # rows outgrow top_k + 1 keys, so decode really selects
    assert max(len(w.prompt) + len(res[w.rid]["tokens"]) for w in work) > TOP_K + 1
    if num_pages == 13:
        assert st["preemptions"] > 0  # the tight arena did force recompute
