"""The port's ``ContinuousServeEngine`` against the JAX package's in
``mode="decomposed"`` (T1: the arena caches the normed block input X and a
roped key slice instead of K and V). Greedy token streams, per-token ticks
and every ``stats()`` counter are identical, with the paged kernels (the
port's plain versions, the reference's Pallas kernels in interpret mode) and
with the gather path, on qwen1.5-0.5b smoke (RoPE: a decoupled roped slice,
QKV bias) with and without recompute preemption, and on opt-6.7b smoke
(absolute positions: no roped slice, no QKV bias), where T1 is exact and
its streams also equal the port's own dense streams. Float32."""
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

from torch_paged_cases import share_compiled

TIMERS = ("wall_time_s", "tokens_per_s")


def _model(arch: str):
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32", num_blocks=2)
    tcfg = dataclasses.replace(T.smoke_config(T.ARCHS[arch]), dtype="float32",
                               num_blocks=2)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, from_jax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def qwen():
    return _model("qwen1.5-0.5b")


@pytest.fixture(scope="module")
def opt():
    return _model("opt-6.7b")


def _serve_both(model, work, max_new, mode, **serving_kw):
    """Serve the same workload on both engines; assert identical results and
    stats; return (port results, port stats)."""
    cfg, tcfg, params, tparams = model
    kw = dict(num_slots=3, page_size=4, max_blocks_per_slot=32, prefill_chunk=8)
    kw.update(serving_kw)
    jres, jst = share_compiled(jeng.ContinuousServeEngine(
        cfg, params, rt=jconfigs.AttentionRuntime(mode=mode),
        serving=jconfigs.ServingCfg(**kw))).serve(
        [JRequest(rid=w.rid, prompt=w.prompt, max_new_tokens=w.target, arrival=w.arrival)
         for w in work], jeng.GenerationConfig(max_new_tokens=max_new))
    tres, tst = T.ContinuousServeEngine(
        tcfg, tparams, rt=T.AttentionRuntime(mode=mode), serving=T.ServingCfg(**kw),
        device="cpu").serve(
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
def test_decomposed_streams_and_stats_match_jax(qwen, num_pages, fused):
    work = make_workload(0, 10, qwen[0].vocab_size, 0.5)
    _, st = _serve_both(qwen, work, 80, "decomposed", num_pages=num_pages,
                        use_paged_kernels=fused)
    assert st["cache_mode"] == "decomposed" and not st["tiered"]
    # X (64 floats) + the roped slices (4 kv heads x 8) + a table entry per page
    assert st["bytes_per_token_layer"] == 4 * (64 + 4 * 8) + 4 / 4
    if num_pages == 13:
        assert st["preemptions"] > 0  # the tight arena did force recompute


@pytest.mark.parametrize("fused", [True, False])
def test_opt_decomposed_matches_jax_and_dense(opt, fused):
    """opt-6.7b: absolute positions, so no roped slice (Rr = 0), and no QKV
    bias: T1 is exact, and its greedy streams equal dense attention's."""
    work = make_workload(1, 8, opt[0].vocab_size, 0.5)
    t1, st = _serve_both(opt, work, 40, "decomposed", num_pages=65,
                         use_paged_kernels=fused)
    assert st["bytes_per_token_layer"] == 4 * 64 + 4 / 4
    _, tcfg, _, tparams = opt
    dense, _ = T.ContinuousServeEngine(
        tcfg, tparams, serving=T.ServingCfg(num_slots=3, page_size=4, num_pages=65,
                                            max_blocks_per_slot=32, prefill_chunk=8,
                                            use_paged_kernels=fused),
        device="cpu").serve(
        [T.Request(rid=w.rid, prompt=w.prompt, max_new_tokens=w.target, arrival=w.arrival)
         for w in work], T.GenerationConfig(max_new_tokens=40))
    for rid in dense:
        np.testing.assert_array_equal(t1[rid]["tokens"], dense[rid]["tokens"])
