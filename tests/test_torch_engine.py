"""The port's ``ContinuousServeEngine`` against the JAX package's: greedy
token streams, per-token ticks, every ``stats()`` counter and the output
events are identical on seeded ``make_workload`` traces, with a roomy arena
and with one small enough to force recompute preemption. Float32, the port's
paged kernels in their plain CPU versions and the reference's Pallas kernels
in interpret mode. Every knob the port does not implement is refused."""
import dataclasses

import numpy as np
import pytest

import jax

from repro import configs as jconfigs
from repro.configs import ARCHS, smoke_config
from repro.models import model as JM
from repro.serving import engine as jeng
from repro.serving.request import SamplingParams as JSamplingParams
from repro.serving.request import ServeRequest as JServeRequest
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


def _serving(mod, **kw):
    base = dict(num_slots=3, page_size=4, max_blocks_per_slot=32, prefill_chunk=8)
    base.update(kw)
    return mod.ServingCfg(**base)


@pytest.mark.parametrize("num_pages,fused", [(65, True), (13, True), (13, False)])
def test_streams_and_stats_match_jax(model, num_pages, fused):
    cfg, tcfg, params, tparams = model
    work = make_workload(0, 10, cfg.vocab_size, 0.5)
    kw = dict(num_pages=num_pages, use_paged_kernels=fused)
    je = jeng.ContinuousServeEngine(cfg, params, serving=_serving(jconfigs, **kw))
    jres, jst = je.serve([JRequest(rid=w.rid, prompt=w.prompt, max_new_tokens=w.target,
                                   arrival=w.arrival) for w in work],
                         jeng.GenerationConfig(max_new_tokens=80))
    te = T.ContinuousServeEngine(tcfg, tparams, serving=_serving(T, **kw), device="cpu")
    tres, tst = te.serve([T.Request(rid=w.rid, prompt=w.prompt, max_new_tokens=w.target,
                                    arrival=w.arrival) for w in work],
                         T.GenerationConfig(max_new_tokens=80))
    assert sorted(tres) == sorted(jres)
    for rid in jres:
        for key, val in jres[rid].items():
            np.testing.assert_array_equal(np.asarray(tres[rid][key]), np.asarray(val),
                                          err_msg=f"request {rid}: {key}")
    assert set(tst) == set(jst)
    for key in set(jst) - set(TIMERS):
        np.testing.assert_array_equal(np.asarray(tst[key]), np.asarray(jst[key]),
                                      err_msg=key)
    if num_pages == 13:
        assert jst["preemptions"] > 0  # the tight arena did force recompute
    assert tst["dense_pages_leaked"] == 0


def test_request_api_events_match_jax(model):
    """ServeRequest + step() + pending_outputs: the same events, tick by
    tick, with stop tokens and an EOS id."""
    cfg, tcfg, params, tparams = model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32) for n in (9, 3, 17, 5)]
    events = []
    for mod, eng in ((jconfigs, jeng.ContinuousServeEngine(
                          cfg, params, serving=_serving(jconfigs, num_pages=33))),
                     (T, T.ContinuousServeEngine(tcfg, tparams,
                                                 serving=_serving(T, num_pages=33),
                                                 device="cpu"))):
        is_jax = mod is not T
        SP = JSamplingParams if is_jax else T.SamplingParams
        SR = JServeRequest if is_jax else T.ServeRequest
        eng.reset((jeng if is_jax else T).GenerationConfig(eos_id=7))
        for i, p in enumerate(prompts):
            eng.add_request(SR(p, sampling=SP(max_tokens=6 + i, stop_token_ids=(11,)),
                               arrival=float(i)))
        ticks = []
        while eng.has_unfinished():
            ticks.append([tuple(dataclasses.astuple(e)) for e in eng.step()])
        events.append((ticks, [dataclasses.astuple(e) for e in eng.pending_outputs()]))
    assert events[0] == events[1]


def test_generate_matches_jax(model):
    cfg, tcfg, params, tparams = model
    toks = np.random.default_rng(2).integers(0, 256, size=(3, 7)).astype(np.int32)
    out_j, _ = jeng.ContinuousServeEngine(
        cfg, params, serving=_serving(jconfigs, num_pages=33)).generate(
        {"tokens": toks}, jeng.GenerationConfig(max_new_tokens=5))
    out_t, _ = T.ContinuousServeEngine(
        tcfg, tparams, serving=_serving(T, num_pages=33), device="cpu").generate(
        {"tokens": toks}, T.GenerationConfig(max_new_tokens=5))
    np.testing.assert_array_equal(out_t, out_j)


@pytest.mark.parametrize("serving_kw,rt_kw", [
    (dict(share_prefix=True), {}),
    (dict(spec_len=2), {}),
    (dict(defrag_every=2), {}),
    (dict(policy="priority"), {}),
    (dict(policy="slo"), {}),
    ({}, dict(mesh=object())),
    ({}, dict(mode="decomposed_cpq")),
    ({}, dict(mode="retrieval", mesh=object())),  # T3 serves, but not over a mesh
])
def test_unported_knobs_raise(model, serving_kw, rt_kw):
    _, tcfg, _, tparams = model
    with pytest.raises(T.SchedulerConfigError, match="not ported yet"):
        T.ContinuousServeEngine(tcfg, tparams, rt=T.AttentionRuntime(**rt_kw),
                                serving=_serving(T, num_pages=33, **serving_kw),
                                device="cpu")


def test_unported_inputs_and_sampling_raise(model):
    _, tcfg, _, tparams = model
    with pytest.raises(T.SchedulerConfigError, match="input_kind"):
        T.ContinuousServeEngine(dataclasses.replace(tcfg, input_kind="audio_frames"),
                                tparams, serving=_serving(T, num_pages=33), device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        T.ContinuousServeEngine(T.smoke_config(T.ARCHS["deepseek-v2-lite-16b"]),
                                tparams, serving=_serving(T, num_pages=33), device="cpu")
    eng = T.ContinuousServeEngine(tcfg, tparams, serving=_serving(T, num_pages=33),
                                  device="cpu")
    with pytest.raises(T.SchedulerConfigError, match="A6"):
        eng.add_request(T.ServeRequest(np.arange(4), sampling=T.SamplingParams(temperature=0.7)))
    eng.reset(T.GenerationConfig(temperature=0.5))
    with pytest.raises(T.SchedulerConfigError, match="A6"):
        eng.add_request(T.Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                                  max_new_tokens=3))


def test_static_engine_refuses_sampling(model):
    """The static engine serves greedy batches only, as the continuous one."""
    _, tcfg, _, tparams = model
    eng = T.ServeEngine(tcfg, tparams, device="cpu")
    with pytest.raises(T.SchedulerConfigError, match="A6"):
        eng.generate({"tokens": np.arange(6, dtype=np.int32).reshape(2, 3)},
                     T.GenerationConfig(max_new_tokens=2, temperature=0.5))
