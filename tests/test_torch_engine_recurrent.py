"""The recurrent stacks served by the port against the JAX package's
engines: smoke xlstm-125m (5 mLSTM + 1 sLSTM layers, no attention) and smoke
jamba (Mamba layers around one attention layer, dense and MoE MLPs, in modes
dense and decomposed), float32, the same weights on both sides (carried by
``from_jax``). The continuous engine is asked for chunks of 16 and must
admit these stacks one-shot at their exact prompt length, as the reference
does: greedy streams, tick stamps, output events and every ``stats()``
counter identical, ``arena_bytes_total`` (slot states included) too, with
and without recompute preemption forced by a small arena. The static
engine's streams are identical as well."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from repro.serving import engine as jeng
from repro.serving.trace import make_workload
import repro_torch as T
from torch_paged_cases import serve_pair, smoke_pair

XLSTM, JAMBA = "xlstm-125m", "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def models():
    return {arch: smoke_pair(arch, num_blocks=1) for arch in (XLSTM, JAMBA)}


def _requests(model, n, seed=0, cap=24):
    work = [(w.rid, w.prompt, min(w.target, cap), w.arrival)
            for w in make_workload(seed, n, model[0].vocab_size, 0.5)]
    return lambda ns: [ns.Request(rid=r, prompt=p, max_new_tokens=k, arrival=a)
                       for r, p, k, a in work]


@pytest.mark.parametrize("arch,mode,num_pages,extra", [
    (XLSTM, "dense", 65, {}),
    (XLSTM, "dense", 13, {}),        # recompute preemption re-admits one-shot
    (JAMBA, "dense", 65, {}),
    (JAMBA, "dense", 13, {}),
    (JAMBA, "decomposed", 65, {}),
    (JAMBA, "dense", 65, dict(defrag_every=2)),   # defrag passes the states by
    (JAMBA, "dense", 13, dict(enable_escalation=True, escalated_pages=65,   # and escalation
                              low_watermark=0.5, critical_watermark=0.45)),
])
def test_continuous_engine_matches_jax(models, arch, mode, num_pages, extra):
    model = models[arch]
    (_, jst), (_, tst) = serve_pair(
        model, _requests(model, 7),
        dict(num_slots=3, page_size=4, num_pages=num_pages, max_blocks_per_slot=32,
             prefill_chunk=16, prefill_bucket=8, **extra),
        gen=dict(max_new_tokens=24), rt=dict(mode=mode))
    assert not tst["chunked_prefill"] and tst["prefill_chunks"] == 0
    assert not tst["prefix_sharing"] and not tst["spec_on"]
    assert tst["admitted"] >= 7 and tst["cache_mode"] == mode
    if "defrag_every" in extra:
        assert tst["defrags"] > 0
    elif "enable_escalation" in extra:
        assert tst["tiered"] and tst["escalations"] > 0
    else:
        assert (tst["preemptions"] > 0) == (num_pages == 13)
    if arch == XLSTM:   # attention-free: no per-token traffic, slot states only
        assert tst["bytes_per_token_layer"] == 0.0
        d_in, dh = 128, 32   # smoke widths: d_model 64, proj_factor 2, 4 heads
        mlstm = 3 * (4 * dh * dh + 4 * dh + 4) * 4 + 3 * 3 * d_in * 4
        slstm = 3 * 4 * 64 * 4
        assert tst["arena_bytes_total"] == 5 * mlstm + slstm


@pytest.mark.parametrize("arch,mode", [(XLSTM, "dense"), (JAMBA, "dense"),
                                       (JAMBA, "decomposed")])
def test_static_engine_matches_jax(models, arch, mode):
    cfg, tcfg, params, tparams = models[arch]
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(3, 11)).astype(np.int32)
    jrt = dataclasses.replace(cfg.attention, mode=mode)
    out_j, st_j = jeng.ServeEngine(cfg, params, rt=jrt).generate(
        {"tokens": jnp.asarray(toks)}, jeng.GenerationConfig(max_new_tokens=8))
    out_t, st_t = T.ServeEngine(tcfg, tparams, rt=T.AttentionRuntime(mode=mode),
                                device="cpu").generate(
        {"tokens": toks}, T.GenerationConfig(max_new_tokens=8))
    np.testing.assert_array_equal(out_t, np.asarray(out_j))
    assert st_t == st_j
