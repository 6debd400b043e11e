"""Speculative decoding of the port against the JAX package: prompt-lookup
drafting (``propose_ngram``) proposes the same tokens; the scheduler's draft
lifecycle (``begin_draft`` / ``draft_block_row`` / ``commit_draft`` /
``abort_draft``) makes the same page moves; ``verify_chunk_rows`` gives the
reference's logits at every position of a chunk at a mid-page offset; and
the engine serves the reference's speculative traces
(``tests/test_serving_speculative.py``) with the same streams, ticks and
counters: greedy in dense and T1 on both attention paths, the loopy trace
where drafts are accepted, seeded sampling (``spec_steps`` equal to the
reference's, whatever they are), recompute preemption, the tiered dense arm
and speculation beside prefix sharing. Float32, CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro.configs import ServingCfg as JServingCfg
from repro.kernels.flash_attn.ops import paged_flash_prefill_tpu
from repro.models import model as JM
from repro.serving.scheduler import Request as JRequest, Scheduler as JScheduler
from repro.serving.speculative import propose_ngram as j_propose
import repro_torch as T
from repro_torch.kernels.paged_attn import ops
from repro_torch.models import model as TM
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.speculative import propose_ngram

from torch_paged_cases import VERIFY_CASES, serve_pair, smoke_pair, tensors, verify_inputs


@settings(max_examples=80, deadline=None)
@given(ctx=st.lists(st.integers(0, 5), min_size=0, max_size=40),
       n=st.integers(1, 4), k=st.integers(0, 6))
def test_propose_ngram_matches_jax(ctx, n, k):
    c = np.asarray(ctx, np.int32)
    np.testing.assert_array_equal(propose_ngram(c, n, k), j_propose(c, n, k))


def _lifecycle(Sched, Cfg, Req):
    """The reference's draft-lifecycle schedule, as a trace of page moves."""
    sched = Sched(Cfg(num_slots=2, page_size=4, num_pages=17, max_blocks_per_slot=4,
                      prefill_chunk=4))
    r = Req(rid=0, prompt=np.arange(1, 7, dtype=np.int32), max_new_tokens=8)
    sched.submit(r)
    sched.admit_next(now=0, step=0)
    sched.note_chunk(r, 6)
    sched.finish_prefill(r)
    assert sched.ensure_writable(r)
    trace = []
    for k, accept in ((3, 2), (2, 0), (4, 3), (1, 1)):
        d = sched.begin_draft(r, k)
        if d is None:
            trace.append(None)
            continue
        trace.append((list(d.scratch), list(d.blocks), list(d.aliased), d.copy_src,
                      sched.draft_block_row(r).tolist(),
                      [sched.dense_alloc.refcount(p) for p in range(17)]))
        if accept:
            d.tokens = list(range(k))
            sched.commit_draft(r, accept)
            for _ in range(accept):
                r.generated.append(1)
                r.length += 1
                sched.lengths[r.slot] = r.length
            sched.ensure_writable(r)
        else:
            sched.abort_draft(r)
        trace.append((list(map(int, r.pages)), sched.block_tables.tolist(),
                      [sched.dense_alloc.refcount(p) for p in range(17)]))
    sched.retire(r, 0, "eos")
    trace.append((sched.dense_alloc.num_used, dict(sched.stats)))
    return trace


def test_draft_lifecycle_matches_jax():
    assert (_lifecycle(Scheduler, T.ServingCfg, T.Request)
            == _lifecycle(JScheduler, JServingCfg, JRequest))


@pytest.mark.parametrize("case", VERIFY_CASES[::3])
def test_b2_plain_at_verify_shapes_matches_jax_kernel(case):
    """B2's plain version (what the wrapper runs on the CPU) against the
    JAX Pallas kernel at the verify chunk's shapes over a draft's block
    row; the card's kernel is held to the plain version on every case in
    ``test_torch_kernels_cuda.py``."""
    q, kp, vp, row, offset, valid, scale = verify_inputs(*case)
    ref = paged_flash_prefill_tpu(*map(jnp.asarray, (q, kp, vp, row)),
                                  jnp.asarray(offset, jnp.int32),
                                  jnp.asarray(valid, jnp.int32), scale)
    out = ops.paged_prefill(*tensors(q, kp, vp, row), offset, valid, scale)
    np.testing.assert_allclose(out.numpy()[0, :valid], np.asarray(ref)[0, :valid],
                               atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def model():
    return smoke_pair()


@pytest.mark.parametrize("offset,valid", [(6, 4), (13, 2), (16, 5)])
def test_verify_chunk_rows_matches_jax(model, offset, valid):
    """Logits at every chunk position (C = 5, the padded rows aside) and the
    K/V the chunk wrote, at offsets inside and at the edge of a page."""
    cfg, tcfg, params, tparams = model
    serving = dict(num_slots=2, page_size=4, num_pages=17, max_blocks_per_slot=8)
    rng = np.random.default_rng(offset)
    row = np.zeros((8,), np.int32)
    row[:6] = rng.permutation(np.arange(1, 17))[:6]
    hist = rng.integers(0, 256, size=offset).astype(np.int32)
    toks = rng.integers(0, 256, size=(1, 5)).astype(np.int32)
    jc = JM.init_paged_caches(cfg, cfg.attention, JServingCfg(**serving))
    tc = TM.init_paged_caches(tcfg, tcfg.attention, T.ServingCfg(**serving), "cpu")
    for o in range(0, offset, 4):  # the history, one chunk of 4 at a time
        v = min(4, offset - o)
        chunk = np.pad(hist[o:o + v], (0, 4 - v), mode="edge")[None]
        _, jc = JM.prefill_chunk_rows(cfg, cfg.attention, 0, o == 0, params,
                                      jnp.asarray(chunk), jnp.int32(0), jnp.asarray(row),
                                      jnp.int32(o), jnp.int32(v), jc)
        TM.prefill_chunk_rows(tcfg, tcfg.attention, 0, o == 0, tparams, torch.tensor(chunk),
                              0, torch.tensor(row), o, v, tc)
    jl, jc = JM.verify_chunk_rows(cfg, cfg.attention, 0, False, params, jnp.asarray(toks),
                                  jnp.int32(0), jnp.asarray(row), jnp.int32(offset),
                                  jnp.int32(valid), jc)
    tl, _ = TM.verify_chunk_rows(tcfg, tcfg.attention, 0, False, tparams,
                                 torch.tensor(toks), 0, torch.tensor(row), offset, valid, tc)
    assert tl.shape == (1, 5, 256)
    np.testing.assert_allclose(tl[0, :valid].numpy(), np.asarray(jl)[0, :valid],
                               rtol=2e-5, atol=2e-5)
    jk = np.asarray(jc["blocks"][0].k[0])  # the JAX package stacks the blocks
    tk = tc["blocks"][0][0].k.numpy()
    pages = row[:6]
    np.testing.assert_allclose(tk[pages], jk[pages], rtol=2e-5, atol=2e-5)


def _loopy_prompts(n=3, motif=6, reps=3, seed=0):
    """``test_serving_speculative._loopy_prompts``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = rng.integers(1, 256, size=motif).astype(np.int32)
        out.append(np.concatenate([np.tile(m, reps),
                                   rng.integers(1, 256, size=2).astype(np.int32)]))
    return out


BASE = dict(num_slots=3, page_size=4, num_pages=65, max_blocks_per_slot=12,
            prefill_bucket=4, prefill_chunk=4)


def _greedy(prompts, max_new):
    def requests(ns):
        return [ns.Request(rid=i, prompt=p, max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
    return requests


@pytest.mark.parametrize("mode,fused", [("dense", True), ("dense", False),
                                        ("decomposed", True), ("decomposed", False)])
def test_speculative_greedy_serves_as_jax(model, mode, fused):
    (_, jst), (tres, tst) = serve_pair(
        model, _greedy(_loopy_prompts(), 12),
        dict(BASE, spec_len=3, use_paged_kernels=fused),
        gen=dict(max_new_tokens=12), rt=dict(mode=mode))
    assert tst["spec_on"] and jst["spec_steps"] > 0
    # speculation changes when tokens land, never which
    _, (off, _) = serve_pair(model, _greedy(_loopy_prompts(), 12),
                             dict(BASE, use_paged_kernels=fused),
                             gen=dict(max_new_tokens=12), rt=dict(mode=mode))
    for rid in off:
        np.testing.assert_array_equal(tres[rid]["tokens"], off[rid]["tokens"])


def test_speculative_accepts_on_loopy_trace(model):
    (_, jst), _ = serve_pair(model, _greedy(_loopy_prompts(n=1, seed=2), 24),
                             dict(BASE, spec_len=4), gen=dict(max_new_tokens=24))
    assert jst["spec_accepted"] > 0


@pytest.mark.parametrize("wseed", [4, 5])
def test_speculative_seeded_sampling_serves_as_jax(model, wseed):
    """The reference's seeded speculation trace: the port's ``spec_steps``
    equal the reference's, whatever they are (the reference itself may not
    speculate on these seeds)."""
    prompts = _loopy_prompts(seed=wseed)

    def requests(ns):
        return [ns.ServeRequest(prompt=p, rid=i, sampling=ns.SamplingParams(
            temperature=0.9, seed=10 + i, max_tokens=10)) for i, p in enumerate(prompts)]

    for spec in (3, 0):
        serve_pair(model, requests, dict(BASE, spec_len=spec, use_paged_kernels=False),
                   gen=dict(max_new_tokens=10))


def test_speculative_sampled_rows_accept(model):
    """Sampled rows at a low temperature on the loopy trace: drafts are
    verified against the request's own seeded draws and accepted."""
    prompts = _loopy_prompts(n=3, seed=2)

    def requests(ns):
        return [ns.ServeRequest(prompt=p, rid=i, sampling=ns.SamplingParams(
            temperature=0.3, top_k=8, seed=i, max_tokens=20)) for i, p in enumerate(prompts)]

    (_, jst), _ = serve_pair(model, requests, dict(BASE, spec_len=4),
                             gen=dict(max_new_tokens=20))
    assert jst["spec_steps"] > 0


def test_speculative_preemption_replay(model):
    (_, jst), _ = serve_pair(
        model, _greedy(_loopy_prompts(n=4, motif=4, reps=2, seed=7), 12),
        dict(BASE, num_pages=14, max_blocks_per_slot=8, spec_len=3),
        gen=dict(max_new_tokens=12))
    assert jst["preemptions"] > 0 and jst["spec_steps"] > 0


def test_speculative_tiered_dense_arm(model):
    (_, jst), _ = serve_pair(
        model, _greedy(_loopy_prompts(seed=5), 8),
        dict(BASE, spec_len=3, escalated_pages=33, enable_escalation=True,
             low_watermark=0.0, critical_watermark=0.0),
        gen=dict(max_new_tokens=8))
    assert jst["spec_steps"] > 0


def test_speculative_with_prefix_sharing(model):
    rng = np.random.default_rng(4)
    sys_p = np.tile(rng.integers(1, 256, size=4).astype(np.int32), 4)
    prompts = [np.concatenate([sys_p, rng.integers(1, 256, size=t).astype(np.int32)])
               for t in (5, 9, 3, 14, 7)]
    (_, jst), _ = serve_pair(model, _greedy(prompts, 12),
                             dict(BASE, spec_len=3, share_prefix=True, defrag_every=2),
                             gen=dict(max_new_tokens=12))
    assert jst["prefix_hits"] > 0 and jst["spec_steps"] > 0


def test_spec_opt_out_and_budget_gate(model):
    prompts = _loopy_prompts(n=2, seed=9)

    def requests(ns):
        return [ns.ServeRequest(prompt=prompts[0], rid=0,
                                sampling=ns.SamplingParams(max_tokens=12, speculate=False)),
                ns.ServeRequest(prompt=prompts[1], rid=1,
                                sampling=ns.SamplingParams(max_tokens=1))]

    (_, jst), _ = serve_pair(model, requests, dict(BASE, num_slots=2, spec_len=3),
                             gen=dict(max_new_tokens=12))
    assert jst["spec_steps"] == 0


def test_spec_gated_off_for_side_state_tiers(model):
    _, tcfg, _, tparams = model
    eng = T.ContinuousServeEngine(tcfg, tparams, rt=T.AttentionRuntime(mode="cpq"),
                                  serving=T.ServingCfg(**BASE, spec_len=3,
                                                       share_prefix=True),
                                  device="cpu")
    assert not eng.spec_on and not eng.share_prefix
    eng = T.ContinuousServeEngine(tcfg, tparams,
                                  serving=T.ServingCfg(**dict(BASE, prefill_chunk=0),
                                                       share_prefix=True),
                                  device="cpu")
    assert not eng.spec_on and not eng.share_prefix
