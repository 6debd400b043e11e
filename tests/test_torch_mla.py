"""The port's multi-head latent attention (``models/mla.py``) against the JAX
package's: the layer functions over a contiguous latent (X and CPQ codes)
and over paged latent arenas (X pages and CPQ code pages), with the paged
kernels (the port's plain versions, the reference's Pallas kernels in
interpret mode) and with the gather path; then deepseek-v2-lite (MLA with
MoE MLPs) and a pure-MLA stack served by the port against the reference's
paged engine. Float32. Stated tolerances: 1e-4 for a layer's output and
for logits."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.common.param import init_tree
from repro.configs import ARCHS, smoke_config
from repro.configs.base import MLACfg as JMLACfg
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import mla as jmla
from repro.serving import paged_cache as jpgc
from repro.serving.trace import make_workload
import repro_torch as T
from repro_torch.configs import MLACfg
from repro_torch.models import mla as tmla
from repro_torch.params import from_jax
from repro_torch.serving import paged_cache as tpgc
from torch_paged_cases import serve_pair, smoke_pair

TOL = 1e-4


def _close(t_out, j_out, tol=TOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def layer():
    """deepseek-v2-lite's smoke config in both packages at f32 and one MLA
    layer's weights, carried across."""
    jcfg = dataclasses.replace(smoke_config(ARCHS["deepseek-v2-lite-16b"]), dtype="float32")
    tcfg = dataclasses.replace(T.smoke_config(T.ARCHS["deepseek-v2-lite-16b"]),
                               dtype="float32")
    jp = init_tree(jmla.mla_defs(jcfg), jax.random.PRNGKey(1))
    return jcfg, tcfg, jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _runtimes(mode, fused):
    return (jconfigs.AttentionRuntime(mode=mode, paged_kernels=fused),
            T.AttentionRuntime(mode=mode, paged_kernels=fused))


@pytest.mark.parametrize("mode,fused", [("decomposed", True), ("decomposed", False),
                                        ("cpq", True), ("cpq", False)])
def test_contiguous_prefill_and_decode_match_jax(layer, mode, fused):
    """``mla_prefill`` of a batch of prompts into a contiguous latent (X, or
    CPQ codes in mode cpq), then three ``mla_decode`` steps (B9's plain
    version over X with the kernels on)."""
    jcfg, tcfg, jp, tp = layer
    jrt, rt = _runtimes(mode, fused)
    rng = np.random.default_rng(2)
    B, S, N = 2, 9, 14
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    jy, jc = jmla.mla_prefill(jcfg, jrt, jp, jnp.asarray(x), jnp.arange(S, dtype=jnp.int32),
                              jmla.init_mla_cache(jcfg, jrt, B, N))
    ty, tc = tmla.mla_prefill(tcfg, rt, tp, torch.from_numpy(x), torch.arange(S),
                              tmla.init_mla_cache(tcfg, rt, B, N, "cpu"))
    _close(ty, jy)
    assert type(tc).__name__ == ("CPQXCache" if mode == "cpq" else "XCache")
    for t in range(3):
        x_t = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jmla.mla_decode(jcfg, jrt, jp, jnp.asarray(x_t), jnp.asarray(S + t, jnp.int32),
                                 jc)
        ty, tc = tmla.mla_decode(tcfg, rt, tp, torch.from_numpy(x_t), S + t, tc)
        _close(ty, jy)
        assert int(tc.length) == int(jc.length) == S + t + 1
    _close(tc.k_rope, jc.k_rope, 1e-5)
    if mode == "cpq":
        np.testing.assert_array_equal(tc.x.num_levels.numpy(), np.asarray(jc.x.num_levels))
    else:
        _close(tc.x, jc.x, 1e-5)


SERVING = dict(num_slots=3, page_size=4, num_pages=13, max_blocks_per_slot=4)
BLOCKS = np.array([[7, 3, 0, 0], [5, 2, 9, 11], [0, 0, 0, 0]], np.int32)  # slot 2 unmapped


@pytest.mark.parametrize("mode,fused", [("decomposed", True), ("decomposed", False),
                                        ("cpq", True), ("cpq", False)])
def test_paged_chunks_and_decode_rows_match_jax(layer, mode, fused):
    """``mla_prefill_chunk`` (B4's plain version over X pages with the
    kernels on; a CPQ latent compresses each chunk, level 0 on the first)
    into two slots over permuted pages, a partial last chunk included, then
    three ``mla_decode_rows`` steps with an inactive, unmapped third row."""
    jcfg, tcfg, jp, tp = layer
    jrt, rt = _runtimes(mode, fused)
    jc = jmla.init_paged_mla_cache(jcfg, jrt, jconfigs.ServingCfg(**SERVING))
    tc = tmla.init_paged_mla_cache(tcfg, rt, T.ServingCfg(**SERVING), "cpu")
    rng = np.random.default_rng(3)
    C = 8
    lengths = [0, 0, 0]
    for slot, offset, valid in ((1, 0, 8), (0, 0, 5), (1, 8, 3)):
        x = rng.normal(size=(1, C, jcfg.d_model)).astype(np.float32)
        pos = offset + np.arange(C, dtype=np.int32)
        row = BLOCKS[slot]
        jy, jc = jmla.mla_prefill_chunk(jcfg, jrt, 0, offset == 0, jp, jnp.asarray(x),
                                        jnp.asarray(pos), jnp.int32(slot), jnp.asarray(row),
                                        jnp.int32(offset), jnp.int32(valid), jc)
        ty, tc = tmla.mla_prefill_chunk(tcfg, rt, 0, offset == 0, tp, torch.from_numpy(x),
                                        torch.from_numpy(pos), slot, torch.from_numpy(row),
                                        offset, valid, tc)
        _close(ty[:, :valid], np.asarray(jy)[:, :valid])
        lengths[slot] = offset + valid
    active = np.array([True, True, False])
    for _ in range(3):
        x_t = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
        ln = np.array(lengths, np.int32)
        jrows = jpgc.RowState(jnp.asarray(ln), jnp.asarray(BLOCKS), jnp.asarray(active),
                              jnp.zeros(3, jnp.int32))
        trows = tpgc.RowState(torch.from_numpy(ln), torch.from_numpy(BLOCKS),
                              torch.from_numpy(active), torch.zeros(3, dtype=torch.int32))
        jy, jc = jmla.mla_decode_rows(jcfg, jrt, jp, jnp.asarray(x_t), jrows, jc)
        ty, tc = tmla.mla_decode_rows(tcfg, rt, tp, torch.from_numpy(x_t), trows, tc)
        _close(ty[:2], np.asarray(jy)[:2])
        lengths = [n + int(a) for n, a in zip(lengths, active)]
    pages = BLOCKS[:2][BLOCKS[:2] > 0]
    if mode == "cpq":
        assert isinstance(tc, tpgc.PagedCPQXCache)
        np.testing.assert_array_equal(tc.x.num_levels.numpy(), np.asarray(jc.x.num_levels))
    else:
        assert isinstance(tc, tpgc.PagedXCache)
        _close(tc.x[pages], np.asarray(jc.x)[pages], 1e-5)
    _close(tc.k_rope[pages], np.asarray(jc.k_rope)[pages], 1e-5)


# ------------------------------------------------------------------ engines


@pytest.fixture(scope="module")
def lite():
    return smoke_pair("deepseek-v2-lite-16b", num_blocks=2)


def _work(vocab, n=6, cap=None):
    return [(w.rid, w.prompt, min(w.target, cap or w.target), w.arrival)
            for w in make_workload(0, n, vocab, 0.5)]


def _requests(work):
    return lambda ns: [ns.Request(rid=r, prompt=p, max_new_tokens=n, arrival=a)
                       for r, p, n, a in work]


@pytest.mark.parametrize("mode,fused", [("decomposed", True), ("decomposed", False),
                                        ("cpq", True)])
def test_deepseek_v2_lite_serves_as_jax(lite, mode, fused):
    """deepseek-v2-lite's smoke stack (an MLA + dense layer, two MLA + MoE
    layers): greedy streams, tick stamps, ``stats()`` and events identical
    to the reference's paged engine. It asks for chunks, but MoE routing
    depends on the token group, so both engines admit one-shot. CPQ
    generations are capped at 12 tokens, as in ``test_torch_engine_cpq.py``."""
    cap = 12 if mode == "cpq" else None
    work = _work(lite[0].vocab_size, cap=cap)
    (_, jst), (_, tst) = serve_pair(
        lite, _requests(work),
        dict(num_slots=3, page_size=4, num_pages=65, max_blocks_per_slot=32,
             prefill_chunk=8, prefill_bucket=8, use_paged_kernels=fused),
        gen=dict(max_new_tokens=cap or 30), rt=dict(mode=mode))
    assert not jst["chunked_prefill"] and not tst["chunked_prefill"]
    assert tst["prefill_chunks"] == 0 and tst["admitted"] == len(work)


def test_deepseek_v2_lite_static_serves_as_jax(lite):
    from repro.serving import engine as jeng

    cfg, tcfg, params, tparams = lite
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(3, 11)).astype(np.int32)
    for mode in ("decomposed", "cpq"):
        out_j, _ = jeng.ServeEngine(cfg, params, rt=jconfigs.AttentionRuntime(mode=mode)
                                    ).generate({"tokens": jnp.asarray(toks)},
                                               jeng.GenerationConfig(max_new_tokens=8))
        out_t, _ = T.ServeEngine(tcfg, tparams, rt=T.AttentionRuntime(mode=mode),
                                 device="cpu").generate(
            {"tokens": toks}, T.GenerationConfig(max_new_tokens=8))
        np.testing.assert_array_equal(out_t, np.asarray(out_j), err_msg=mode)


def test_paged_matches_contiguous_at_a_roomy_capacity():
    """The port's one-shot paged engine against its own static engine on
    deepseek-v2-lite's smoke stack. Only at ``capacity_factor=16``: MoE
    routing depends on the token group (the prompt in a static B=1 prefill,
    the bucket-padded prompt on admission, every slot row in a decode tick),
    so at the published 1.25 the two paths drop different choices and their
    streams differ, in the reference as well
    (``test_serving_paged.py::test_paged_modes_match_contiguous``
    [deepseek-v2-lite-16b-decomposed] fails there); with no drops, routing
    is per token and the paths agree."""
    cfg = dataclasses.replace(T.smoke_config(T.ARCHS["deepseek-v2-lite-16b"]), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    params = T.init_params(cfg, 0, device="cpu")
    prompts = [np.random.default_rng(1).integers(0, cfg.vocab_size, size=s).astype(np.int32)
               for s in (5, 12, 3, 21)]
    gen = T.GenerationConfig(max_new_tokens=5)
    eng = T.ContinuousServeEngine(cfg, params, serving=T.ServingCfg(
        num_slots=4, page_size=4, num_pages=65, max_blocks_per_slot=8, prefill_bucket=4,
        prefill_chunk=0, use_paged_kernels=False), device="cpu")
    res, _ = eng.serve([T.Request(rid=i, prompt=p, max_new_tokens=5)
                        for i, p in enumerate(prompts)], gen)
    static = T.ServeEngine(cfg, params, rt=T.AttentionRuntime(paged_kernels=False),
                           device="cpu")
    for i, p in enumerate(prompts):
        ref, _ = static.generate({"tokens": p[None]}, gen)
        np.testing.assert_array_equal(res[i]["tokens"], ref[0])


def test_escalation_refuses_mla(lite):
    _, tcfg, _, tparams = lite
    with pytest.raises(T.SchedulerConfigError, match="MLA"):
        T.ContinuousServeEngine(tcfg, tparams, serving=T.ServingCfg(
            num_slots=2, page_size=4, num_pages=17, max_blocks_per_slot=8,
            escalated_pages=17, enable_escalation=True), device="cpu")


# the reference's pure-MLA stack (``tests/test_serving_chunked.py:33``): MLA
# with dense MLPs, so chunked admission, prefix sharing and speculation
# serve over the latent pages
_MLA_DENSE = dict(name="mla-dense-test", family="dense", d_model=32, num_heads=4,
                  num_kv_heads=4, head_dim=8, d_ff=64, vocab_size=256,
                  block_pattern=(("mla", "dense"),), num_blocks=2, dtype="float32")


@pytest.fixture(scope="module")
def mla_dense():
    cfg = JModelConfig(**_MLA_DENSE, mla=JMLACfg(kv_lora_rank=16, qk_nope_head_dim=8,
                                                 qk_rope_head_dim=4, v_head_dim=8))
    tcfg = T.ModelConfig(**_MLA_DENSE, mla=MLACfg(kv_lora_rank=16, qk_nope_head_dim=8,
                                                  qk_rope_head_dim=4, v_head_dim=8))
    from repro.models import model as JM

    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _prompts(sizes, seed=0, prefix=0):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, 256, size=prefix).astype(np.int32)
    return [np.concatenate([sys_p, rng.integers(1, 256, size=s).astype(np.int32)])
            for s in sizes]


def _greedy(prompts, max_new):
    return lambda ns: [ns.Request(rid=i, prompt=p, max_new_tokens=max_new)
                       for i, p in enumerate(prompts)]


BASE = dict(num_slots=3, page_size=4, num_pages=65, max_blocks_per_slot=12,
            prefill_bucket=4, prefill_chunk=4)


@pytest.mark.parametrize("mode,fused", [("dense", True), ("dense", False), ("cpq", False)])
def test_mla_dense_chunked_serves_as_jax(mla_dense, mode, fused):
    """Chunked admission over the latent pages (B4's plain version with the
    kernels on; the CPQ latent through ``decomposed_cpq_chunk_prefill``)."""
    (_, jst), (_, tst) = serve_pair(
        mla_dense, _greedy(_prompts((5, 12, 3, 21)), 8),
        dict(BASE, use_paged_kernels=fused), gen=dict(max_new_tokens=8), rt=dict(mode=mode))
    assert tst["chunked_prefill"] and jst["prefill_chunks"] > 0


def test_mla_dense_sharing_serves_as_jax(mla_dense):
    (_, jst), (_, tst) = serve_pair(
        mla_dense, _greedy(_prompts((5, 9, 3, 14, 7), prefix=24), 6),
        dict(BASE, share_prefix=True), gen=dict(max_new_tokens=6))
    assert tst["prefix_sharing"] and jst["prefix_hits"] > 0


def test_mla_dense_speculation_serves_as_jax(mla_dense):
    rng = np.random.default_rng(0)
    prompts = []
    for _ in range(3):  # loopy prompts: a motif tiled three times
        m = rng.integers(1, 256, size=6).astype(np.int32)
        prompts.append(np.concatenate([np.tile(m, 3),
                                       rng.integers(1, 256, size=2).astype(np.int32)]))
    (_, jst), (_, tst) = serve_pair(mla_dense, _greedy(prompts, 12),
                                    dict(BASE, spec_len=3), gen=dict(max_new_tokens=12))
    assert tst["spec_on"] and jst["spec_steps"] > 0
