"""The port's layers and paged model forward passes against the JAX
package's, on the same numpy inputs and the same weights (carried across by
``from_jax``). Float32 throughout. Stated tolerances: 1e-5 for single ops,
1e-4 for logits (a whole forward pass of matmuls summed in another order)."""
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS, AttentionRuntime, ServingCfg, smoke_config
from repro.configs.base import CPQCfg as JCPQCfg
from repro.configs.base import RetrievalCfg as JRetrievalCfg
from repro.core import attention as j_attn
from repro.models import layers as jl
from repro.models import model as JM
from repro.serving import paged_cache as jpgc
import repro_torch.configs as tc
from repro_torch.core import attention as t_attn
from repro_torch.models import layers as tl
from repro_torch.models import model as TM
from repro_torch.params import from_jax
from repro_torch.serving import paged_cache as tpgc

OP_TOL = 1e-5
LOGIT_TOL = 1e-4


def _pair(jcfg, **kw):
    """The same config in both packages."""
    jcfg = dataclasses.replace(jcfg, dtype="float32", **kw)
    tcfg = dataclasses.replace(tc.smoke_config(tc.ARCHS[jcfg.name.removesuffix("-smoke")])
                               if jcfg.name.endswith("-smoke") else tc.ARCHS[jcfg.name],
                               dtype="float32", **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _close(t_out, j_out, tol=OP_TOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=tol, rtol=tol)


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm_and_rms_norm_vec(norm):
    rng = np.random.default_rng(0)
    jcfg, tcfg = _pair(smoke_config(ARCHS["qwen1.5-0.5b"]), norm=norm)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    p = {"scale": rng.normal(size=(64,)).astype(np.float32),
         "bias": rng.normal(size=(64,)).astype(np.float32)}
    _close(tl.apply_norm(tcfg, {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x)),
           jl.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    _close(tl.rms_norm_vec(torch.tensor(x), torch.tensor(p["scale"])),
           jl.rms_norm_vec(jnp.asarray(x), jnp.asarray(p["scale"])))


def test_rope():
    rng = np.random.default_rng(1)
    pos = np.array([0, 3, 17, 250], np.int32)
    tc_, ts_ = tl.rope_tables(torch.tensor(pos), 16, 10000.0)
    jc_, js_ = jl.rope_tables(jnp.asarray(pos), 16, 10000.0)
    _close(tc_, jc_)
    _close(ts_, js_)
    x = rng.normal(size=(2, 4, 3, 16)).astype(np.float32)
    _close(tl.apply_rope(torch.tensor(x), tc_, ts_), jl.apply_rope(jnp.asarray(x), jc_, js_))
    xr = rng.normal(size=(4, 1, 3, 16)).astype(np.float32)
    _close(tl.apply_rope_rows(torch.tensor(xr), tc_, ts_),
           jl.apply_rope_rows(jnp.asarray(xr), jc_, js_))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_apply_mlp(act):
    rng = np.random.default_rng(2)
    jcfg, tcfg = _pair(smoke_config(ARCHS["qwen1.5-0.5b"]), mlp_act=act)
    d, ff = 64, 96
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32) for k, s in {
        "w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d), "w_in": (d, ff),
        "b_in": (ff,), "w_out": (ff, d), "b_out": (d,)}.items()}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    _close(tl.apply_mlp(tcfg, {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x)),
           jl.apply_mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("arch,kw", [
    ("qwen1.5-0.5b", {}),                         # tied head
    ("gemma-2b", {"logit_softcap": 30.0}),        # embed scale + softcap
    ("opt-6.7b", {}),                             # absolute positions, own head
])
def test_embed_and_lm_logits(arch, kw):
    rng = np.random.default_rng(3)
    jcfg, tcfg = _pair(smoke_config(ARCHS[arch]), **kw)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(3)))
    tparams = from_jax(params, device="cpu")
    toks = rng.integers(0, 256, size=(2, 5)).astype(np.int32)
    pos = rng.integers(0, 100, size=(2, 5)).astype(np.int32)
    xt = tl.embed_inputs(tcfg, tparams["embed"], torch.tensor(toks), torch.tensor(pos))
    xj = jl.embed_inputs(jcfg, jax.tree.map(jnp.asarray, params["embed"]),
                         {"tokens": jnp.asarray(toks)}, jnp.asarray(pos))
    _close(xt, xj)
    _close(tl.lm_logits(tcfg, tparams, xt), jl.lm_logits(jcfg, params, xj), LOGIT_TOL)


@pytest.mark.parametrize("causal,q_offset,kv_length,g", [
    (True, 0, None, 1), (True, 5, 9, 2), (False, 0, np.array([3, 0, 12]), 4),
])
def test_dense_attention(causal, q_offset, kv_length, g):
    rng = np.random.default_rng(4)
    B, T, S, KV, Dh = 3, 4, 12, 2, 8
    q = rng.normal(size=(B, T, KV * g, Dh)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, Dh)).astype(np.float32)
    out_t = t_attn.dense_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), 0.3,
                                   causal=causal, q_offset=q_offset,
                                   kv_length=None if kv_length is None
                                   else torch.tensor(kv_length))
    out_j = j_attn.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3,
                                   causal=causal, q_offset=q_offset,
                                   kv_length=None if kv_length is None
                                   else jnp.asarray(kv_length))
    _close(out_t, out_j)


# ------------------------------------------------- paged forward passes


@pytest.fixture(scope="module")
def qwen():
    """qwen1.5-0.5b smoke, two blocks, float32, with random (nonzero) QKV
    biases and norm scales so those paths carry signal."""
    jcfg, tcfg = _pair(smoke_config(ARCHS["qwen1.5-0.5b"]), num_blocks=2)
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(5)))

    def jitter(path, a):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("'bq'", "'bk'", "'bv'", "'scale'")):
            return (a + 0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(jitter, params)
    return jcfg, tcfg, params, from_jax(params, device="cpu")


@pytest.mark.parametrize("fused", [True, False])
def test_prefill_and_decode_logits_match_jax(qwen, fused):
    """Two slots stream their prompts chunk by chunk through permuted pages,
    then decode twice (the second time with one row inactive). Logits at
    every step, and the arena pages, match the JAX package."""
    jcfg, tcfg, params, tparams = qwen
    serving = ServingCfg(num_slots=2, page_size=4, num_pages=17,
                         max_blocks_per_slot=8, prefill_chunk=8)
    jrt = AttentionRuntime(paged_kernels=fused)
    trt = tc.AttentionRuntime(paged_kernels=fused)
    jcaches = JM.init_paged_caches(jcfg, jrt, serving)
    tcaches = TM.init_paged_caches(tcfg, trt, serving, "cpu")
    chunk_fn = {first: jax.jit(partial(JM.prefill_chunk_rows, jcfg, jrt, 0, first))
                for first in (True, False)}
    decode_fn = jax.jit(partial(JM.decode_step_rows, jcfg, jrt))

    rng = np.random.default_rng(6)
    bt = np.zeros((2, 8), np.int32)
    bt[0, :5] = [9, 3, 14, 1, 7]
    bt[1, :3] = [12, 5, 10]
    prompts = [rng.integers(0, 256, size=13).astype(np.int32),
               rng.integers(0, 256, size=6).astype(np.int32)]
    for slot, prompt in enumerate(prompts):
        for off in range(0, len(prompt), 8):
            valid = min(8, len(prompt) - off)
            chunk = np.concatenate([prompt[off:off + valid],
                                    np.full(8 - valid, prompt[off + valid - 1], np.int32)])
            lj, jcaches = chunk_fn[off == 0](
                params, jnp.asarray(chunk[None]), jnp.asarray(slot, jnp.int32),
                jnp.asarray(bt[slot]), jnp.asarray(off, jnp.int32),
                jnp.asarray(valid, jnp.int32), jcaches)
            lt, _ = TM.prefill_chunk_rows(tcfg, trt, 0, off == 0, tparams,
                                          torch.tensor(chunk[None]), slot,
                                          torch.tensor(bt[slot]), off, valid, tcaches)
            _close(lt, lj, LOGIT_TOL)

    lengths = np.array([13, 6], np.int32)
    for active in (np.array([True, True]), np.array([False, True])):
        toks = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
        rows_j = jpgc.RowState(jnp.asarray(lengths), jnp.asarray(bt), jnp.asarray(active),
                               jnp.zeros(2, jnp.int32))
        rows_t = tpgc.RowState(torch.tensor(lengths), torch.tensor(bt), torch.tensor(active),
                               torch.zeros(2, dtype=torch.int32))
        lj, jcaches = decode_fn(params, jnp.asarray(toks), rows_j, jcaches)
        lt, _ = TM.decode_step_rows(tcfg, trt, tparams, torch.tensor(toks), rows_t, tcaches)
        _close(lt[active], np.asarray(lj)[active], LOGIT_TOL)
        lengths = lengths + active

    for i in range(2):  # every mapped page holds the same K/V
        mapped = bt[bt > 0]
        _close(tcaches["blocks"][0][i].k[mapped], np.asarray(jcaches["blocks"][0].k[i])[mapped])
        _close(tcaches["blocks"][0][i].v[mapped], np.asarray(jcaches["blocks"][0].v[i])[mapped])


def _stream_prompts(jcfg, tcfg, jrt, trt, params, tparams, jcaches, tcaches, bt, prompts,
                    tier=0, C=8):
    """Stream each slot's prompt chunk by chunk through both packages; the
    chunk logits agree at every step. Returns the JAX caches."""
    chunk_fn = {first: jax.jit(partial(JM.prefill_chunk_rows, jcfg, jrt, tier, first))
                for first in (True, False)}
    for slot, prompt in enumerate(prompts):
        for off in range(0, len(prompt), C):
            valid = min(C, len(prompt) - off)
            chunk = np.concatenate([prompt[off:off + valid],
                                    np.full(C - valid, prompt[off + valid - 1], np.int32)])
            lj, jcaches = chunk_fn[off == 0](
                params, jnp.asarray(chunk[None]), jnp.asarray(slot, jnp.int32),
                jnp.asarray(bt[slot]), jnp.asarray(off, jnp.int32),
                jnp.asarray(valid, jnp.int32), jcaches)
            lt, _ = TM.prefill_chunk_rows(tcfg, trt, tier, off == 0, tparams,
                                          torch.tensor(chunk[None]), slot,
                                          torch.tensor(bt[slot]), off, valid, tcaches)
            _close(lt, lj, LOGIT_TOL)
    return jcaches


def _cpq_arena_equal(t_arena, j_arena, pages):
    """Mapped code/level pages and every slot's side state are identical."""
    for name in ("codes", "level"):
        np.testing.assert_array_equal(getattr(t_arena, name)[pages].numpy(),
                                      np.asarray(getattr(j_arena, name))[pages], err_msg=name)
    for name in ("scale", "zero", "num_levels", "prune_thr"):
        np.testing.assert_array_equal(getattr(t_arena, name).numpy(),
                                      np.asarray(getattr(j_arena, name)), err_msg=name)


def _cpq_arena_close(t_arena, j_arena, pages):
    """The same compression of K/V that the two packages computed in another
    summation order: side state to 1e-4, codes equal but for rare rounding
    ties (< 0.5 %)."""
    for name in ("scale", "zero", "prune_thr"):
        _close(getattr(t_arena, name), getattr(j_arena, name), LOGIT_TOL)
    np.testing.assert_array_equal(t_arena.num_levels.numpy(), np.asarray(j_arena.num_levels))
    differ = t_arena.codes[pages].numpy() != np.asarray(j_arena.codes)[pages]
    assert differ.mean() < 5e-3, differ.mean()


@pytest.mark.parametrize("fused", [True, False])
def test_cpq_prefill_and_decode_logits_match_jax(qwen, fused):
    """mode="cpq": two slots stream their prompts (the second chunk of slot
    0 HQE-extends what the first fitted), then decode three times, once
    with a row inactive. Logits at every step and the code arenas match."""
    jcfg, tcfg, params, tparams = qwen
    serving = ServingCfg(num_slots=2, page_size=4, num_pages=17,
                         max_blocks_per_slot=8, prefill_chunk=8)
    jrt = AttentionRuntime(mode="cpq", paged_kernels=fused)
    trt = tc.AttentionRuntime(mode="cpq", paged_kernels=fused)
    jcaches = JM.init_paged_caches(jcfg, jrt, serving)
    tcaches = TM.init_paged_caches(tcfg, trt, serving, "cpu")
    decode_fn = jax.jit(partial(JM.decode_step_rows, jcfg, jrt))

    rng = np.random.default_rng(8)
    bt = np.zeros((2, 8), np.int32)
    bt[0, :5] = [9, 3, 14, 1, 7]
    bt[1, :3] = [12, 5, 10]
    prompts = [rng.integers(0, 256, size=13).astype(np.int32),
               rng.integers(0, 256, size=6).astype(np.int32)]
    jcaches = _stream_prompts(jcfg, tcfg, jrt, trt, params, tparams, jcaches, tcaches,
                              bt, prompts)
    lengths = np.array([13, 6], np.int32)
    for active in (np.array([True, True]), np.array([False, True]),
                   np.array([True, True])):
        toks = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
        rows_j = jpgc.RowState(jnp.asarray(lengths), jnp.asarray(bt), jnp.asarray(active),
                               jnp.zeros(2, jnp.int32))
        rows_t = tpgc.RowState(torch.tensor(lengths), torch.tensor(bt), torch.tensor(active),
                               torch.zeros(2, dtype=torch.int32))
        lj, jcaches = decode_fn(params, jnp.asarray(toks), rows_j, jcaches)
        lt, _ = TM.decode_step_rows(tcfg, trt, tparams, torch.tensor(toks), rows_t, tcaches)
        _close(lt[active], np.asarray(lj)[active], LOGIT_TOL)
        lengths = lengths + active
    mapped = bt[bt > 0]
    for i in range(2):
        for name in ("k", "v"):
            _cpq_arena_close(getattr(tcaches["blocks"][0][i], name),
                             jax.tree.map(lambda a: a[i], getattr(jcaches["blocks"][0], name)),
                             mapped)


@pytest.mark.parametrize("fused", [True, False])
def test_escalate_slot_and_tiered_decode_match_jax(qwen, fused):
    """Tiered arenas: both slots prefill dense, slot 0 escalates into the
    CPQ arena, then a tiered decode runs the dense row and the escalated row
    together. Escalation starts from the JAX dense arena's K/V (copied over,
    so that the summation order of the two forward passes plays no part)
    and leaves CPQ pages and tables identical to the JAX arena's."""
    jcfg, tcfg, params, tparams = qwen
    serving = ServingCfg(num_slots=2, page_size=4, num_pages=17, escalated_pages=13,
                         max_blocks_per_slot=8, prefill_chunk=8)
    jrt = AttentionRuntime(paged_kernels=fused, cpq=JCPQCfg())
    trt = tc.AttentionRuntime(paged_kernels=fused, cpq=tc.CPQCfg())
    jcaches = JM.init_paged_caches(jcfg, jrt, serving, True)
    tcaches = TM.init_paged_caches(tcfg, trt, serving, "cpu", tiered=True)

    rng = np.random.default_rng(9)
    bt = np.zeros((2, 8), np.int32)
    bt[0, :4] = [9, 3, 14, 1]
    bt[1, :2] = [12, 5]
    prompts = [rng.integers(0, 256, size=13).astype(np.int32),
               rng.integers(0, 256, size=6).astype(np.int32)]
    jcaches = _stream_prompts(jcfg, tcfg, jrt, trt, params, tparams, jcaches, tcaches,
                              bt, prompts)
    for i in range(2):
        for name in ("k", "v"):
            getattr(tcaches["blocks"][0][i].dense, name).copy_(
                torch.tensor(np.asarray(getattr(jcaches["blocks"][0].dense, name)[i])))
    alt = np.zeros((2, 8), np.int32)
    alt[0, :4] = [6, 2, 11, 4]
    jcaches = jax.jit(partial(JM.escalate_slot, jcfg, jrt))(
        jcaches, jnp.asarray(bt[0]), jnp.asarray(alt[0]), jnp.asarray(0, jnp.int32),
        jnp.asarray(13, jnp.int32))
    TM.escalate_slot(tcfg, trt, tcaches, torch.tensor(bt[0]), torch.tensor(alt[0]), 0, 13)
    for i in range(2):
        for name in ("k", "v"):
            _cpq_arena_equal(getattr(tcaches["blocks"][0][i].cpq, name),
                             jax.tree.map(lambda a: a[i],
                                          getattr(jcaches["blocks"][0].cpq, name)),
                             alt[0, :4])

    bt[0] = 0                                  # the dense pages went back
    tier = np.array([1, 0], np.int32)
    lengths = np.array([13, 6], np.int32)
    active = np.array([True, True])
    for _ in range(2):
        toks = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
        rows_j = jpgc.RowState(jnp.asarray(lengths), jnp.asarray(bt), jnp.asarray(active),
                               jnp.asarray(tier), jnp.asarray(alt))
        rows_t = tpgc.RowState(torch.tensor(lengths), torch.tensor(bt), torch.tensor(active),
                               torch.tensor(tier), torch.tensor(alt))
        lj, jcaches = jax.jit(partial(JM.decode_step_rows, jcfg, jrt))(
            params, jnp.asarray(toks), rows_j, jcaches)
        lt, _ = TM.decode_step_rows(tcfg, trt, tparams, torch.tensor(toks), rows_t, tcaches)
        _close(lt, lj, LOGIT_TOL)
        lengths = lengths + 1


@pytest.mark.parametrize("fused", [True, False])
def test_decomposed_prefill_and_decode_logits_match_jax(qwen, fused):
    """mode="decomposed" (T1): two slots stream their prompts through
    permuted X pages, then decode three times, once with a row inactive.
    Logits at every step and the X and roped-key pages match. The fixture's
    nonzero b_v is what T1 leaves out of (S X) W_V; a port that added it
    would miss here."""
    jcfg, tcfg, params, tparams = qwen
    serving = ServingCfg(num_slots=2, page_size=4, num_pages=17,
                         max_blocks_per_slot=8, prefill_chunk=8)
    jrt = AttentionRuntime(mode="decomposed", paged_kernels=fused)
    trt = tc.AttentionRuntime(mode="decomposed", paged_kernels=fused)
    jcaches = JM.init_paged_caches(jcfg, jrt, serving)
    tcaches = TM.init_paged_caches(tcfg, trt, serving, "cpu")
    decode_fn = jax.jit(partial(JM.decode_step_rows, jcfg, jrt))

    rng = np.random.default_rng(10)
    bt = np.zeros((2, 8), np.int32)
    bt[0, :5] = [9, 3, 14, 1, 7]
    bt[1, :3] = [12, 5, 10]
    prompts = [rng.integers(0, 256, size=13).astype(np.int32),
               rng.integers(0, 256, size=6).astype(np.int32)]
    jcaches = _stream_prompts(jcfg, tcfg, jrt, trt, params, tparams, jcaches, tcaches,
                              bt, prompts)
    lengths = np.array([13, 6], np.int32)
    for active in (np.array([True, True]), np.array([False, True]),
                   np.array([True, True])):
        toks = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
        rows_j = jpgc.RowState(jnp.asarray(lengths), jnp.asarray(bt), jnp.asarray(active),
                               jnp.zeros(2, jnp.int32))
        rows_t = tpgc.RowState(torch.tensor(lengths), torch.tensor(bt), torch.tensor(active),
                               torch.zeros(2, dtype=torch.int32))
        lj, jcaches = decode_fn(params, jnp.asarray(toks), rows_j, jcaches)
        lt, _ = TM.decode_step_rows(tcfg, trt, tparams, torch.tensor(toks), rows_t, tcaches)
        _close(lt[active], np.asarray(lj)[active], LOGIT_TOL)
        lengths = lengths + active
    mapped = bt[bt > 0]
    for i in range(2):
        for name in ("x", "k_rope"):
            _close(getattr(tcaches["blocks"][0][i], name)[mapped],
                   np.asarray(getattr(jcaches["blocks"][0], name)[i])[mapped])


@pytest.mark.parametrize("fused", [True, False])
def test_retrieval_prefill_and_decode_logits_match_jax(qwen, fused):
    """mode="retrieval" (T3) with top_k=6 and recent_window=2, so rows past 6
    keys really select: two slots stream their prompts (slot 0's first
    chunk fits the proxy calibration, its second chunk encodes with it),
    then decode three times, once with a row inactive. Logits at every step,
    the K/V pages and the slot calibration match; the proxy codes are equal
    but for rare rounding ties of keys that differ in the last ulp."""
    jcfg, tcfg, params, tparams = qwen
    serving = ServingCfg(num_slots=2, page_size=4, num_pages=17,
                         max_blocks_per_slot=8, prefill_chunk=8)
    jrt = AttentionRuntime(mode="retrieval", paged_kernels=fused,
                           retrieval=JRetrievalCfg(top_k=6, recent_window=2))
    trt = tc.AttentionRuntime(mode="retrieval", paged_kernels=fused,
                              retrieval=tc.RetrievalCfg(top_k=6, recent_window=2))
    jcaches = JM.init_paged_caches(jcfg, jrt, serving)
    tcaches = TM.init_paged_caches(tcfg, trt, serving, "cpu")
    decode_fn = jax.jit(partial(JM.decode_step_rows, jcfg, jrt))

    rng = np.random.default_rng(11)
    bt = np.zeros((2, 8), np.int32)
    bt[0, :5] = [9, 3, 14, 1, 7]
    bt[1, :3] = [12, 5, 10]
    prompts = [rng.integers(0, 256, size=13).astype(np.int32),
               rng.integers(0, 256, size=6).astype(np.int32)]
    jcaches = _stream_prompts(jcfg, tcfg, jrt, trt, params, tparams, jcaches, tcaches,
                              bt, prompts)
    lengths = np.array([13, 6], np.int32)
    for active in (np.array([True, True]), np.array([False, True]),
                   np.array([True, True])):
        toks = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
        rows_j = jpgc.RowState(jnp.asarray(lengths), jnp.asarray(bt), jnp.asarray(active),
                               jnp.zeros(2, jnp.int32))
        rows_t = tpgc.RowState(torch.tensor(lengths), torch.tensor(bt), torch.tensor(active),
                               torch.zeros(2, dtype=torch.int32))
        lj, jcaches = decode_fn(params, jnp.asarray(toks), rows_j, jcaches)
        lt, _ = TM.decode_step_rows(tcfg, trt, tparams, torch.tensor(toks), rows_t, tcaches)
        _close(lt[active], np.asarray(lj)[active], LOGIT_TOL)
        lengths = lengths + active
    assert lengths.max() > 6   # slot 0 selected 6 of its keys
    mapped = bt[bt > 0]
    for i in range(2):
        t, j = tcaches["blocks"][0][i], jcaches["blocks"][0]
        for name in ("k", "v"):
            _close(getattr(t, name)[mapped], np.asarray(getattr(j, name)[i])[mapped])
        for name in ("proxy_scale", "proxy_zero"):
            _close(getattr(t, name), np.asarray(getattr(j, name)[i]), LOGIT_TOL)
        differ = t.proxy[mapped].numpy() != np.asarray(j.proxy[i])[mapped]
        assert differ.mean() < 5e-3, differ.mean()
