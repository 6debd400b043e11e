"""The port's T2 (CPQ) attention kernels and oracles against the JAX
package's.

On the CPU the B5/B6 wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels (interpret mode) on paged CPQ layouts: a
poisoned null page whose levels lie outside [0, L), permuted physical
pages, ragged and empty rows, partial last pages, a live row over an
all-null block row (the CPQ arm of a tiered decode), first and later
prompt chunks with ``valid < C``. The gather-path oracles
(``cpq_chunked_decode_attention``, ``cpq_chunk_prefill_attention``) are held
against theirs. Tolerance 1e-5 at float32: both sides dequantize to the same
bf16 values and differ only in summation order.

``test_torch_kernels_cuda.py`` holds the CUDA kernels against the plain
versions on the same layouts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import attention as j_attn
from repro.kernels.cpq_dequant_attn.ops import paged_cpq_decode_tpu, paged_cpq_prefill_tpu
from repro.serving import paged_cache as jpgc
from repro_torch.core import attention as t_attn
from repro_torch.kernels.cpq_attn import ops
from repro_torch.serving import paged_cache as tpgc
from torch_paged_cases import (CPQ_DECODE_CASES, CPQ_PREFILL_CASES, SERVED_CPQ_DECODE_CASES,
                               SERVED_PREFILL_CASES, cpq_arena, cpq_decode_inputs,
                               cpq_prefill_inputs, served_cpq_decode_inputs,
                               served_cpq_prefill_inputs)

ATOL = 1e-5


def jax_arena(pool):
    codes, level, scale, zero = pool
    slots, _, KV, D = scale.shape
    return jpgc.PagedCPQTensor(jnp.asarray(codes), jnp.asarray(level), jnp.asarray(scale),
                               jnp.asarray(zero), jnp.ones((slots, KV), jnp.int32),
                               jnp.zeros((slots, KV, D), jnp.float32))


def _cpq_decode_case(case):
    return (cpq_decode_inputs if case in CPQ_DECODE_CASES else served_cpq_decode_inputs)(*case)


@pytest.mark.parametrize("case", CPQ_DECODE_CASES + SERVED_CPQ_DECODE_CASES)
def test_plain_cpq_decode_matches_jax_kernel(case):
    q, kp, vp, bt, lengths, scale = _cpq_decode_case(case)
    ref = paged_cpq_decode_tpu(jnp.asarray(q), jax_arena(kp), jax_arena(vp),
                               jnp.asarray(bt), jnp.asarray(lengths), scale)
    before = ops.paged_cpq_decode.launches
    out = ops.paged_cpq_decode(torch.tensor(q), cpq_arena(kp), cpq_arena(vp),
                               torch.tensor(bt), torch.tensor(lengths), scale)
    assert ops.paged_cpq_decode.launches == before  # the CPU path launches nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert not out[torch.tensor(lengths == 0)].any()  # empty rows -> zeros


def _cpq_prefill_case(case):
    return (cpq_prefill_inputs if case in CPQ_PREFILL_CASES else served_cpq_prefill_inputs)(*case)


@pytest.mark.parametrize("case", CPQ_PREFILL_CASES + SERVED_PREFILL_CASES)
def test_plain_cpq_prefill_matches_jax_kernel(case):
    q, kp, vp, k_raw, v_raw, slot, row, offset, valid, scale = _cpq_prefill_case(case)
    ref = paged_cpq_prefill_tpu(jnp.asarray(q), jax_arena(kp), jax_arena(vp),
                                jnp.asarray(k_raw), jnp.asarray(v_raw),
                                jnp.asarray(slot, jnp.int32), jnp.asarray(row),
                                jnp.asarray(offset, jnp.int32),
                                jnp.asarray(valid, jnp.int32), scale)
    before = ops.paged_cpq_prefill.launches
    out = ops.paged_cpq_prefill(torch.tensor(q), cpq_arena(kp), cpq_arena(vp),
                                torch.tensor(k_raw), torch.tensor(v_raw), slot,
                                torch.tensor(row), offset, valid, scale)
    assert ops.paged_cpq_prefill.launches == before
    np.testing.assert_allclose(out.numpy()[0, :valid], np.asarray(ref)[0, :valid],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", CPQ_DECODE_CASES[:3])
def test_cpq_decode_gather_oracle_matches_jax(case):
    """``cpq_chunked_decode_attention`` over logical views, both packages;
    levels stay in range (the reference's gather reads none outside)."""
    q, kp, vp, bt, lengths, scale = cpq_decode_inputs(*case, poison_levels=False)
    lengths = np.maximum(lengths, 1)   # the oracle leaves empty rows undefined
    ref = j_attn.cpq_chunked_decode_attention(
        jnp.asarray(q), jpgc.logical_cpq(jax_arena(kp), jnp.asarray(bt)),
        jpgc.logical_cpq(jax_arena(vp), jnp.asarray(bt)), jnp.asarray(lengths), scale)
    out = t_attn.cpq_chunked_decode_attention(
        torch.tensor(q), tpgc.logical_cpq(cpq_arena(kp), torch.tensor(bt)),
        tpgc.logical_cpq(cpq_arena(vp), torch.tensor(bt)), torch.tensor(lengths), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", CPQ_PREFILL_CASES)
def test_cpq_prefill_gather_oracle_matches_jax(case):
    q, kp, vp, k_raw, v_raw, slot, row, offset, valid, scale = cpq_prefill_inputs(
        *case, poison_levels=False)
    ref = jpgc.cpq_chunk_prefill_attention(
        jnp.asarray(q), jax_arena(kp), jax_arena(vp), jnp.asarray(row),
        jnp.asarray(slot, jnp.int32), jnp.asarray(k_raw), jnp.asarray(v_raw),
        jnp.asarray(offset, jnp.int32), jnp.asarray(valid, jnp.int32), scale)
    out = tpgc.cpq_chunk_prefill_attention(
        torch.tensor(q), cpq_arena(kp), cpq_arena(vp), torch.tensor(row), slot,
        torch.tensor(k_raw), torch.tensor(v_raw), offset, valid, scale)
    np.testing.assert_allclose(out.numpy()[0, :valid], np.asarray(ref)[0, :valid],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", CPQ_DECODE_CASES[:2])
def test_out_of_range_levels_read_zero(case):
    """A token whose level lies outside [0, L) dequantizes to 0, in both
    packages' kernels: a row over the poisoned null page attends all-zero
    keys and values."""
    q, kp, vp, bt, lengths, scale = cpq_decode_inputs(*case)
    B = q.shape[0]
    bt[:] = 0
    lengths[:] = bt.shape[1]
    kp[1][0] = vp[1][0] = 9          # every null-page level out of range
    out = ops.paged_cpq_decode(torch.tensor(q), cpq_arena(kp), cpq_arena(vp),
                               torch.tensor(bt), torch.tensor(lengths), scale)
    ref = paged_cpq_decode_tpu(jnp.asarray(q), jax_arena(kp), jax_arena(vp),
                               jnp.asarray(bt), jnp.asarray(lengths), scale)
    assert out.shape[0] == B and not out.any()
    assert not np.asarray(ref).any()
