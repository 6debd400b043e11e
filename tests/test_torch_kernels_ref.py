"""The port's paged-attention kernels against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions; these are held
against the JAX Pallas kernels (interpret mode) on the layouts of
``test_kernels_paged.py``: a poisoned null page, permuted physical pages,
ragged and empty rows, partial last pages, for G = 1 and G = 4 query heads
per kv head. Tolerance 1e-5 at float32 (both sides compute in float32; they
differ only in summation order).

``test_torch_kernels_cuda.py`` holds the CUDA kernels against the plain
versions on the same layouts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attn.ops import paged_flash_decode_tpu, paged_flash_prefill_tpu
from repro_torch.configs import AttentionRuntime
from repro_torch.kernels.paged_attn import ops
from repro_torch.serving import paged_cache as pgc
from torch_paged_cases import (DECODE_CASES, PREFILL_CASES, SERVED_DECODE_CASES,
                               SERVED_PREFILL_CASES, decode_inputs, prefill_inputs,
                               served_decode_inputs, served_prefill_inputs, tensors)

ATOL = 1e-5


@pytest.mark.parametrize("case", DECODE_CASES + SERVED_DECODE_CASES)
def test_plain_decode_matches_jax_kernel(case):
    make = decode_inputs if case in DECODE_CASES else served_decode_inputs
    q, kp, vp, bt, lengths, scale = make(*case)
    ref = paged_flash_decode_tpu(*map(jnp.asarray, (q, kp, vp, bt, lengths)), scale)
    before = ops.paged_decode.launches
    out = ops.paged_decode(*tensors(q, kp, vp, bt, lengths), scale)
    assert ops.paged_decode.launches == before  # the CPU path launches nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert not out[torch.tensor(lengths == 0)].any()  # empty rows -> zeros


def _prefill_case(case):
    return (prefill_inputs if case in PREFILL_CASES else served_prefill_inputs)(*case)


@pytest.mark.parametrize("case", PREFILL_CASES + SERVED_PREFILL_CASES)
def test_plain_prefill_matches_jax_kernel(case):
    q, kp, vp, row, offset, valid, scale = _prefill_case(case)
    ref = paged_flash_prefill_tpu(*map(jnp.asarray, (q, kp, vp, row)),
                                  jnp.asarray(offset, jnp.int32),
                                  jnp.asarray(valid, jnp.int32), scale)
    before = ops.paged_prefill.launches
    out = ops.paged_prefill(*tensors(q, kp, vp, row), offset, valid, scale)
    assert ops.paged_prefill.launches == before
    np.testing.assert_allclose(out.numpy()[0, :valid], np.asarray(ref)[0, :valid],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_inactive_rows_write_only_the_null_page(fused):
    """Inactive rows scatter into page 0 (several into one slot at once);
    no other page changes but the active rows' target slots, and what page
    0 holds never reaches an active row's output."""
    rng = np.random.default_rng(7)
    page, nb, KV, g, Dh = 4, 4, 2, 2, 8
    B = 4
    bt = np.zeros((B, nb), np.int32)
    bt[:, :3] = 1 + rng.permutation(B * 3).reshape(B, 3)
    lengths = np.array([5, 0, 9, 0], np.int32)
    active = np.array([True, False, True, False])
    P = 1 + B * 3
    k0 = rng.normal(size=(P, page, KV, Dh)).astype(np.float32)
    v0 = rng.normal(size=(P, page, KV, Dh)).astype(np.float32)
    k0[0] = v0[0] = 1e3
    q = torch.tensor(rng.normal(size=(B, 1, KV * g, Dh)), dtype=torch.float32)
    k_t = torch.tensor(rng.normal(size=(B, 1, KV, Dh)), dtype=torch.float32)
    v_t = torch.tensor(rng.normal(size=(B, 1, KV, Dh)), dtype=torch.float32)
    rows = pgc.RowState(lengths=torch.tensor(lengths), block_table=torch.tensor(bt),
                        active=torch.tensor(active), tier=torch.zeros(B, dtype=torch.int32))
    rt = AttentionRuntime(paged_kernels=fused)

    def run(poison):
        k, v = torch.tensor(k0), torch.tensor(v0)
        k[0] = v[0] = poison
        out, cache = pgc.decode_attend_paged(rt, pgc.PagedDenseKVCache(k, v), rows,
                                             q=q, k_t=k_t, v_t=v_t, scale=0.35)
        return out, cache

    out_a, cache = run(1e3)
    out_b, _ = run(-7.0)
    torch.testing.assert_close(out_a[active], out_b[active], atol=0, rtol=0)
    changed = (cache.k != torch.tensor(k0)).any(-1).any(-1)  # (P, page)
    changed[0] = False
    expect = torch.zeros_like(changed)
    for b in np.flatnonzero(active):
        expect[bt[b, lengths[b] // page], lengths[b] % page] = True
    assert torch.equal(changed, expect)
