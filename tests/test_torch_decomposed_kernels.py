"""The port's T1 (decomposed) attention kernels and oracle against the JAX
package's.

On the CPU the B3/B4 sweeps (``paged_decomposed_*_fwd``) run their plain
PyTorch versions; these are held against the JAX Pallas kernels (interpret
mode) on paged X layouts: a poisoned null page, permuted physical pages,
ragged and empty rows, partial last pages, roped keys shared (kv_r = 1) or
per group of heads (kv_r > 1, several heads per group), no roped term
(Rr = 0), prompt chunks at offset 0, mid-prompt and with valid < C, and the
widths the CUDA kernels are built for. The full wrappers (R = q_nope W_K^T,
the sweep, P W_V) are held against the JAX ops with G > 1 query heads per
kv head, and ``decomposed_attention`` (the gather path) against the JAX
function, causal and with per-row lengths. Tolerance 1e-5 at float32: both
sides compute in float32 and differ only in summation order.

``test_torch_kernels_cuda.py`` holds the CUDA kernels against the plain
versions on the same layouts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.decomposed_attention import decomposed_attention as j_decomposed
from repro.kernels.decomposed_attn.kernel import (paged_decomposed_decode_fwd,
                                                  paged_decomposed_prefill_fwd)
from repro.kernels.decomposed_attn.ops import (paged_decomposed_decode_tpu,
                                               paged_decomposed_prefill_tpu)
from repro_torch.core.decomposed_attention import decomposed_attention as t_decomposed
from repro_torch.kernels.decomposed_attn import ops
from torch_paged_cases import (SERVED_T1_DECODE_CASES, SERVED_T1_PREFILL_CASES,
                               T1_DECODE_CASES, T1_PREFILL_CASES, T1_WIDE,
                               served_t1_decode_inputs, served_t1_prefill_inputs,
                               t1_decode_inputs, t1_prefill_inputs, tensors)

ATOL = 1e-5


@pytest.mark.parametrize("case", T1_DECODE_CASES
                         + [(6 + i, 16, 2, 2, *w) for i, w in enumerate(T1_WIDE)])
def test_plain_decomposed_decode_matches_jax_kernel(case):
    r, qr, xp, krp, bt, lengths, scale = t1_decode_inputs(*case)
    ref = paged_decomposed_decode_fwd(*map(jnp.asarray, (r, qr, xp, krp, bt, lengths)),
                                      scale=scale, interpret=True)
    before = ops.paged_decomposed_decode.launches
    out = ops.paged_decomposed_decode_fwd(*tensors(r, qr, xp, krp, bt, lengths), scale)
    assert ops.paged_decomposed_decode.launches == before  # the CPU path launches nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert not out[torch.tensor(lengths == 0)].any()  # empty rows -> zeros


@pytest.mark.parametrize("case", SERVED_T1_DECODE_CASES)
def test_plain_decomposed_decode_matches_jax_kernel_on_served_cases(case):
    """B3 at qwen1.5-0.5b's served T1 shape: an empty row, a full row,
    partial last pages, rows the card's tensor-core route splits."""
    r, qr, xp, krp, bt, lengths, scale = served_t1_decode_inputs(*case)
    ref = paged_decomposed_decode_fwd(*map(jnp.asarray, (r, qr, xp, krp, bt, lengths)),
                                      scale=scale, interpret=True)
    out = ops.paged_decomposed_decode_fwd(*tensors(r, qr, xp, krp, bt, lengths), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert not out[torch.tensor(lengths == 0)].any()


@pytest.mark.parametrize("case", T1_PREFILL_CASES + SERVED_T1_PREFILL_CASES)
def test_plain_decomposed_prefill_matches_jax_kernel(case):
    make = t1_prefill_inputs if case in T1_PREFILL_CASES else served_t1_prefill_inputs
    r, qr, xp, krp, row, offset, valid, scale = make(*case)
    ref = paged_decomposed_prefill_fwd(*map(jnp.asarray, (r, qr, xp, krp, row)),
                                       jnp.asarray(offset, jnp.int32),
                                       jnp.asarray(valid, jnp.int32), scale=scale,
                                       interpret=True)
    before = ops.paged_decomposed_prefill.launches
    out = ops.paged_decomposed_prefill_fwd(*tensors(r, qr, xp, krp, row), offset, valid,
                                           scale)
    assert ops.paged_decomposed_prefill.launches == before
    np.testing.assert_allclose(out.numpy()[:valid], np.asarray(ref)[:valid], atol=ATOL,
                               rtol=0)


def _weights(rng, Dm, KV, Dn, Dv):
    w_k = (rng.normal(size=(Dm, KV, Dn)) / np.sqrt(Dm)).astype(np.float32)
    w_v = (rng.normal(size=(Dm, KV, Dv)) / np.sqrt(Dm)).astype(np.float32)
    return w_k, w_v


@pytest.mark.parametrize("seed,kv_r,Rr", [(0, 2, 8), (1, 1, 8), (2, 2, 0)])
def test_decomposed_decode_wrapper_matches_jax_op(seed, kv_r, Rr):
    """R, the sweep and P W_V with 2 query heads per kv head (KV = 2, H = 4)."""
    rng = np.random.default_rng(seed)
    page, nb, B, H, KV, Dm, Dn, Dv = 4, 3, 3, 4, 2, 16, 8, 8
    _, _, xp, krp, bt, lengths, scale = t1_decode_inputs(seed, page, nb, B, H, Dm, kv_r, Rr)
    q_nope = rng.normal(size=(B, 1, H, Dn)).astype(np.float32)
    q_rope = rng.normal(size=(B, 1, H, Rr)).astype(np.float32)
    w_k, w_v = _weights(rng, Dm, KV, Dn, Dv)
    ref = paged_decomposed_decode_tpu(*map(jnp.asarray, (q_nope, q_rope, xp, krp, bt,
                                                         lengths, w_k, w_v)), scale)
    out = ops.paged_decomposed_decode(*tensors(q_nope, q_rope, xp, krp, bt, lengths, w_k,
                                               w_v), scale)
    assert out.shape == (B, 1, H, Dv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed,offset,valid,kv_r,Rr", [(0, 0, 8, 2, 8), (1, 12, 5, 1, 8),
                                                       (2, 5, 8, 2, 0)])
def test_decomposed_prefill_wrapper_matches_jax_op(seed, offset, valid, kv_r, Rr):
    rng = np.random.default_rng(seed)
    H, KV, Dm, Dn, Dv, C = 4, 2, 16, 8, 8, 8
    _, _, xp, krp, row, offset, valid, scale = t1_prefill_inputs(seed, offset, valid, H,
                                                                 Dm, kv_r, Rr)
    q_nope = rng.normal(size=(1, C, H, Dn)).astype(np.float32)
    q_rope = rng.normal(size=(1, C, H, Rr)).astype(np.float32)
    w_k, w_v = _weights(rng, Dm, KV, Dn, Dv)
    ref = paged_decomposed_prefill_tpu(
        *map(jnp.asarray, (q_nope, q_rope, xp, krp, row)), jnp.asarray(offset, jnp.int32),
        jnp.asarray(valid, jnp.int32), jnp.asarray(w_k), jnp.asarray(w_v), scale)
    out = ops.paged_decomposed_prefill(*tensors(q_nope, q_rope, xp, krp, row), offset,
                                       valid, *tensors(w_k, w_v), scale)
    assert out.shape == (1, C, H, Dv)
    np.testing.assert_allclose(out.numpy()[:, :valid], np.asarray(ref)[:, :valid],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal,kv_r,Rr", [(True, 2, 8), (False, 2, 8), (False, 1, 8),
                                            (True, 2, 0)])
def test_decomposed_attention_matches_jax(causal, kv_r, Rr):
    """The gather-path oracle: causal over one chunk (query positions at an
    offset, scalar length) or one token per row with per-row lengths."""
    rng = np.random.default_rng(4)
    H, KV, Dm, Dn, Dh, N = 4, 2, 16, 8, 8, 12
    B, T = (1, 5) if causal else (3, 1)
    q_nope = rng.normal(size=(B, T, H, Dn)).astype(np.float32)
    q_rope = rng.normal(size=(B, T, H, Rr)).astype(np.float32)
    x = rng.normal(size=(B, N, Dm)).astype(np.float32)
    k_rope = rng.normal(size=(B, N, kv_r, Rr)).astype(np.float32)
    w_k, w_v = _weights(rng, Dm, KV, Dn, Dh)
    if causal:
        length, qpos = 9, np.arange(4, 9, dtype=np.int32)
    else:
        length, qpos = np.array([3, 12, 7], np.int32), None
    ref = j_decomposed(*map(jnp.asarray, (q_nope, q_rope, x, k_rope, w_k, w_v)),
                       jnp.asarray(length), 0.3,
                       query_positions=None if qpos is None else jnp.asarray(qpos))
    out = t_decomposed(*tensors(q_nope, q_rope, x, k_rope, w_k, w_v),
                       torch.as_tensor(length), 0.3,
                       query_positions=None if qpos is None else torch.tensor(qpos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
