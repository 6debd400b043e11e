"""The plain versions of the port's contiguous kernels against the JAX
package's Pallas kernels (interpret mode), on the cases of
``tests/test_kernels.py``:

  B8  ``flash_attention_plain``    vs ``flash_attention_tpu``
  B9  ``decomposed_decode_plain``  vs ``decomposed_decode_fwd``
  B10 ``cpq_decode_plain``         vs ``cpq_decode_fwd``

Tolerances (max abs): 1e-5 in float32 (both compute in float32 and differ
in summation order), 2e-2 in bfloat16 (bf16 rounding of the scores and of
the output, below 4 in magnitude), 3e-2 for B9 in bfloat16 (its TPU kernel
rounds the softmax weights to bf16 where the port keeps them float32, as
``tests/test_kernels.py`` allows its own reference). Beyond the TPU
kernels' contracts: B9 with a roped key per kv head (kv_r = KV, qwen's T1
cache) against the port's ``decomposed_attention``, and B10 with rounded
tiles against ``cpq_chunked_decode_attention``, the functions the static
engine serves. The shared layouts of ``torch_paged_cases.py`` (the CUDA
tests' cases: Dh up to 256, GQA and MQA, T no multiple of the kernel's
64-row tile, d_model up to 4096) run here too: B8's plain version against
``flash_attention_tpu`` on ``FLASH_CASES``, B9's against
``decomposed_decode_fwd`` on the ``CONTIG_T1_CASES`` of the TPU kernel's
layout, and on the cases with a roped key per group of heads (qwen's
layout, past one key split of the card's tensor-core route) against the
paged TPU kernel over the same arenas as pages.
``test_torch_kernels_cuda.py`` holds the CUDA kernels against these plain
versions."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import CPQCfg as JCPQCfg
from repro.core import cpq as JC
from repro.kernels.cpq_dequant_attn.kernel import cpq_decode_fwd
from repro.kernels.decomposed_attn.kernel import (decomposed_decode_fwd,
                                                  paged_decomposed_decode_fwd)
from repro.kernels.flash_attn.ops import flash_attention_tpu
from repro_torch.core import cpq as TC
from repro_torch.core.attention import cpq_chunked_decode_attention
from repro_torch.core.decomposed_attention import decomposed_attention
from repro_torch.kernels.cpq_attn import ops as cpq_ops
from repro_torch.kernels.decomposed_attn import ops as t1_ops
from repro_torch.kernels.flash_attn import ops as fa_ops
from torch_paged_cases import (CONTIG_T1_CASES, FLASH_CASES, contig_t1_inputs,
                               flash_inputs)

KEY = jax.random.PRNGKey(0)
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _t(a, dtype=None):
    """A JAX array as a CPU tensor of the same values."""
    t = torch.tensor(np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a))
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("T,S,H,KV,D,causal,bq,bk,dtype", [
    (128, 128, 4, 2, 64, True, 64, 64, jnp.float32),
    (256, 256, 8, 8, 128, True, 128, 128, jnp.float32),
    (100, 100, 4, 1, 32, False, 64, 64, jnp.float32),
    (192, 192, 6, 3, 64, True, 128, 64, jnp.float32),
    (128, 128, 4, 4, 64, True, 64, 64, jnp.bfloat16),
    (1, 75, 4, 4, 64, False, 64, 64, jnp.float32),     # a decode token, S not a block multiple
])
def test_flash_attention_plain_matches_jax_kernel(T, S, H, KV, D, causal, bq, bk, dtype):
    ks = jax.random.split(KEY, 3)
    q = jax.random.normal(ks[0], (2, T, H, D), dtype)
    k = jax.random.normal(ks[1], (2, S, KV, D), dtype)
    v = jax.random.normal(ks[2], (2, S, KV, D), dtype)
    want = flash_attention_tpu(q, k, v, D ** -0.5, causal, bq, bk, interpret=True)
    td = TORCH[dtype]
    got = fa_ops.flash_attention(_t(q, td), _t(k, td), _t(v, td), D ** -0.5, causal)
    assert fa_ops.flash_attention.launches == 0   # a CPU tensor runs the plain version
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_matches_jax_kernel_on_shared_cases(case):
    """The cases the CUDA routes are held to: k and v the first S keys of
    a longer arena, causal or not, a decode token, Dh 16 to 256."""
    q, k, v, scale = flash_inputs(*case)
    S, causal = case[3], case[7]
    k, v = k[:, :S], v[:, :S]
    want = flash_attention_tpu(*(jnp.asarray(a) for a in (q, k, v)), scale, causal, 64, 64,
                               interpret=True)
    got = fa_ops.flash_attention(*(torch.tensor(a) for a in (q, k, v)), scale, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", [c for c in CONTIG_T1_CASES if c[5] == 1 or c[6] == 0])
def test_decomposed_decode_plain_matches_jax_kernel_on_shared_cases(case):
    """The TPU kernel's layout (one shared roped key, or none) of the
    cases the CUDA kernel is held to, d_model up to 4096."""
    r, qr, x, kr, length, scale = contig_t1_inputs(*case)
    want = decomposed_decode_fwd(*(jnp.asarray(a) for a in (r, qr, x, kr[:, :, 0])),
                                 jnp.asarray(length, jnp.int32), scale=scale, block_n=16,
                                 interpret=True)
    got = t1_ops.decomposed_decode_fwd(*(torch.tensor(a) for a in (r, qr, x, kr)), length,
                                       scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", [c for c in CONTIG_T1_CASES if c[5] > 1 and c[6] > 0])
def test_decomposed_decode_plain_matches_jax_paged_kernel_per_group(case):
    """The cases with a roped key per group of heads (qwen's T1 cache, which
    the contiguous TPU kernel does not take), against the JAX package's
    paged T1 kernel over the same arenas as pages: row b is page b + 1 of
    N tokens, behind a poisoned null page."""
    r, qr, x, kr, length, scale = contig_t1_inputs(*case)
    B, N = x.shape[:2]
    xp = np.concatenate([np.full((1, *x.shape[1:]), 1e3, np.float32), x])
    krp = np.concatenate([np.full((1, *kr.shape[1:]), 1e3, np.float32), kr])
    bt = np.arange(1, B + 1, dtype=np.int32)[:, None]
    want = paged_decomposed_decode_fwd(*(jnp.asarray(a) for a in (r, qr, xp, krp, bt)),
                                       jnp.full((B,), length, jnp.int32), scale=scale,
                                       interpret=True)
    got = t1_ops.decomposed_decode_fwd(*(torch.tensor(a) for a in (r, qr, x, kr)), length,
                                       scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("H,Dm,N,Rr,bn,dtype", [
    (8, 128, 256, 0, 64, jnp.float32),
    (8, 128, 300, 16, 128, jnp.float32),
    (16, 64, 512, 32, 256, jnp.float32),
    (4, 256, 128, 0, 128, jnp.bfloat16),
])
def test_decomposed_decode_plain_matches_jax_kernel(H, Dm, N, Rr, bn, dtype):
    """The TPU kernel's layout: one roped key per token shared by every
    head (kv_r = 1), or none."""
    ks = jax.random.split(KEY, 4)
    r = jax.random.normal(ks[0], (2, H, Dm), dtype)
    qr = jax.random.normal(ks[1], (2, H, Rr), dtype)
    x = jax.random.normal(ks[2], (2, N, Dm), dtype)
    kr = jax.random.normal(ks[3], (2, N, Rr), dtype)
    length = N - 9
    want = decomposed_decode_fwd(r, qr, x, kr, jnp.asarray(length, jnp.int32), scale=0.1,
                                 block_n=bn, interpret=True)
    td = TORCH[dtype]
    got = t1_ops.decomposed_decode_fwd(_t(r, td), _t(qr, td), _t(x, td),
                                       _t(kr, td)[:, :, None, :], length, 0.1)
    tol = 1e-5 if dtype == jnp.float32 else 3e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("kv_r,G,Rr,length", [(4, 2, 8, 40), (4, 1, 16, 57), (1, 4, 8, 33),
                                              (4, 2, 0, 12)])
def test_decomposed_decode_op_matches_decomposed_attention(kv_r, G, Rr, length):
    """The op (R = q_nope W_K^T, the B9 sweep, P W_V) with a roped key per
    kv head (qwen's layout), shared, or none, against the port's
    ``decomposed_attention``, which the JAX package's static T1 decode runs."""
    rng = np.random.default_rng(kv_r * 10 + Rr)
    B, KV, N, Dn, Dv, Dm = 2, 4, 57, 16, 16, 64
    H = KV * G
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))  # noqa: E731
    qn, qr = f(B, 1, H, Dn), f(B, 1, H, Rr)
    x, kr = f(B, N, Dm), f(B, N, kv_r if Rr else KV, Rr)
    wk, wv = f(Dm, KV, Dn) / Dm ** 0.5, f(Dm, KV, Dv) / Dm ** 0.5
    got = t1_ops.decomposed_decode(qn, qr, x, kr, length, wk, wv, 0.2)
    want = decomposed_attention(qn, qr, x, kr, wk, wv, length, 0.2)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _cpq_inputs(bits, KV, G, Dh, N):
    """``tests/test_kernels.py``'s T2 arena: a prompt fit of N - 16 tokens,
    then one wide K and V token each (new HQE levels), length N - 15; the
    unwritten tail holds code 0 (stored 0)."""
    cfg = JCPQCfg(prune_ratio=0.3, bits=bits, max_levels=4)
    ks = jax.random.split(KEY, 3)
    S0 = N - 16

    @jax.jit
    def arena(x, x_t):
        t = JC.cpq_compress_prefill(x, cfg, N)
        return JC.cpq_append_decode(t, x_t, jnp.asarray(S0, jnp.int32), cfg)

    tk = arena(jax.random.normal(ks[0], (2, S0, KV, Dh)), 6 * jnp.ones((2, 1, KV, Dh)))
    tv = arena(jax.random.normal(ks[1], (2, S0, KV, Dh)), -6 * jnp.ones((2, 1, KV, Dh)))
    q = jax.random.normal(ks[2], (2, KV, G, Dh))
    return q, tk, tv, S0 + 1


@pytest.mark.parametrize("bits,KV,G,Dh,N,bn", [
    (8, 4, 2, 32, 128, 32),
    (4, 2, 4, 64, 96, 48),
    (8, 8, 1, 128, 256, 128),
])
def test_cpq_decode_plain_matches_jax_kernel(bits, KV, G, Dh, N, bn):
    """Tiles not rounded: the TPU kernel's function."""
    q, tk, tv, length = _cpq_inputs(bits, KV, G, Dh, N)
    args = (q, tk.codes, tv.codes, tk.scale, tk.zero, tv.scale, tv.zero, tk.level, tv.level)
    want = cpq_decode_fwd(*args, jnp.asarray(length, jnp.int32), scale=0.17, block_n=bn,
                          interpret=True)
    got = cpq_ops.cpq_decode_fwd(*(_t(a) for a in args), length, 0.17)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("bits,G", [(4, 1), (8, 4)])
def test_cpq_decode_rounded_matches_chunked_decode(bits, G):
    """Tiles rounded to bf16: the static engine's T2 decode,
    ``cpq_chunked_decode_attention``, over the same arena."""
    q, tk, tv, length = _cpq_inputs(bits, 4, G, 32, 80)
    kt, vt = (TC.CPQTensor(*(_t(a) for a in t)) for t in (tk, tv))
    qt = _t(q).reshape(2, 1, 4 * G, 32)
    got = cpq_ops.cpq_decode(qt, kt, vt, length, 0.17)
    want = cpq_chunked_decode_attention(qt, kt, vt, length, 0.17)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
