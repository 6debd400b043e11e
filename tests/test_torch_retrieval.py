"""The port's T3 core (``core/retrieval_attention.py``) against the JAX
package's, on the same numpy inputs, in float32.

``fit_proxy`` and ``encode_proxy`` are held bit for bit against the JITTED
JAX functions, which is how the serving engine runs them: under jit XLA
divides the code range by the constant step count through its float32
reciprocal, and eager JAX differs from that in the last ulp of most scales.
``select_topk`` must return the same index sets in the same order,
``lax.top_k``'s lowest-index-first tie rule included: ties are certain in
the recent window (every recent key scores 1e20), past the length (-1e30)
and between keys with equal codes. ``proxy_scores`` and
``retrieval_attention`` are held to 1e-5 (float32 sums in another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import RetrievalCfg as JRetrievalCfg
from repro.core import retrieval_attention as JR
from repro_torch.configs import RetrievalCfg
from repro_torch.core import retrieval_attention as TR

TOL = 1e-5


def _close(t_out, j_out, tol=TOL):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape,bits,spread", [
    ((1, 16, 16, 64), 8, 1.0),      # qwen's kv heads and head dim
    ((2, 13, 4, 16), 8, 3.0),
    ((3, 8, 2, 32), 4, 0.1),        # fewer bits, a narrow range
    ((1, 1, 2, 16), 8, 1.0),        # one key: a zero range, scale at 1e-8
])
def test_fit_and_encode_proxy_bit_exact_against_jitted_jax(shape, bits, spread):
    rng = np.random.default_rng(0)
    k = (rng.normal(size=shape) * spread).astype(np.float32)
    jfit = jax.jit(JR.fit_proxy, static_argnums=1)
    cj, sj, zj = (np.asarray(a) for a in jfit(jnp.asarray(k), bits))
    ct, st, zt = TR.fit_proxy(torch.tensor(k), bits)
    for t, j in ((ct, cj), (st, sj), (zt, zj)):
        np.testing.assert_array_equal(t.numpy(), j)
    assert ct.dtype == torch.int8
    # new keys, some outside the fitted range (codes clip at both ends)
    kn = (rng.normal(size=(shape[0], 5) + shape[2:]) * spread * 1.5).astype(np.float32)
    jenc = jax.jit(JR.encode_proxy, static_argnums=3)
    np.testing.assert_array_equal(
        TR.encode_proxy(torch.tensor(kn), st, zt, bits).numpy(),
        np.asarray(jenc(jnp.asarray(kn), jnp.asarray(sj), jnp.asarray(zj), bits)))


@pytest.mark.parametrize("g", [1, 4])
def test_proxy_scores_match_jax(g):
    rng = np.random.default_rng(1)
    B, T, KV, N, Dp = 2, 3, 2, 24, 16
    q = rng.normal(size=(B, T, KV * g, Dp)).astype(np.float32)
    codes, scale, zero = jax.jit(JR.fit_proxy)(jnp.asarray(
        rng.normal(size=(B, N, KV, Dp)).astype(np.float32)))
    sj = JR.proxy_scores(jnp.asarray(q), codes, scale, zero)
    st = TR.proxy_scores(torch.tensor(q), *(torch.tensor(np.asarray(a))
                                            for a in (codes, scale, zero)))
    tol = TOL * float(np.abs(np.asarray(sj)).max())
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=tol, rtol=0)


def _topk_inputs(case):
    """(scores (B, T, H, N), length, top_k, recent_window, query_positions)."""
    rng = np.random.default_rng(2)
    B, T, H, N = 3, 2, 4, 20
    s = rng.normal(size=(B, T, H, N)).astype(np.float32)
    length, qpos, top_k, recent = np.array([20, 13, 0], np.int32), None, 6, 3
    if case == "recent_covers_topk":        # recent_window >= top_k: 1e20 ties
        top_k, recent = 4, 6
    elif case == "equal_proxies":           # equal scores across the top-k boundary
        s = rng.integers(0, 4, size=(B, T, H, N)).astype(np.float32)
        recent = 0
    elif case == "query_positions":         # a chunk's causal queries
        length, qpos = np.int32(17), np.array([9, 16], np.int32)
    elif case == "top_k_above_n":
        top_k = 32
    elif case == "scalar_length":
        length = np.int32(11)
    return s, length, top_k, recent, qpos


@pytest.mark.parametrize("case", ["plain", "recent_covers_topk", "equal_proxies",
                                  "query_positions", "top_k_above_n", "scalar_length"])
def test_select_topk_matches_lax_top_k(case):
    s, length, top_k, recent, qpos = _topk_inputs(case)
    jcfg, tcfg = (C(top_k=top_k, recent_window=recent) for C in (JRetrievalCfg, RetrievalCfg))
    ij = np.asarray(jax.jit(JR.select_topk, static_argnums=2)(
        jnp.asarray(s), jnp.asarray(length), jcfg,
        None if qpos is None else jnp.asarray(qpos)))
    it = TR.select_topk(torch.tensor(s), torch.tensor(length), tcfg,
                        None if qpos is None else torch.tensor(qpos))
    assert it.shape == ij.shape == s.shape[:3] + (min(top_k, s.shape[-1]),)
    np.testing.assert_array_equal(it.numpy(), ij)   # same sets, same order


def test_gather_kv_matches_jax():
    rng = np.random.default_rng(3)
    B, N, KV, Dh, T, H, K = 2, 10, 2, 8, 3, 4, 5
    k = rng.normal(size=(B, N, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(B, N, KV, Dh)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, T, H, K)).astype(np.int32)
    kj, vj = JR.gather_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx))
    kt, vt = TR.gather_kv(torch.tensor(k), torch.tensor(v), torch.tensor(idx).long())
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("calibrate", [True, False])
@pytest.mark.parametrize("layout", ["decode_rows", "chunk", "proxy_dim"])
def test_retrieval_attention_matches_jax(calibrate, layout):
    """Decode rows with per-row lengths (one of them shorter than top_k, so
    candidates duplicate invalid slots), a chunk of causal queries with
    ``query_positions``, and a proxy over the first 8 dims only."""
    rng = np.random.default_rng(4)
    B, N, KV, g, Dh = 2, 24, 2, 2, 16
    T, length, qpos, proxy_dim = 1, np.array([24, 5], np.int32), None, 0
    if layout == "chunk":
        T, length, qpos = 4, np.int32(21), np.array([17, 18, 19, 20], np.int32)
    elif layout == "proxy_dim":
        proxy_dim = 8
    q = rng.normal(size=(B, T, KV * g, Dh)).astype(np.float32)
    k = rng.normal(size=(B, N, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(B, N, KV, Dh)).astype(np.float32)
    dp = proxy_dim or Dh
    codes, pscale, pzero = (np.asarray(a) for a in jax.jit(JR.fit_proxy)(jnp.asarray(k[..., :dp])))
    jcfg = JRetrievalCfg(top_k=7, recent_window=3, proxy_dim=proxy_dim)
    tcfg = RetrievalCfg(top_k=7, recent_window=3, proxy_dim=proxy_dim)
    oj = JR.retrieval_attention(
        *(jnp.asarray(a) for a in (q, k, v, codes, pscale, pzero, length)), jcfg, 0.25,
        None if qpos is None else jnp.asarray(qpos), calibrate)
    ot = TR.retrieval_attention(
        *(torch.tensor(a) for a in (q, k, v, codes, pscale, pzero, length)), tcfg, 0.25,
        None if qpos is None else torch.tensor(qpos), calibrate)
    _close(ot, oj)
