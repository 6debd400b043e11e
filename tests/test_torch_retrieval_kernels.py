"""The port's T3 proxy-scoring kernel B7 and the decode paths around it
against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions; these are held
against the JAX Pallas kernel ``proxy_scores_fwd`` (interpret mode, with a
block that does not divide N) and its oracle ``proxy_scores_ref``, against
``proxy_scores_tpu`` and ``retrieval_decode_tpu`` (interpret), and, for the
served call, against the reference's gather path (``proxy_scores`` over
``gather_pages``) on the paged layouts of the other kernels' tests: permuted
pages, a poisoned null page, ragged and empty rows, partial last pages.
Tolerance: max abs error <= 1e-5 x max |score| (float32 sums of 16-64
terms in another order; the reference's gather path scales the codes
before the product, the kernel the query). Masked scores are exactly -1e30.

``test_torch_kernels_cuda.py`` holds the CUDA kernel against the plain
version on the same layouts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import RetrievalCfg as JRetrievalCfg
from repro.core import kv_cache as jkvc
from repro.core import retrieval_attention as JR
from repro.kernels.topk_retrieval.kernel import proxy_scores_fwd
from repro.kernels.topk_retrieval.ops import proxy_scores_tpu, retrieval_decode_tpu
from repro.kernels.topk_retrieval.ref import proxy_scores_ref
from repro.serving import paged_cache as jpgc
from repro_torch.configs import RetrievalCfg
from repro_torch.core import kv_cache as tkvc
from repro_torch.kernels.topk_retrieval import ops
from repro_torch.serving import paged_cache as tpgc
from torch_paged_cases import (CONTIG_PROXY_CASES, PROXY_CASES, SERVED_PROXY_CASES,
                               contig_proxy_inputs, proxy_inputs, proxy_tables,
                               served_proxy_inputs)

REL = 1e-5
NEG_INF = -1e30


def _scores_close(got: np.ndarray, want: np.ndarray):
    live = want > NEG_INF / 2
    np.testing.assert_array_equal(got[~live], want[~live])
    if live.any():
        err = np.abs(got[live] - want[live]).max()
        assert err <= REL * np.abs(want[live]).max(), err


@pytest.mark.parametrize("case", CONTIG_PROXY_CASES)
def test_plain_proxy_scores_match_jax_kernel(case):
    seed, B, N, KV, g, Dp, length, block_n = case
    qs, qz, codes, length = contig_proxy_inputs(seed, B, N, KV, g, Dp, length)
    jargs = (jnp.asarray(qs), jnp.asarray(qz), jnp.asarray(codes), jnp.asarray(length))
    before = ops.proxy_scores.launches
    out = ops.proxy_scores(torch.tensor(qs), torch.tensor(qz), torch.tensor(codes), length)
    assert ops.proxy_scores.launches == before  # the CPU path launches nothing
    assert out.shape == (B, KV, g, N) and out.dtype == torch.float32
    _scores_close(out.numpy(), np.asarray(proxy_scores_fwd(*jargs, block_n=block_n,
                                                           interpret=True)))
    _scores_close(out.numpy(), np.asarray(proxy_scores_ref(*jargs)))


@pytest.mark.parametrize("case", CONTIG_PROXY_CASES)
def test_proxy_scores_q_matches_jax(case):
    seed, B, N, KV, g, Dp, length, _ = case
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, KV * g, Dp)) * 0.2).astype(np.float32)
    scale, zero = proxy_tables(rng, B, KV, Dp)
    codes = rng.integers(-128, 128, size=(B, N, KV, Dp)).astype(np.int8)
    want = proxy_scores_tpu(*(jnp.asarray(a) for a in (q, scale, zero, codes)),
                            jnp.asarray(length, jnp.int32), block_n=16, interpret=True)
    got = ops.proxy_scores_q(*(torch.tensor(a) for a in (q, scale, zero, codes)), length)
    _scores_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", PROXY_CASES)
def test_plain_paged_proxy_scores_match_gather_path(case):
    """The served call's plain version against the reference's gather path:
    ``proxy_scores`` over the codes gathered through the block table, masked
    past each row's length."""
    q, scale, zero, codes, bt, lengths = proxy_inputs(*case)
    B, H, Dp = q.shape
    n = bt.shape[1] * codes.shape[1]
    gathered = jpgc.gather_pages(jnp.asarray(codes), jnp.asarray(bt))
    s = JR.proxy_scores(jnp.asarray(q)[:, None], gathered, jnp.asarray(scale),
                        jnp.asarray(zero))[:, 0]
    want = np.where(np.arange(n)[None, None, :] < lengths[:, None, None], np.asarray(s),
                    np.float32(NEG_INF))
    before = ops.paged_proxy_scores.launches
    got = ops.paged_proxy_scores(*(torch.tensor(a) for a in (q, scale, zero, codes, bt,
                                                             lengths)), n)
    assert ops.paged_proxy_scores.launches == before
    assert got.shape == (B, H, n)
    _scores_close(got.numpy(), want)
    assert (got[torch.tensor(lengths == 0)] == NEG_INF).all()  # empty rows


@pytest.mark.parametrize("case", SERVED_PROXY_CASES)
def test_plain_paged_proxy_scores_scale_the_query_slice(case):
    """The served call as the engine makes it: the query given as the first
    Dp columns of wider rows and its scale apart (``q_scale``), against the
    reference's gather path on the pre-scaled query, with n short of the
    capacity and rows past n."""
    q, scale, zero, codes, bt, lengths, n = served_proxy_inputs(*case)
    wide = np.concatenate([q, q[..., ::-1]], -1)[:, None]      # (B, 1, H, 2 Dp)
    q_scale = 0.3
    gathered = jpgc.gather_pages(jnp.asarray(codes), jnp.asarray(bt))[:, :n]
    s = JR.proxy_scores(jnp.asarray(q * np.float32(q_scale))[:, None], gathered,
                        jnp.asarray(scale), jnp.asarray(zero))[:, 0]
    want = np.where(np.arange(n)[None, None, :] < lengths[:, None, None], np.asarray(s),
                    np.float32(NEG_INF))
    qv = torch.tensor(wide)[:, 0, :, :q.shape[-1]]
    got = ops.paged_proxy_scores(qv, *(torch.tensor(a) for a in (scale, zero, codes, bt,
                                                                 lengths)), n,
                                 q_scale=q_scale)
    assert got.shape == (q.shape[0], q.shape[1], n)
    _scores_close(got.numpy(), want)
    assert (got[torch.tensor(lengths == 0)] == NEG_INF).all()


def _retrieval_cache(rng, B, N, KV, Dh, length, proxy_dim=0):
    k = rng.normal(size=(B, N, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(B, N, KV, Dh)).astype(np.float32)
    dp = proxy_dim or Dh
    codes, pscale, pzero = (np.asarray(a) for a in JR.fit_proxy(jnp.asarray(k[:, :length, :, :dp])))
    proxy = np.zeros((B, N, KV, dp), np.int8)
    proxy[:, :length] = codes
    arrays = (k, v, proxy, pscale, pzero, np.int32(length))
    return (jkvc.RetrievalCache(*(jnp.asarray(a) for a in arrays)),
            tkvc.RetrievalCache(*(torch.tensor(a) for a in arrays)))


@pytest.mark.parametrize("B,N,KV,g,Dh,length,top_k,proxy_dim", [
    (2, 40, 2, 2, 16, 29, 8, 0),
    (1, 24, 1, 4, 32, 24, 24, 0),     # top_k = N: every key picked
    (3, 32, 4, 1, 16, 5, 12, 0),      # length < top_k: padded candidates masked
    (2, 48, 2, 1, 32, 40, 10, 16),    # proxy over the first 16 dims
])
def test_retrieval_decode_matches_jax(B, N, KV, g, Dh, length, top_k, proxy_dim):
    rng = np.random.default_rng(5)
    jcache, tcache = _retrieval_cache(rng, B, N, KV, Dh, length, proxy_dim)
    q = rng.normal(size=(B, 1, KV * g, Dh)).astype(np.float32)
    want = retrieval_decode_tpu(jnp.asarray(q), jcache,
                                JRetrievalCfg(top_k=top_k, recent_window=4,
                                              proxy_dim=proxy_dim), 0.25, interpret=True)
    got = ops.retrieval_decode(torch.tensor(q), tcache,
                               RetrievalCfg(top_k=top_k, recent_window=4,
                                            proxy_dim=proxy_dim), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=REL, rtol=REL)


def test_init_retrieval_matches_jax():
    jc = jkvc.init_retrieval(2, 8, 3, 16, JRetrievalCfg(proxy_dim=8))
    tc = tkvc.init_retrieval(2, 8, 3, 16, RetrievalCfg(proxy_dim=8))
    for name in jkvc.RetrievalCache._fields:
        j, t = np.asarray(getattr(jc, name)), getattr(tc, name)
        assert t.shape == j.shape and str(t.dtype).removeprefix("torch.") == j.dtype.name
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))


@pytest.mark.parametrize("case", PROXY_CASES)
@pytest.mark.parametrize("top_k", [4, 9])
def test_paged_decode_kernel_route_matches_gather_path(case, top_k):
    """The served decode's kernel route (B7 over the pages, top-k, logical
    -> physical translation, a gather of the picked K/V only, calibration)
    against the reference's T3 decode over gathered pages."""
    seed, page, nb, B, KV, g, Dp = case
    _, scale, zero, codes, bt, lengths = proxy_inputs(*case)
    rng = np.random.default_rng(seed + 100)
    P = codes.shape[0]
    kp = rng.normal(size=(P, page, KV, Dp)).astype(np.float32)
    vp = rng.normal(size=(P, page, KV, Dp)).astype(np.float32)
    kp[0] = vp[0] = 1e3
    qd = rng.normal(size=(B, 1, KV * g, Dp)).astype(np.float32)
    cfg = dict(top_k=top_k, recent_window=2)
    want = JR.retrieval_attention(
        jnp.asarray(qd), *(jpgc.gather_pages(jnp.asarray(a), jnp.asarray(bt))
                           for a in (kp, vp, codes)),
        jnp.asarray(scale), jnp.asarray(zero), jnp.asarray(lengths),
        JRetrievalCfg(**cfg), 0.3)
    cache = tpgc.PagedRetrievalCache(*(torch.tensor(a) for a in (kp, vp, codes, scale, zero)))
    got = tpgc.retrieval_decode_paged(cache, torch.tensor(bt), torch.tensor(lengths),
                                      torch.tensor(qd), RetrievalCfg(**cfg), 0.3)
    live = lengths > 0      # an empty row's output is garbage the engine never reads
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], atol=REL, rtol=REL)
