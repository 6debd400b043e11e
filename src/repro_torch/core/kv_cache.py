"""Contiguous decode-cache containers (the JAX package's ``core/kv_cache.py``),
the arenas of the static ``ServeEngine`` and of one-shot admission, which
prefills a B=1 cache of them and packs it into a slot's pages.

Every container holds ``(B, N, ...)`` arenas with a static size ``N`` and
``length``, the number of valid tokens (decode writes at slot ``length``).
``length`` is a () int32 tensor kept on the host, whatever device the arenas
live on, so reading it never waits for the card. The arenas are written in
place (``append_tokens``); a container is rebuilt only to carry a new length
or new per-sequence tables. Shapes:

  B = batch, N = n_max, KV = kv heads, Dh = head_dim, Dm = d_model,
  R = decoupled-rope dims (T1 on RoPE archs), Dp = proxy dims.

Mode -> container:
  dense      DenseKVCache   K, V                      2*KV*Dh     per token
  decomposed XCache         X (+ small roped keys)    Dm + KV*R   per token (T1)
  cpq        CPQKVCache     CPQ(K), CPQ(V)            ~2*KV*Dh*b/8 per token (T2)
  retrieval  RetrievalCache K, V + int8 proxy codes   2*KV*Dh + Dp per token (T3)
The T1+T2 container (``CPQXCache``) is not ported (ROADMAP A16).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from repro_torch.configs import CPQCfg
from repro_torch.core import cpq as cpq_lib


class DenseKVCache(NamedTuple):
    k: torch.Tensor       # (B, N, KV, Dh)
    v: torch.Tensor       # (B, N, KV, Dh)
    length: torch.Tensor  # () int32 on the host


class XCache(NamedTuple):
    """T1: the layer input X instead of K and V, and the roped key slice of
    every kv head (zero-width without rope)."""

    x: torch.Tensor       # (B, N, Dm), the exact input of the K/V projections
    k_rope: torch.Tensor  # (B, N, KV, R)
    length: torch.Tensor


class CPQKVCache(NamedTuple):
    k: cpq_lib.CPQTensor
    v: cpq_lib.CPQTensor
    length: torch.Tensor


class RetrievalCache(NamedTuple):
    k: torch.Tensor            # (B, N, KV, Dh)
    v: torch.Tensor            # (B, N, KV, Dh)
    proxy: torch.Tensor        # (B, N, KV, Dp) int8 proxy codes, stored code - 128
    proxy_scale: torch.Tensor  # (B, KV, Dp) float32
    proxy_zero: torch.Tensor   # (B, KV, Dp) float32
    length: torch.Tensor       # () int32 valid tokens of every row


Cache = Union[DenseKVCache, XCache, CPQKVCache, RetrievalCache]


# ------------------------------------------------------------------- helpers


def host_length(n: int) -> torch.Tensor:
    """A container's ``length``: a () int32 tensor on the host."""
    return torch.tensor(n, dtype=torch.int32)


def valid_mask(length, n_max: int, device="cpu") -> torch.Tensor:
    """(N,) bool: True for written slots."""
    return torch.arange(n_max, device=device) < int(length)


def length_mask(length, n: int, device) -> torch.Tensor:
    """(B|1, N) bool mask of written cache slots. ``length`` is an int, a ()
    tensor for the contiguous arenas, or (B,) per-row paged lengths."""
    length = torch.as_tensor(length, device=device).reshape(-1, 1)
    return torch.arange(n, device=device)[None, :] < length


def append_tokens(arena: torch.Tensor, new: torch.Tensor, pos: int) -> torch.Tensor:
    """Write ``new`` (B, T, ...) into ``arena`` (B, N, ...) at token slot
    ``pos``, in place."""
    arena[:, pos:pos + new.shape[1]] = new.to(arena.dtype)
    return arena


# ------------------------------------------------------------- constructors


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def init_dense(batch: int, n_max: int, kv: int, dh: int, dtype=torch.bfloat16,
               device="cpu") -> DenseKVCache:
    shape = (batch, n_max, kv, dh)
    return DenseKVCache(_zeros(shape, dtype, device), _zeros(shape, dtype, device),
                        host_length(0))


def init_x(batch: int, n_max: int, dm: int, kv: int, rope_dims: int,
           dtype=torch.bfloat16, device="cpu") -> XCache:
    return XCache(x=_zeros((batch, n_max, dm), dtype, device),
                  k_rope=_zeros((batch, n_max, kv, rope_dims), dtype, device),
                  length=host_length(0))


def _empty_cpq(batch: int, n_max: int, h: int, d: int, cfg: CPQCfg,
               device) -> cpq_lib.CPQTensor:
    return cpq_lib.CPQTensor(
        codes=_zeros((batch, n_max, h, d), torch.int8, device),
        scale=_zeros((batch, cfg.max_levels, h, d), torch.float32, device),
        zero=_zeros((batch, cfg.max_levels, h, d), torch.float32, device),
        level=_zeros((batch, n_max, h), torch.int32, device),
        num_levels=torch.ones((batch, h), dtype=torch.int32, device=device),
        prune_thr=_zeros((batch, h, d), torch.float32, device))


def init_cpq(batch: int, n_max: int, kv: int, dh: int, cfg: CPQCfg,
             device="cpu") -> CPQKVCache:
    return CPQKVCache(k=_empty_cpq(batch, n_max, kv, dh, cfg, device),
                      v=_empty_cpq(batch, n_max, kv, dh, cfg, device),
                      length=host_length(0))


def init_retrieval(batch: int, n_max: int, kv: int, dh: int, cfg,
                   dtype=torch.bfloat16, device="cpu") -> RetrievalCache:
    """An empty cache: proxy scale ones, proxy zero zeros, length 0."""
    dp = cfg.proxy_dim or dh
    return RetrievalCache(
        k=_zeros((batch, n_max, kv, dh), dtype, device),
        v=_zeros((batch, n_max, kv, dh), dtype, device),
        proxy=_zeros((batch, n_max, kv, dp), torch.int8, device),
        proxy_scale=torch.ones((batch, kv, dp), dtype=torch.float32, device=device),
        proxy_zero=_zeros((batch, kv, dp), torch.float32, device),
        length=host_length(0))


def bytes_per_token(cache: Cache, cpq_cfg: Optional[CPQCfg] = None) -> float:
    """Off-chip traffic per cached token of a contiguous container; the CPQ
    container goes through ``cpq_bytes_per_token`` with the runtime's
    ``CPQCfg`` (the default one if none is given)."""
    if isinstance(cache, DenseKVCache):
        return 2.0 * cache.k.shape[2] * cache.k.shape[3] * cache.k.element_size()
    if isinstance(cache, XCache):
        return (cache.x.shape[2] * cache.x.element_size()
                + cache.k_rope.shape[2] * cache.k_rope.shape[3]
                * cache.k_rope.element_size())
    if isinstance(cache, RetrievalCache):
        return (2.0 * cache.k.shape[2] * cache.k.shape[3] * cache.k.element_size()
                + cache.proxy.shape[2] * cache.proxy.shape[3])
    if isinstance(cache, CPQKVCache):
        h, d = cache.k.codes.shape[2], cache.k.codes.shape[3]
        return 2.0 * cpq_lib.cpq_bytes_per_token(cpq_cfg or CPQCfg(), h, d)
    raise TypeError(type(cache))
