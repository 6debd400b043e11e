"""Contiguous KV-cache containers (the JAX package's ``core/kv_cache.py``).
Ported so far: ``RetrievalCache``, the container of the contiguous T3
entry point ``kernels/topk_retrieval/ops.retrieval_decode``; the dense, X,
CPQ and T1+T2 containers come with the contiguous path (ROADMAP A9)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class RetrievalCache(NamedTuple):
    k: torch.Tensor            # (B, N, KV, Dh)
    v: torch.Tensor            # (B, N, KV, Dh)
    proxy: torch.Tensor        # (B, N, KV, Dp) int8 proxy codes, stored code - 128
    proxy_scale: torch.Tensor  # (B, KV, Dp) float32
    proxy_zero: torch.Tensor   # (B, KV, Dp) float32
    length: torch.Tensor       # () int32 valid tokens of every row


def init_retrieval(batch: int, n_max: int, kv: int, dh: int, cfg,
                   dtype=torch.bfloat16, device="cpu") -> RetrievalCache:
    """An empty cache: proxy scale ones, proxy zero zeros, length 0."""
    dp = cfg.proxy_dim or dh

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return RetrievalCache(
        k=z((batch, n_max, kv, dh), dtype), v=z((batch, n_max, kv, dh), dtype),
        proxy=z((batch, n_max, kv, dp), torch.int8),
        proxy_scale=torch.ones((batch, kv, dp), dtype=torch.float32, device=device),
        proxy_zero=z((batch, kv, dp), torch.float32),
        length=z((), torch.int32))
