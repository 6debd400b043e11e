"""Memory-efficient (flash) attention in plain PyTorch, the forward of the
JAX package's ``core/flash_ref.py``, and ``attention_auto``, which picks the
exact dense oracle for short shapes and the flash forward beyond. Both are
the plain version of the contiguous flash kernel B8
(``kernels/flash_attn``). The custom backward waits for training (ROADMAP
A20).

The forward is a two-level online softmax: an outer loop over query chunks
and an inner loop over key chunks, so the (T x S) score matrix never exists
whole. Keys past S (the chunk padding) are masked, the weights are rounded
to v's dtype before the value product, and every chunk's state stays
float32, as in the reference.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _flash_fwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    causal: bool = True, q_offset: int = 0, kv_chunk: int = 1024,
                    q_chunk: int = 512):
    """q (B, T, H, Dh), k (B, S, KV, Dh), v (B, S, KV, Dv). Returns
    (out (B, T, H, Dv) in q's dtype, lse (B, T, H) float32)."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    g = H // KV
    kc, qc = min(kv_chunk, S), min(q_chunk, T)
    dev = q.device
    outs, lses = [], []
    for q0 in range(0, T, qc):
        qb = q[:, q0:q0 + qc]
        n = qb.shape[1]
        qg = qb.reshape(B, n, KV, g, Dh)
        qpos = torch.arange(q0, q0 + n, device=dev) + q_offset
        m = torch.full((B, n, KV, g), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, n, KV, g), dtype=torch.float32, device=dev)
        o = torch.zeros((B, n, KV, g, Dv), dtype=torch.float32, device=dev)
        for k0 in range(0, S, kc):
            kb, vb = k[:, k0:k0 + kc], v[:, k0:k0 + kc]
            s = torch.einsum("btkgd,bskd->btkgs", qg, kb).float() * scale
            kpos = torch.arange(k0, k0 + kb.shape[1], device=dev)
            if causal:
                ok = kpos[None, :] <= qpos[:, None]
                s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
            m2 = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m2)
            p = torch.exp(s - m2[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum(
                "btkgs,bskd->btkgd", p.to(vb.dtype), vb).float()
            m = m2
        outs.append((o / l.clamp_min(1e-30)[..., None]).reshape(B, n, H, Dv).to(q.dtype))
        lses.append((m + torch.log(l.clamp_min(1e-30))).reshape(B, n, H))
    return torch.cat(outs, 1), torch.cat(lses, 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    causal: bool = True, q_offset: int = 0,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """The flash forward: (B, T, H, Dv) in q's dtype."""
    return _flash_fwd_impl(q, k, v, scale, causal, q_offset, kv_chunk)[0]


def attention_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   causal: bool = True, q_offset: int = 0, kv_length=None,
                   flash_threshold: int = 1024) -> torch.Tensor:
    """The exact dense oracle for short shapes (or a length mask), the flash
    forward beyond ``flash_threshold``."""
    from repro_torch.core.attention import dense_attention

    T, S = q.shape[1], k.shape[1]
    if kv_length is not None or max(T, S) <= flash_threshold:
        return dense_attention(q, k, v, scale, causal=causal, q_offset=q_offset,
                               kv_length=kv_length)
    return flash_attention(q, k, v, scale, causal, q_offset)
