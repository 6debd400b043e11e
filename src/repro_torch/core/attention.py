"""Reference attention of the port, the gather-path oracles the paged
kernels are held against (the JAX package's ``core/attention.py``):
``dense_attention`` over explicit K/V (``:34``) and
``cpq_chunked_decode_attention`` over CPQ codes (``:68``)."""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def length_mask(length, n: int, device) -> torch.Tensor:
    """(B|1, N) bool mask of written cache slots. ``length`` is an int, a ()
    tensor, or (B,) per-row lengths."""
    length = torch.as_tensor(length, device=device).reshape(-1, 1)
    return torch.arange(n, device=device)[None, :] < length


def dense_attention(
    q: torch.Tensor,              # (B, T, H, Dh)
    k: torch.Tensor,              # (B, S, KV, Dh)
    v: torch.Tensor,              # (B, S, KV, Dv)
    scale: float,
    causal: bool = True,
    q_offset: Union[int, torch.Tensor] = 0,   # absolute position of q[0]
    kv_length: Optional[Union[int, torch.Tensor]] = None,  # () or (B,)
    logit_bias: Optional[torch.Tensor] = None,  # broadcastable to (B, T, H, S)
) -> torch.Tensor:
    """Reference GQA scaled dot-product attention. Like the reference, it
    rounds the softmax weights to ``v.dtype`` before the weighted sum."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = H // KV
    dev = q.device
    qg = q.reshape(B, T, KV, g, Dh)
    s = torch.einsum("btkgd,bskd->btkgs", qg, k).float() * scale
    s = s.reshape(B, T, H, S)
    if logit_bias is not None:
        s = s + logit_bias

    pos_j = torch.arange(S, device=dev)
    ok = torch.ones((1, T, S), dtype=torch.bool, device=dev)
    if causal:
        pos_i = torch.arange(T, device=dev) + q_offset
        ok = ok & (pos_j[None, :] <= pos_i[:, None])[None]
    if kv_length is not None:
        ok = ok & length_mask(kv_length, S, dev)[:, None, :]
    s = torch.where(ok[:, :, None, :], s, torch.tensor(NEG_INF, device=dev))
    w = torch.softmax(s, dim=-1)
    wg = w.reshape(B, T, KV, g, S).to(v.dtype)
    return torch.einsum("btkgs,bskd->btkgd", wg, v).reshape(B, T, H, v.shape[-1])


def cpq_chunked_decode_attention(q: torch.Tensor, kt, vt, length, scale: float,
                                 chunk: int = 2048) -> torch.Tensor:
    """T2 decode attention that dequantizes CPQ codes chunk by chunk inside
    an online softmax. kt/vt are ``CPQTensor`` views (codes (B, N, KV, D),
    level (B, N, KV), scale/zero (B, L, KV, D)); ``length`` is () or (B,).
    Each dequantized chunk is rounded to bf16, as in the reference, and a
    level outside [0, L) reads scale = zero = 0 (its one-hot lookup).
    q (B, 1, H, Dh) -> (B, 1, H, Dv) in q's dtype."""
    from repro_torch.core.cpq import decode_codes, take_levels

    B, _, H, Dh = q.shape
    N, KV = kt.codes.shape[1], kt.codes.shape[2]
    Dv = vt.codes.shape[3]
    g = H // KV
    c = min(chunk, N)
    dev = q.device
    qg = q[:, 0].reshape(B, KV, g, Dh).float()
    length = torch.as_tensor(length, device=dev).reshape(-1, 1)

    def dequant(t, lo, hi):
        lvl = t.level[:, lo:hi]
        return decode_codes(t.codes[:, lo:hi], take_levels(t.scale, lvl),
                            take_levels(t.zero, lvl), torch.bfloat16)

    m = torch.full((B, KV, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, g), dtype=torch.float32, device=dev)
    o = torch.zeros((B, KV, g, Dv), dtype=torch.float32, device=dev)
    for lo in range(0, N, c):
        hi = min(lo + c, N)
        k_hat = dequant(kt, lo, hi)                                  # (B, c, KV, Dh)
        s = torch.einsum("bkgd,bckd->bkgc", qg, k_hat.float()) * scale
        live = torch.arange(lo, hi, device=dev)[None, :] < length    # (B|1, c)
        s = torch.where(live[:, None, None, :], s, NEG_INF)
        m2 = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m2)
        p = torch.exp(s - m2[..., None])
        l = l * corr + p.sum(-1)
        v_hat = dequant(vt, lo, hi)
        o = o * corr[..., None] + torch.einsum("bkgc,bckd->bkgd", p, v_hat.float())
        m = m2
    out = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, Dv).to(q.dtype)
