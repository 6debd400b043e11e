"""T1: matrix decomposition of scaled dot-product attention (the JAX
package's ``core/decomposed_attention.py``), the gather-path oracle of the
paged T1 kernels B3/B4.

    scores = Q K^T = Q (X W_K)^T = (Q W_K^T) X^T      (score stage)
    out    = S V   = S (X W_V)   = (S X) W_V          (value stage)

The cache holds the block input X (d_model per token) instead of K and V.
RoPE does not commute with W_K, so on RoPE architectures a small slice of
each head (``rope_dims``) is roped and cached verbatim beside X, and only
the remaining content dims go through the decomposition. ``b_v`` never
enters ``out = (S X) W_V``, and ``b_k`` reaches only the roped slice, as in
the reference: on a QKV-bias model T1 differs from dense attention by the
value bias, by design. With absolute positions (``rope_dims == 0``) T1 is
exact against dense attention.

Einsums run in the arena dtype, the softmax in float32, and the weights are
cast back to the arena dtype before the value stage, as the reference does.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.attention import NEG_INF, length_mask


def _group(h: int, kv: int) -> int:
    assert h % kv == 0, (h, kv)
    return h // kv


def decomposed_query_transform(q_nope: torch.Tensor, w_k_nope: torch.Tensor) -> torch.Tensor:
    """R = Q W_K^T, the first cascaded product. q_nope (B, T, H, Dn) content
    query dims; w_k_nope (Dm, KV, Dn) content slice of W_K -> (B, T, H, Dm)."""
    B, T, H, Dn = q_nope.shape
    Dm, KV, _ = w_k_nope.shape
    qg = q_nope.reshape(B, T, KV, _group(H, KV), Dn)
    return torch.einsum("btkgd,mkd->btkgm", qg, w_k_nope).reshape(B, T, H, Dm)


def decomposed_scores(r: torch.Tensor, x_cache: torch.Tensor) -> torch.Tensor:
    """scores = R X^T. r (B, T, H, Dm), x_cache (B, N, Dm) -> (B, T, H, N)."""
    return torch.einsum("bthm,bnm->bthn", r, x_cache)


def decomposed_values(s: torch.Tensor, x_cache: torch.Tensor, w_v: torch.Tensor) -> torch.Tensor:
    """out = (S X) W_V. s (B, T, H, N) weights, x_cache (B, N, Dm), w_v
    (Dm, KV, Dh) -> (B, T, H, Dh)."""
    B, T, H, _ = s.shape
    Dm, KV, Dh = w_v.shape
    p = torch.einsum("bthn,bnm->bthm", s, x_cache)
    pg = p.reshape(B, T, KV, _group(H, KV), Dm)
    return torch.einsum("btkgm,mkd->btkgd", pg, w_v).reshape(B, T, H, Dh)


def decomposed_attention(
    q_nope: torch.Tensor,     # (B, T, H, Dn) content query
    q_rope: torch.Tensor,     # (B, T, H, R) roped query slice (R may be 0)
    x_cache: torch.Tensor,    # (B, N, Dm)
    k_rope: torch.Tensor,     # (B, N, KV_r, R) roped keys, per kv head or shared
    w_k_nope: torch.Tensor,   # (Dm, KV, Dn)
    w_v: torch.Tensor,        # (Dm, KV, Dh)
    length: Union[int, torch.Tensor],  # () or (B,) valid tokens
    scale: float,
    query_positions: Optional[torch.Tensor] = None,  # (T,) for a causal mask
) -> torch.Tensor:
    """Full T1 attention over an X cache. Returns (B, T, H, Dh)."""
    B, T, H, _ = q_nope.shape
    N = x_cache.shape[1]
    r = decomposed_query_transform(q_nope, w_k_nope)
    s = decomposed_scores(r, x_cache)
    if q_rope.shape[-1] > 0:
        kv_r = k_rope.shape[2]
        qg = q_rope.reshape(B, T, kv_r, _group(H, kv_r), q_rope.shape[-1])
        s = s + torch.einsum("btkgr,bnkr->btkgn", qg, k_rope).reshape(B, T, H, N)
    s = s.float() * scale
    ok = length_mask(length, N, s.device)[:, None, :]            # (B|1, 1, N)
    if query_positions is not None:
        pos_j = torch.arange(N, device=s.device)
        ok = ok & (pos_j[None, :] <= query_positions[:, None])[None]  # (T, N) causal
    s = torch.where(ok[:, :, None, :], s, torch.tensor(NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1).to(x_cache.dtype)
    return decomposed_values(w, x_cache, w_v)
