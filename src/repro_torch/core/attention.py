"""Reference attention of the port: ``dense_attention`` over explicit K/V,
the gather-path oracle the paged kernels are held against (the JAX
package's ``core/attention.py:34``)."""
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
