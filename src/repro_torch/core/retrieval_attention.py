"""T3: attention as nearest-neighbour retrieval (the JAX package's
``core/retrieval_attention.py``), the gather-path oracle of kernel B7.

Two stages:
  (1) proxy similarity: a cheap sweep over ALL keys with per-channel affine
      int8 key codes, ``score ~ (q * scale) . (code + 128) + q . zero``;
  (2) calibrated re-scoring: exact attention over the top-K candidates
      (plus an always-attended recent window), the output rescaled by the
      proxy-estimated share of softmax mass the selected set captures.

Numerics copied from the reference as the serving engine runs it (jitted):
``fit_proxy`` divides the code range by the constant step count through its
float32 reciprocal, as XLA does; ``torch.round`` rounds half to even like
``jnp.round``; ``proxy_scores`` scales the codes before the product over
channels, in the order of the reference's three-way einsum; ``select_topk``
breaks ties by the lowest index first, as ``lax.top_k`` does (a stable
descending sort, since ``torch.topk`` promises no order among equals).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.attention import NEG_INF, length_mask

RECENT_BIAS = 1e20


# ----------------------------------------------------------- proxy encoding


def _steps(bits: int) -> int:
    return (1 << bits) - 1


def fit_proxy(k: torch.Tensor, bits: int = 8):
    """Per-channel affine code fit for keys. k (B, N, KV, Dp). Returns
    (codes int8 (B, N, KV, Dp) stored as code - 128, scale (B, KV, Dp),
    zero (B, KV, Dp))."""
    kf = k.float()
    lo = kf.amin(dim=1)
    hi = kf.amax(dim=1)
    steps = _steps(bits)
    scale = ((hi - lo) * float(np.float32(1.0) / np.float32(steps))).clamp_min(1e-8)
    codes = torch.clamp(torch.round((kf - lo[:, None]) / scale[:, None]), 0, steps)
    return (codes - 128).to(torch.int8), scale, lo


def encode_proxy(k_t: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                 bits: int = 8) -> torch.Tensor:
    """Encode new keys with existing proxy parameters. k_t (B, T, KV, Dp)."""
    codes = torch.clamp(torch.round((k_t.float() - zero[:, None]) / scale[:, None]),
                        0, _steps(bits))
    return (codes - 128).to(torch.int8)


def proxy_scores(q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor) -> torch.Tensor:
    """Approximate q . K^T from codes. q (B, T, H, Dp), codes (B, N, KV, Dp),
    scale/zero (B, KV, Dp). Returns (B, T, H, N) float32."""
    B, T, H, Dp = q.shape
    N, KV = codes.shape[1], codes.shape[2]
    qf = q.float().reshape(B, T, KV, H // KV, Dp)
    c = (codes.float() + 128.0) * scale[:, None]
    s = torch.einsum("btkgd,bnkd->btkgn", qf, c)
    s = s + torch.einsum("btkgd,bkd->btkg", qf, zero)[..., None]
    return s.reshape(B, T, H, N)


# --------------------------------------------------------------- retrieval


def _query_ok(length, n: int, query_positions: Optional[torch.Tensor], device):
    """(B|1, T|1, N) bool: written slots, and causal when the queries' own
    positions are given."""
    ok = length_mask(length, n, device)[:, None, :]
    if query_positions is not None:
        pos = torch.arange(n, device=device)
        ok = ok & (pos[None, :] <= query_positions[:, None])[None]
    return ok


def select_topk(s_proxy: torch.Tensor, length, cfg,
                query_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-K candidate indices per (B, T, H): (B, T, H, K) int64, K =
    min(top_k, N). The last ``recent_window`` positions get a +1e20 bias,
    so the local tail is always attended; masked positions score -1e30."""
    N = s_proxy.shape[-1]
    dev = s_proxy.device
    pos = torch.arange(N, device=dev)
    ok = _query_ok(length, N, query_positions, dev)
    s = torch.where(ok[:, :, None, :], s_proxy, NEG_INF)
    if query_positions is None:
        len_col = torch.as_tensor(length, device=dev).reshape(-1, 1)
        recent = (pos[None, :] >= len_col - cfg.recent_window)[:, None, :]
    else:
        recent = (pos[None, :] >= query_positions[:, None] - cfg.recent_window + 1)[None]
    s = torch.where((recent & ok)[:, :, None, :], RECENT_BIAS, s)
    k = min(cfg.top_k, N)
    idx = torch.sort(s, dim=-1, descending=True, stable=True).indices
    return idx[..., :k]


def gather_kv(k: torch.Tensor, v: torch.Tensor, idx: torch.Tensor):
    """Per-head candidates. k, v (B, N, KV, Dh); idx (B, T, H, K). Returns
    k_sel, v_sel (B, T, H, K, Dh)."""
    B, T, H, K = idx.shape
    KV = k.shape[2]
    b = torch.arange(B, device=idx.device)[:, None, None, None]
    kvh = (torch.arange(H, device=idx.device) // (H // KV))[None, None, :, None]
    return k[b, idx, kvh], v[b, idx, kvh]


def attend_selected(q: torch.Tensor, k_sel: torch.Tensor, v_sel: torch.Tensor,
                    idx: torch.Tensor, sp: torch.Tensor, length, scale: float,
                    query_positions: Optional[torch.Tensor] = None,
                    calibrate: bool = True) -> torch.Tensor:
    """Stage 2: exact attention of q (B, T, H, Dh) over its candidates
    k_sel/v_sel (B, T, H, K, Dh) at logical positions idx; sp (B, T, H, N)
    are the proxy scores the candidates were picked by, which calibration
    reads. Returns (B, T, H, Dh)."""
    dev = q.device
    s = torch.einsum("bthd,bthkd->bthk", q, k_sel).float() * scale
    # mask candidates that duplicate an invalid slot (length < K)
    ok = idx < torch.as_tensor(length, device=dev).reshape(-1, 1, 1, 1)
    if query_positions is not None:
        ok = ok & (idx <= query_positions[None, :, None, None])
    s = torch.where(ok, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    if calibrate:
        # the proxy-estimated share of the whole softmax mass the selected
        # set holds: rescale so the dropped tail is accounted for
        okn = _query_ok(length, sp.shape[-1], query_positions, dev)
        spm = torch.where(okn[:, :, None, :], sp, NEG_INF)
        m = spm.amax(dim=-1, keepdim=True)
        denom_all = torch.exp(spm - m).sum(-1)
        denom_sel = torch.exp(torch.gather(spm, -1, idx) - m).sum(-1)
        frac = torch.clamp(denom_sel / denom_all.clamp_min(1e-30), 0.0, 1.0)
        w = w * frac[..., None]
    return torch.einsum("bthk,bthkd->bthd", w.to(v_sel.dtype), v_sel)


def retrieval_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        proxy_codes: torch.Tensor, proxy_scale: torch.Tensor,
                        proxy_zero: torch.Tensor, length, cfg, scale: float,
                        query_positions: Optional[torch.Tensor] = None,
                        calibrate: bool = True) -> torch.Tensor:
    """The whole T3 pipeline over contiguous (or gathered) K/V/proxy views.
    q (B, T, H, Dh) roped; k, v (B, N, KV, Dh); proxy_codes (B, N, KV, Dp);
    length () or (B,). Returns (B, T, H, Dh)."""
    q_proxy = q if cfg.proxy_dim == 0 else q[..., :cfg.proxy_dim]
    sp = proxy_scores(q_proxy * scale, proxy_codes, proxy_scale, proxy_zero)
    idx = select_topk(sp, length, cfg, query_positions)
    k_sel, v_sel = gather_kv(k, v, idx)
    return attend_selected(q, k_sel, v_sel, idx, sp, length, scale, query_positions,
                           calibrate)
