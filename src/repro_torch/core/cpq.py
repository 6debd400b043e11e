"""T2, Cascade Pruning-Quantization (CPQ) of the KV cache with the
Hierarchical Quantization Extension (HQE), the JAX package's
``core/cpq.py``.

Cascade order: (1) per-channel magnitude pruning, at prefill and at decode,
then (2) per-channel quantization of the surviving elements to codes
``1 .. 2^bits - 1``; code 0 is reserved for pruned elements, which
dequantize to exactly 0. Codes are stored as int8 ``code - 128``; a 4-bit
code still occupies one int8, as in the reference.

HQE: per-(level, channel) scale/zero pairs. Level 0 is fitted on the
prompt; a decode token that falls outside the current level's tolerance
range spawns a new level (the union of the old range and the token), up to
``max_levels``, so no token is ever re-quantized.

The numerics follow the reference op for op, because greedy streams depend
on the codes: ``round`` is round-half-to-even in both frameworks, and the
prune quantiles are written out as JAX computes them (``torch.quantile``
interpolates differently in the last ulp and could flip a prune mask).
The reference runs jitted, and XLA rewrites two patterns there: it contracts
``a * b + c`` into one fused multiply-add (the dequantization, the quantile
interpolation, the top of a level's range), which ``_fma`` rounds once too,
and it divides by the constant step count as a multiplication by its
float32 reciprocal, which ``_per_step`` does too.

Layout: ``x`` is (B, N, H, D), tokens on axis 1; a channel is an (H, D)
pair and statistics run over the token axis.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import CPQCfg

F32_MAX = float(np.finfo(np.float32).max)
MIN_SCALE = float(np.float32(1e-8))


class CPQTensor(NamedTuple):
    """A CPQ-compressed (B, N, H, D) cache tensor."""

    codes: torch.Tensor       # (B, N, H, D) int8 = code - 128; code 0 == pruned
    scale: torch.Tensor       # (B, L, H, D) f32 per (level, channel)
    zero: torch.Tensor        # (B, L, H, D) f32, the range minimum
    level: torch.Tensor       # (B, N, H) int32 HQE level of each token
    num_levels: torch.Tensor  # (B, H) int32 levels allocated so far (>= 1)
    prune_thr: torch.Tensor   # (B, H, D) f32 per-channel magnitude threshold


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64. (A second rounding
    can differ from a true FMA only when the float64 sum lands exactly
    between two float32 values.) b is a float32 tensor or scalar."""
    b = b.double() if isinstance(b, torch.Tensor) else float(b)
    return (a.double() * b + c.double()).float()


def _per_step(width: torch.Tensor, steps: int) -> torch.Tensor:
    """``width / steps`` as XLA computes a division by a constant: times the
    float32 reciprocal."""
    return width * float(np.float32(1.0) / np.float32(max(steps, 1)))


def _nonzero_codes(bits: int) -> int:
    # codes 1 .. 2^bits - 1 encode surviving values; code 0 == pruned
    return (1 << bits) - 1


def cpq_prune_mask(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Keep |x| >= the per-channel threshold. x (..., N, H, D), thr
    broadcastable (..., 1, H, D)."""
    return x.abs() >= thr


def _fit_level(x: torch.Tensor, mask: torch.Tensor, bits: int):
    """Per-channel range fit of the surviving elements over token axis 1.
    Returns (scale, zero), each (B, H, D)."""
    xf = x.float()
    lo = torch.where(mask, xf, F32_MAX).amin(1)
    hi = torch.where(mask, xf, -F32_MAX).amax(1)
    any_kept = mask.any(1)
    lo = torch.where(any_kept, lo, 0.0)
    hi = torch.where(any_kept, hi, 0.0)
    steps = _nonzero_codes(bits) - 1  # codes 1..2^b-1 => 2^b-2 intervals
    scale = _per_step(hi - lo, steps).clamp_min(MIN_SCALE)
    return scale, lo


def _encode(x: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
            zero: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize surviving elements to codes 1..2^b-1 (code 0 == pruned),
    stored with a -128 bias. scale/zero broadcast against x."""
    q = torch.round((x.float() - zero) / scale) + 1.0
    q = q.clamp(1, _nonzero_codes(bits))
    return (torch.where(mask, q, 0.0) - 128.0).to(torch.int8)


def decode_codes(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize: code 0 -> exactly 0; code c > 0 -> (c-1)*scale + zero,
    rounded once."""
    c = codes.float() + 128.0
    return torch.where(c == 0, 0.0, _fma(c - 1.0, scale, zero)).to(dtype)


# --------------------------------------------------------------- prefill path


def _quantile_linear(x: torch.Tensor, q: float, dim: int) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=dim)`` (method "linear") as JAX computes
    it, in float32: sort; rank ``q * (n - 1)``; interpolate between the
    floor and the ceiling ranks with weights ``1 - w`` and ``w``."""
    xs = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    rank = np.float32(q) * np.float32(n - 1)
    low, high = np.floor(rank), np.ceil(rank)
    hw = np.float32(rank - low)
    lw = np.float32(1.0) - hw
    lo_v = xs.select(dim, int(min(max(low, 0), n - 1)))
    hi_v = xs.select(dim, int(min(max(high, 0), n - 1)))
    return _fma(lo_v, lw, hi_v * float(hw))


def cpq_compress_prefill(x: torch.Tensor, cfg: CPQCfg, n_max: int) -> CPQTensor:
    """Bulk-compress prefill tokens (level 0) into an arena of ``n_max``
    tokens. x (B, N, H, D), N <= n_max, every token treated as valid."""
    B, N, H, D = x.shape
    assert N <= n_max, (N, n_max)
    thr = _quantile_linear(x.float().abs(), cfg.prune_ratio, 1)  # (B, H, D)
    mask = cpq_prune_mask(x, thr[:, None])
    scale0, zero0 = _fit_level(x, mask, cfg.bits)
    codes = _encode(x, mask, scale0[:, None], zero0[:, None], cfg.bits)

    L, dev = cfg.max_levels, x.device
    scale = torch.zeros((B, L, H, D), dtype=torch.float32, device=dev)
    zero = torch.zeros((B, L, H, D), dtype=torch.float32, device=dev)
    scale[:, 0], zero[:, 0] = scale0, zero0
    if n_max > N:
        pad = torch.zeros((B, n_max - N, H, D), dtype=torch.int8, device=dev)
        codes = torch.cat([codes, pad], dim=1)
    level = torch.zeros((B, n_max, H), dtype=torch.int32, device=dev)
    num_levels = torch.ones((B, H), dtype=torch.int32, device=dev)
    return CPQTensor(codes, scale, zero, level, num_levels, thr)


# ---------------------------------------------------------------- decode path


def _level_check(scale: torch.Tensor, zero: torch.Tensor, num_levels: torch.Tensor,
                 prune_thr: torch.Tensor, xf: torch.Tensor, cfg: CPQCfg):
    """Tokens xf (B, n, H, D) float32 against each head's current level:
    the prune mask (B, n, H, D); the level's index (B, H), scale and zero
    (B, 1, H, D) and range [lo, hi]; and whether each token, encoded next,
    would spawn a new level (B, n, H)."""
    B, _, H, D = xf.shape
    steps = _nonzero_codes(cfg.bits) - 1
    # (1) prune with the prefill-fitted per-channel thresholds
    mask = xf.abs() >= prune_thr[:, None]
    cur = (num_levels - 1).long()
    idx = cur[:, None, :, None].expand(B, 1, H, D)
    s_cur = torch.gather(scale, 1, idx)
    z_cur = torch.gather(zero, 1, idx)
    lo_cur, hi_cur = z_cur, _fma(s_cur, steps, z_cur)
    # (2) tolerance-range check over surviving channels, per head
    tol = cfg.tolerance
    width = torch.maximum(hi_cur - lo_cur, torch.tensor(MIN_SCALE, device=xf.device))
    lo_tr = lo_cur - (tol - 1.0) * width
    hi_tr = hi_cur + (tol - 1.0) * width
    outside = mask & ((xf < lo_tr) | (xf > hi_tr))
    spawn = outside.any(-1) & (num_levels < cfg.max_levels)[:, None]
    return mask, cur, s_cur, z_cur, lo_cur, hi_cur, spawn


def cpq_encode_token(scale: torch.Tensor, zero: torch.Tensor,
                     num_levels: torch.Tensor, prune_thr: torch.Tensor,
                     x_t: torch.Tensor, cfg: CPQCfg):
    """HQE-encode one decode token per row without touching a code arena.
    Side state: scale/zero (B, L, H, D), num_levels (B, H), prune_thr
    (B, H, D); x_t (B, 1, H, D).

    If, for a head, any surviving channel of the token lies outside the
    tolerance range of that head's current level, a new level is spawned
    (range = union of the old range and the token) and the token is encoded
    with it; otherwise the current level is reused.

    Returns (code_t (B,1,H,D) int8, level_t (B,H) int32, scale', zero',
    num_levels'); the inputs are not modified."""
    assert x_t.shape[1] == 1
    steps = _nonzero_codes(cfg.bits) - 1
    xf = x_t.float()
    mask, cur, s_cur, z_cur, lo_cur, hi_cur, spawn = _level_check(
        scale, zero, num_levels, prune_thr, xf, cfg)
    xf, mask, s_cur, z_cur, lo_cur, hi_cur, spawn = (              # drop the token axis
        a[:, 0] for a in (xf, mask, s_cur, z_cur, lo_cur, hi_cur, spawn))

    # (3) new-level parameters: union of the current range and the token
    lo_new = torch.minimum(lo_cur, torch.where(mask, xf, lo_cur))
    hi_new = torch.maximum(hi_cur, torch.where(mask, xf, hi_cur))
    s_new = _per_step(hi_new - lo_new, steps).clamp_min(MIN_SCALE)

    new_idx = torch.where(spawn, num_levels.long(), cur)       # (B, H)
    hit = ((torch.arange(scale.shape[1], device=xf.device)[None, :, None, None]
            == new_idx[:, None, :, None]) & spawn[:, None, :, None])
    scale2 = torch.where(hit, s_new[:, None], scale)
    zero2 = torch.where(hit, lo_new[:, None], zero)

    s_use = torch.where(spawn[..., None], s_new, s_cur)
    z_use = torch.where(spawn[..., None], lo_new, z_cur)
    code_t = _encode(x_t, mask[:, None], s_use[:, None], z_use[:, None], cfg.bits)
    num_levels2 = num_levels + spawn.to(num_levels.dtype)
    return code_t, new_idx.to(torch.int32), scale2, zero2, num_levels2


def cpq_fit_chunk(x: torch.Tensor, valid: int, cfg: CPQCfg):
    """Level-0 fit over the first ``valid`` tokens of a first prompt chunk
    (the role the whole prompt plays in ``cpq_compress_prefill``, with the
    chunk's padding kept out of every statistic). x (B, C, H, D); valid a
    host int in [1, C]. Returns (codes (B,C,H,D) int8, level (B,C,H) int32,
    scale (B,L,H,D), zero, num_levels (B,H), prune_thr (B,H,D)); the codes
    of padding positions are garbage that callers route to the null page."""
    B, C, H, D = x.shape
    xf = x.float()
    dev = x.device
    ok = (torch.arange(C, device=dev) < valid)[None, :, None, None]

    # masked per-channel magnitude quantile, linear interpolation over the
    # valid prefix: padding sorts to the end and is never indexed
    xs = torch.sort(torch.where(ok, xf.abs(), F32_MAX), dim=1).values
    pos = np.float32(cfg.prune_ratio) * np.float32(valid - 1)
    lo_i = int(np.clip(np.floor(pos), 0, C - 1))
    hi_i = int(np.clip(lo_i + 1, 0, C - 1))
    frac = np.float32(pos - np.float32(lo_i))
    q_lo = xs[:, lo_i]
    q_hi = xs[:, hi_i] if hi_i < valid else q_lo  # never interpolate into padding
    thr = _fma(q_lo, np.float32(1.0) - frac, q_hi * float(frac))     # (B, H, D)

    mask = cpq_prune_mask(x, thr[:, None]) & ok
    scale0, zero0 = _fit_level(x, mask, cfg.bits)
    codes = _encode(x, mask, scale0[:, None], zero0[:, None], cfg.bits)

    L = cfg.max_levels
    scale = torch.zeros((B, L, H, D), dtype=torch.float32, device=dev)
    zero = torch.zeros((B, L, H, D), dtype=torch.float32, device=dev)
    scale[:, 0], zero[:, 0] = scale0, zero0
    level = torch.zeros((B, C, H), dtype=torch.int32, device=dev)
    num_levels = torch.ones((B, H), dtype=torch.int32, device=dev)
    return codes, level, scale, zero, num_levels, thr


def cpq_encode_chunk(scale: torch.Tensor, zero: torch.Tensor,
                     num_levels: torch.Tensor, prune_thr: torch.Tensor,
                     x: torch.Tensor, valid: int, cfg: CPQCfg):
    """HQE-encode a continuation chunk token by token, each valid token
    with the side state as of its turn (a level spawned by token i changes
    how token i+1 is encoded), exactly as decode appends do. x (B, C, H, D);
    valid a host int. Tokens that spawn no level leave the state as it is,
    so each run of them up to the next spawning token is encoded at once,
    with the same arithmetic; a spawning token goes through
    ``cpq_encode_token``. The reference scans all C positions and discards
    the padding's updates; here the padding's codes are zero (they land on
    the null page either way). Returns (codes (B,C,H,D) int8, level
    (B,C,H) int32, scale', zero', num_levels')."""
    B, C, H, D = x.shape
    codes = torch.zeros((B, C, H, D), dtype=torch.int8, device=x.device)
    level = torch.zeros((B, C, H), dtype=torch.int32, device=x.device)
    i = 0
    while i < valid:
        xs = x[:, i:valid]
        mask, cur, s_cur, z_cur, _, _, spawn = _level_check(
            scale, zero, num_levels, prune_thr, xs.float(), cfg)
        spawning = spawn.any(2).any(0).nonzero()
        n = int(spawning[0, 0]) if len(spawning) else valid - i
        codes[:, i:i + n] = _encode(xs[:, :n], mask[:, :n], s_cur, z_cur, cfg.bits)
        level[:, i:i + n] = cur[:, None].to(torch.int32)
        i += n
        if i < valid:  # token i spawns a level in some row and head
            code_t, level[:, i], scale, zero, num_levels = cpq_encode_token(
                scale, zero, num_levels, prune_thr, x[:, i:i + 1], cfg)
            codes[:, i] = code_t[:, 0]
            i += 1
    return codes, level, scale, zero, num_levels


def cpq_append_decode(t: CPQTensor, x_t: torch.Tensor, pos: int, cfg: CPQCfg) -> CPQTensor:
    """HQE append of one token per row to a contiguous CPQ arena: x_t
    (B, 1, H, D) is encoded by ``cpq_encode_token`` and its code and level
    are written at token slot ``pos`` (a host int) in place. Returns the
    tensor with the new scale/zero tables and level counts."""
    code_t, level_t, scale, zero, num_levels = cpq_encode_token(
        t.scale, t.zero, t.num_levels, t.prune_thr, x_t, cfg)
    t.codes[:, pos] = code_t[:, 0]
    t.level[:, pos] = level_t
    return t._replace(scale=scale, zero=zero, num_levels=num_levels)


# ------------------------------------------------------------------ reference


def take_levels(table: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """Per-token rows of a (B, L, H, D) scale or zero table: level
    (B, N, H) -> (B, N, H, D). A level outside [0, L) reads 0, as the
    reference's one-hot lookup does, never out of bounds."""
    B, N, H = level.shape
    L, D = table.shape[1], table.shape[3]
    ok = (level >= 0) & (level < L)
    idx = torch.where(ok, level, 0).long()[..., None].expand(B, N, H, D)
    return torch.where(ok[..., None], torch.gather(table, 1, idx), 0.0)


def cpq_dequant(t: CPQTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Reference dequantization of the whole arena -> (B, N, H, D)."""
    return decode_codes(t.codes, take_levels(t.scale, t.level),
                        take_levels(t.zero, t.level), dtype)


# -------------------------------------------------------------- traffic model


def cpq_bytes_per_token(cfg: CPQCfg, h: int, d: int,
                        keep_frac: float | None = None) -> float:
    """Off-chip bytes per cached token under CPQ: the non-zero payload, a
    1-bit occupancy map and a level byte per (token, head); the per-(level,
    channel) scale/zero are O(L*H*D) per sequence and left out."""
    keep = (1.0 - cfg.prune_ratio) if keep_frac is None else keep_frac
    payload = keep * h * d * cfg.bits / 8.0
    bitmap = h * d / 8.0
    level = h * 1.0
    return payload + bitmap + level
