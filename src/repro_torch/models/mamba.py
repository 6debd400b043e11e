"""Mamba (S6) selective-state-space mixer of the port, for the Jamba hybrid
(the JAX package's ``models/mamba.py``).

Prefill runs the chunked selective scan: a Python loop over chunks of
``CHUNK`` tokens carries the SSM state, and within a chunk a log-depth
(Hillis-Steele) inclusive scan over the chunk axis applies the reference's
``combine`` ``(a_l, b_l), (a_r, b_r) -> (a_l a_r, b_l a_r + b_r)`` to the
discretized ``(exp(dt A), dt x B)`` pairs, where the reference calls
``associative_scan``. (A closed form through ``cumsum(dt A)`` would need
``exp(-cumsum)``, which overflows within a chunk: ``dt A`` reaches tens a
token.) Under autograd each chunk is checkpointed, as the reference remats
it. Decode is the O(1) recurrent step over the conv tail and the state.
The reference has no Pallas kernel for this mixer, so it is plain PyTorch.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import causal_conv
from repro_torch.params import ParamSpec

CHUNK = 128


def _dims(cfg: ModelConfig):
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    dt_rank = m.dt_rank or max(cfg.d_model // 16, 1)
    return d_in, dt_rank, m.d_state, m.d_conv


def mamba_defs(cfg: ModelConfig):
    d, dt = cfg.d_model, cfg.param_dtype
    d_in, dt_rank, d_state, d_conv = _dims(cfg)
    f32 = torch.float32
    return {"in_proj": ParamSpec((d, 2 * d_in), dt, ("embed", "mlp")),
            "conv_w": ParamSpec((d_conv, d_in), dt, (None, "mlp")),
            "conv_b": ParamSpec((d_in,), f32, (None,), "zeros"),
            "x_proj": ParamSpec((d_in, dt_rank + 2 * d_state), dt, ("mlp", None)),
            "dt_w": ParamSpec((dt_rank, d_in), dt, (None, "mlp")),
            "dt_bias": ParamSpec((d_in,), f32, (None,), "zeros"),
            "A_log": ParamSpec((d_in, d_state), f32, ("mlp", None), "s4d"),
            "D": ParamSpec((d_in,), f32, (None,), "ones"),
            "out_proj": ParamSpec((d_in, d), dt, ("mlp", "embed"))}


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, d_in) the last inputs of the conv
    h: torch.Tensor     # (B, d_in, d_state) float32 SSM state


def init_mamba_state(cfg: ModelConfig, batch: int, device) -> MambaState:
    d_in, _, d_state, d_conv = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, d_conv - 1, d_in), dtype=cfg.param_dtype, device=device),
        h=torch.zeros((batch, d_in, d_state), dtype=torch.float32, device=device))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold (``F.softplus``
    returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _dt_bc(cfg: ModelConfig, p, x_c: torch.Tensor):
    """The per-token SSM projections of x_c (B, T, d_in): dt (B, T, d_in),
    B and C (B, T, d_state), each float32."""
    _, dt_rank, d_state, _ = _dims(cfg)
    proj = x_c @ p["x_proj"]
    Bm = proj[..., dt_rank:dt_rank + d_state].float()
    Cm = proj[..., dt_rank + d_state:].float()
    dt = softplus((proj[..., :dt_rank] @ p["dt_w"]).float() + p["dt_bias"])
    return dt, Bm, Cm


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of ``combine`` in log2(L) steps: element
    t becomes (prod a[:t+1], the state reached from 0 after t+1 steps)."""
    k, L = 1, a.shape[1]
    while k < L:
        b = torch.cat([b[:, :k], b[:, :-k] * a[:, k:] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return a, b


def _chunk_step(A, h, xc_c, dt_c, B_c, C_c):
    """One chunk of the scan from state h: (the chunk's y, the last state)."""
    dA = torch.exp(dt_c[..., None] * A)                                # (B, L, d, N)
    dBx = (dt_c * xc_c.float())[..., None] * B_c[:, :, None, :]
    acc_a, acc_b = _scan(dA, dBx)
    h_all = acc_a * h[:, None] + acc_b
    return torch.einsum("blds,bls->bld", h_all, C_c), h_all[:, -1]


def _ssm_chunked(p, x_c, dt, Bm, Cm, h0, remat: bool = True):
    """Selective scan over chunks of CHUNK tokens, the last zero-padded: a
    padded token has dt = 0, so it carries the state through unchanged
    (exp(0) = 1, no input). Under autograd with ``remat`` (the reference's
    default) each chunk is checkpointed, so the backward recomputes one
    chunk's (B, L, d_in, d_state) tensors at a time. Returns (y (B, T, d_in)
    float32, the last state)."""
    B, T, d_in = x_c.shape
    A = -torch.exp(p["A_log"])                                         # (d_in, N)
    L = min(CHUNK, T)
    pad = (-T) % L
    if pad:
        x_c, dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (x_c, dt, Bm, Cm))
    step = _chunk_step
    if remat and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_c, dt, Bm, Cm, h0, A)):
        step = partial(checkpoint, _chunk_step, use_reentrant=False)
    h, ys = h0, []
    for s in range(0, T + pad, L):
        y, h = step(A, h, *(t[:, s:s + L] for t in (x_c, dt, Bm, Cm)))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :T], h


def mamba_forward(cfg: ModelConfig, p, x: torch.Tensor,
                  state: Optional[MambaState] = None):
    """Whole-sequence forward of x (B, T, D), continuing ``state`` where
    given. Returns (y (B, T, D), the final state)."""
    B, T, _ = x.shape
    d_in, _, _, d_conv = _dims(cfg)
    xz = x @ p["in_proj"]
    x_m, z = xz[..., :d_in], xz[..., d_in:]
    if state is None:
        state = init_mamba_state(cfg, B, x.device)
    xin = torch.cat([state.conv.to(x_m.dtype), x_m], dim=1)
    x_c = F.silu(causal_conv(xin, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm = _dt_bc(cfg, p, x_c)
    y, h_last = _ssm_chunked(p, x_c, dt, Bm, Cm, state.h)
    y = y.to(x.dtype) + x_c * p["D"].to(x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, MambaState(xin[:, -(d_conv - 1):], h_last)


def mamba_decode(cfg: ModelConfig, p, x_t: torch.Tensor, state: MambaState):
    """One-token step of x_t (B, 1, D). Returns (y (B, 1, D), the new state)."""
    d_in = _dims(cfg)[0]
    xz = x_t @ p["in_proj"]
    x_m, z = xz[..., :d_in], xz[..., d_in:]
    window = torch.cat([state.conv.to(x_m.dtype), x_m], dim=1)         # (B, d_conv, d_in)
    x_c = F.silu(causal_conv(window, p["conv_w"], p["conv_b"]))        # (B, 1, d_in)
    dt, Bm, Cm = _dt_bc(cfg, p, x_c)
    dA = torch.exp(dt[:, 0, :, None] * -torch.exp(p["A_log"]))
    dBx = (dt[:, 0] * x_c[:, 0].float())[..., None] * Bm[:, 0, None, :]
    h = dA * state.h + dBx
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0]).to(x_t.dtype)[:, None]
    y = y + x_c * p["D"].to(x_t.dtype)
    return (y * F.silu(z)) @ p["out_proj"], MambaState(window[:, 1:], h)
