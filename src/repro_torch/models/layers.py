"""Shared model layers of the port: norms, RoPE, sinusoidal positions, MLP
variants, token embeddings and the LM head (the JAX package's
``models/layers.py``).

The bf16 rounding points are copied from the reference: norms compute in
float32 and cast back, RoPE casts its cos/sin tables to the activation dtype
before multiplying, biases are cast to the activation dtype before the add,
and the LM head multiplies in the weight dtype before casting to float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def rms_norm_vec(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS-norm along the last axis with an explicit scale vector (qk-norm)."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin tables. positions: (T,) int -> (T, dim/2) each, float32."""
    assert dim % 2 == 0, dim
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (theta ** (ar / dim))
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, D); cos/sin: (T, D/2). Pairing: (x1, x2) halves."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def apply_rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Per-row rope for one-token decode: x (B, 1, H, D); cos/sin (B, D/2)
    from per-row positions (every request sits at its own position)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[:, None, None, :].to(x.dtype)
    s = sin[:, None, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def sinusoidal_embedding(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Absolute sinusoidal position embeddings (musicgen/opt): (T, dim)."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = torch.exp(-math.log(10000.0) * ar / half)
    ang = positions.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act in ("swiglu", "geglu"):
        gate = x @ p["w_gate"]
        # jax.nn.gelu defaults to the tanh approximation
        act = F.silu(gate) if cfg.mlp_act == "swiglu" else F.gelu(gate, approximate="tanh")
        return (act * (x @ p["w_up"])) @ p["w_down"]
    h = F.gelu(x @ p["w_in"] + p["b_in"].to(x.dtype), approximate="tanh")
    return (h @ p["w_out"] + p["b_out"].to(x.dtype)).to(x.dtype)


def embed_inputs(cfg: ModelConfig, p, tokens: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int -> (B, S, D). ``positions`` is (S,), or (B, S)
    per-row positions under continuous batching."""
    x = p["tok"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    if cfg.pos_embedding == "absolute":
        if positions.ndim == 2:
            emb = sinusoidal_embedding(positions.reshape(-1), cfg.d_model)
            x = x + emb.reshape(*positions.shape, cfg.d_model).to(x.dtype)
        else:
            x = x + sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)[None]
    return x


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["embed"]["lm_head"]
    logits = (x @ w).float()
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits
