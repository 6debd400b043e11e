"""Int8 gradient compression (the JAX package's ``optim/compression.py``):
symmetric per-tensor codes and their decode. The reference's
``compressed_psum``, an error-feedback all-reduce of these codes, needs a
collective and waits for multi-device training (ROADMAP A21b)."""
from __future__ import annotations

import torch


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (codes, scale)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max() / 127.0, 1e-12)
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def decompress_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.float() * scale
