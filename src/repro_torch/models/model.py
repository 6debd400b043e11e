"""Full model of the port for continuous paged serving (the JAX package's
``models/model.py``): embed -> layers -> final norm -> LM head.

The JAX package scans over stacked block parameters and caches; here a
Python loop walks the layers, each with its own parameter dict and its own
paged arena (so no stacked copy of an arena is ever needed). Arenas are
updated in place, and the functions return them for symmetry with the
reference."""
from __future__ import annotations

import torch

from repro_torch.configs import AttentionRuntime, ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, embed_inputs, lm_logits
from repro_torch.serving.paged_cache import RowState


def _layers(cfg: ModelConfig, params, caches):
    """(kind, layer params, layer arena) for every layer, in order."""
    yield from zip(cfg.prefix_pattern, params["prefix"], caches["prefix"])
    for i in range(cfg.num_blocks):
        for j, kind in enumerate(cfg.block_pattern):
            yield kind, params["blocks"][j][i], caches["blocks"][j][i]


def init_paged_caches(cfg: ModelConfig, rt: AttentionRuntime, serving, device):
    """One paged arena per attention layer, shaped like the parameter tree:
    {"prefix": [arena, ...], "blocks": [[arena per block] per position]}."""
    return {
        "prefix": [tfm.layer_paged_cache_init(cfg, rt, k, serving, device)
                   for k in cfg.prefix_pattern],
        "blocks": [[tfm.layer_paged_cache_init(cfg, rt, k, serving, device)
                    for _ in range(cfg.num_blocks)] for k in cfg.block_pattern],
    }


def decode_step_rows(cfg: ModelConfig, rt: AttentionRuntime, params,
                     tokens: torch.Tensor, rows: RowState, caches):
    """One continuous-batching decode step, every row at its own position
    (``rows.lengths``). tokens (B, 1). Returns (logits (B, V) f32, caches)."""
    x = embed_inputs(cfg, params["embed"], tokens, rows.lengths[:, None])
    for kind, p, c in _layers(cfg, params, caches):
        x, _ = tfm.layer_decode_rows(cfg, rt, kind, p, x, rows, c)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x)[:, 0], caches


def _chunk_forward(cfg: ModelConfig, rt: AttentionRuntime, params,
                   tokens: torch.Tensor, block_row: torch.Tensor, offset: int,
                   valid: int, caches):
    """Trunk of the chunked paged forward pass: embed ``tokens`` (1, C) at
    positions ``offset + i`` and stream every layer's chunk step (writes
    land in the slot's pages through ``block_row``). Returns the pre-norm
    hidden states (1, C, D)."""
    C = tokens.shape[1]
    positions = offset + torch.arange(C, device=tokens.device)
    x = embed_inputs(cfg, params["embed"], tokens, positions)
    for kind, p, c in _layers(cfg, params, caches):
        x, _ = tfm.layer_prefill_chunk(cfg, rt, kind, p, x, positions, block_row,
                                       offset, valid, c)
    return x


def prefill_chunk_rows(cfg: ModelConfig, rt: AttentionRuntime, params,
                       tokens: torch.Tensor, block_row: torch.Tensor,
                       offset: int, valid: int, caches):
    """One chunk of a chunked paged admission: ``tokens`` (1, C) is the next
    slice of the prompt (padded to C with the edge token). Returns (logits
    (1, V) of the chunk's last valid position, caches)."""
    x = _chunk_forward(cfg, rt, params, tokens, block_row, offset, valid, caches)
    x = apply_norm(cfg, params["final_norm"], x[:, valid - 1:valid])
    return lm_logits(cfg, params, x)[:, 0], caches
