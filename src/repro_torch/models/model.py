"""Full model of the port for serving (the JAX package's ``models/model.py``):
embed -> layers -> final norm -> LM head, over contiguous arenas (``prefill``
and ``decode_step``: the static engine and one-shot admission, whose B=1
prefill ``pack_prefill_caches`` scatters into a slot's pages) and over
paged arenas (continuous batching).

The JAX package scans over stacked block parameters and caches; here a
Python loop walks the layers, each with its own parameter dict and its own
arena (so no stacked copy of an arena is ever needed). Arenas are updated
in place; the paged functions return them for symmetry with the reference,
and the contiguous ones return new containers, which carry the new
lengths."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import AttentionRuntime, CPQCfg, ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, embed_inputs, lm_logits
from repro_torch.serving import paged_cache as pgc
from repro_torch.serving.paged_cache import RowState


def per_layer(cfg: ModelConfig, tree):
    """The entries of a per-layer tree (parameters or arenas), in the order
    of ``cfg.layer_kinds``."""
    yield from tree["prefix"]
    for i in range(cfg.num_blocks):
        for j in range(len(cfg.block_pattern)):
            yield tree["blocks"][j][i]


def _layers(cfg: ModelConfig, params, caches):
    """(kind, layer params, layer arena) for every layer, in order."""
    return zip(cfg.layer_kinds, per_layer(cfg, params), per_layer(cfg, caches))


def _tree(cfg: ModelConfig, layers: list):
    """A per-layer list, in the order of ``cfg.layer_kinds``, as a tree
    shaped like the parameters."""
    n = len(cfg.prefix_pattern)
    nb, npos = cfg.num_blocks, len(cfg.block_pattern)
    return {"prefix": layers[:n],
            "blocks": [[layers[n + i * npos + j] for i in range(nb)] for j in range(npos)]}


def init_caches(cfg: ModelConfig, rt: AttentionRuntime, batch: int, n_max: int, device):
    """One contiguous (batch, n_max) arena per attention layer, shaped like
    the parameter tree."""
    return _tree(cfg, [tfm.layer_cache_init(cfg, rt, kind, batch, n_max, device)
                       for kind in cfg.layer_kinds])


def prefill(cfg: ModelConfig, rt: AttentionRuntime, params, tokens: torch.Tensor, caches,
            last_index: Optional[int] = None):
    """Prefill the prompts ``tokens`` (B, S) into contiguous arenas. Returns
    (logits (B, V) float32 of the last position, or of ``last_index`` when
    the prompt is right-padded to a bucket (one-shot admission), the new
    caches)."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = embed_inputs(cfg, params["embed"], tokens, positions)
    new = []
    for kind, p, c in _layers(cfg, params, caches):
        x, c = tfm.layer_prefill(cfg, rt, kind, p, x, positions, c)
        new.append(c)
    i = S - 1 if last_index is None else last_index
    x = apply_norm(cfg, params["final_norm"], x[:, i:i + 1])
    return lm_logits(cfg, params, x)[:, 0], _tree(cfg, new)


def decode_step(cfg: ModelConfig, rt: AttentionRuntime, params, tokens: torch.Tensor,
                pos: int, caches):
    """One decode step over contiguous arenas, every row at position ``pos``
    (a host int). tokens (B, 1). Returns (logits (B, V) float32, caches)."""
    x = embed_inputs(cfg, params["embed"], tokens, torch.tensor([pos], device=tokens.device))
    new = []
    for kind, p, c in _layers(cfg, params, caches):
        x, c = tfm.layer_decode(cfg, rt, kind, p, x, pos, c)
        new.append(c)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x)[:, 0], _tree(cfg, new)


def pack_prefill_caches(cfg: ModelConfig, rt: AttentionRuntime, paged, src,
                        block_row: torch.Tensor, slot: int):
    """Scatter a freshly prefilled B=1 contiguous cache tree ``src`` (from
    ``prefill``) into slot ``slot`` of the paged arenas, in place: one-shot
    admission."""
    for (mixer, _), pc, sc in zip(cfg.layer_kinds, per_layer(cfg, paged),
                                  per_layer(cfg, src)):
        if mixer == "attn":
            pgc.pack_into(rt.mode, pc, sc, block_row, slot)
    return paged


def init_paged_caches(cfg: ModelConfig, rt: AttentionRuntime, serving, device,
                      tiered: bool = False):
    """One paged arena per attention layer, shaped like the parameter tree:
    {"prefix": [arena, ...], "blocks": [[arena per block] per position]}.
    ``tiered`` gives every layer a dense base arena and a CPQ escalation
    arena."""
    def one(kind):
        return tfm.layer_paged_cache_init(cfg, rt, kind, serving, device, tiered)

    return {"prefix": [one(k) for k in cfg.prefix_pattern],
            "blocks": [[one(k) for _ in range(cfg.num_blocks)]
                       for k in cfg.block_pattern]}


def decode_step_rows(cfg: ModelConfig, rt: AttentionRuntime, params,
                     tokens: torch.Tensor, rows: RowState, caches):
    """One continuous-batching decode step, every row at its own position
    (``rows.lengths``). tokens (B, 1). Returns (logits (B, V) f32, caches)."""
    x = embed_inputs(cfg, params["embed"], tokens, rows.lengths[:, None])
    for kind, p, c in _layers(cfg, params, caches):
        x, _ = tfm.layer_decode_rows(cfg, rt, kind, p, x, rows, c)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x)[:, 0], caches


def _chunk_forward(cfg: ModelConfig, rt: AttentionRuntime, tier: int, first: bool,
                   params, tokens: torch.Tensor, slot: int, block_row: torch.Tensor,
                   offset: int, valid: int, caches):
    """Trunk of the chunked paged forward pass: embed ``tokens`` (1, C) at
    positions ``offset + i`` and stream every layer's chunk step (writes
    land in slot ``slot``'s pages through ``block_row``). Returns the
    pre-norm hidden states (1, C, D)."""
    C = tokens.shape[1]
    positions = offset + torch.arange(C, device=tokens.device)
    x = embed_inputs(cfg, params["embed"], tokens, positions)
    for kind, p, c in _layers(cfg, params, caches):
        x, _ = tfm.layer_prefill_chunk(cfg, rt, tier, first, kind, p, x, positions,
                                       slot, block_row, offset, valid, c)
    return x


def prefill_chunk_rows(cfg: ModelConfig, rt: AttentionRuntime, tier: int, first: bool,
                       params, tokens: torch.Tensor, slot: int,
                       block_row: torch.Tensor, offset: int, valid: int, caches):
    """One chunk of a chunked paged admission: ``tokens`` (1, C) is the next
    slice of the prompt (padded to C with the edge token); ``tier`` is the
    arm of a tiered arena the request was admitted to and ``first`` marks
    its first chunk (the CPQ tier fits its level 0 there). Returns (logits
    (1, V) of the chunk's last valid position, caches)."""
    x = _chunk_forward(cfg, rt, tier, first, params, tokens, slot, block_row, offset,
                       valid, caches)
    x = apply_norm(cfg, params["final_norm"], x[:, valid - 1:valid])
    return lm_logits(cfg, params, x)[:, 0], caches


def escalate_slot(cfg: ModelConfig, rt: AttentionRuntime, caches,
                  dense_row: torch.Tensor, cpq_row: torch.Tensor, slot: int,
                  length: int):
    """Watermark-policy tier escalation: re-compress slot ``slot``'s dense
    K/V into the CPQ arena of every tiered attention layer, in place.
    ``dense_row`` is the slot's block row before escalation, ``cpq_row`` its
    freshly allocated CPQ block row; the host frees the dense pages."""
    cpq_cfg = rt.cpq or CPQCfg()
    for kind, c in zip(cfg.layer_kinds, per_layer(cfg, caches)):
        if kind[0] != "attn" or not isinstance(c, pgc.TieredPagedCache):
            continue
        src = pgc.compress_dense_slot(
            pgc.gather_pages(c.dense.k, dense_row[None]),
            pgc.gather_pages(c.dense.v, dense_row[None]), length, cpq_cfg)
        pgc.pack_cpq(c.cpq, src, cpq_row, slot)
    return caches
