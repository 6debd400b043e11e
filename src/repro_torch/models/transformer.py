"""Layer dispatch of the port (the JAX package's ``models/transformer.py``),
serving phases for ``("attn", "dense")`` layers: over paged arenas
(continuous batching) and over contiguous arenas (the static engine and
one-shot admission)."""
from __future__ import annotations

from repro_torch.configs import AttentionRuntime, ModelConfig
from repro_torch.models import attention_layer as attn
from repro_torch.models.layers import apply_mlp, apply_norm
from repro_torch.params import layer_defs


def _apply_mlp_part(cfg: ModelConfig, mlp: str, p, x):
    if mlp == "none":
        return x
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))


def layer_paged_cache_init(cfg: ModelConfig, rt: AttentionRuntime,
                           kind: tuple[str, str], serving, device, tiered: bool = False):
    layer_defs(cfg, kind)  # raises for the layer kinds not ported yet
    return attn.init_paged_attn_cache(cfg, rt, serving, device, tiered)


def layer_decode_rows(cfg: ModelConfig, rt: AttentionRuntime, kind: tuple[str, str],
                      p, x_t, rows, cache):
    """Continuous-batching decode of one layer: per-row positions and
    lengths via ``rows``."""
    _, mlp = kind
    y, cache = attn.attn_decode_rows(cfg, rt, p["mixer"], apply_norm(cfg, p["norm1"], x_t),
                                     rows, cache)
    return _apply_mlp_part(cfg, mlp, p, x_t + y), cache


def layer_prefill_chunk(cfg: ModelConfig, rt: AttentionRuntime, tier: int, first: bool,
                        kind: tuple[str, str], p, x, positions, slot: int, block_row,
                        offset: int, valid: int, cache):
    """Chunked paged prefill of one layer for one request slot."""
    _, mlp = kind
    y, cache = attn.attn_prefill_chunk(cfg, rt, tier, first, p["mixer"],
                                       apply_norm(cfg, p["norm1"], x), positions, slot,
                                       block_row, offset, valid, cache)
    return _apply_mlp_part(cfg, mlp, p, x + y), cache


def layer_cache_init(cfg: ModelConfig, rt: AttentionRuntime, kind: tuple[str, str],
                     batch: int, n_max: int, device):
    layer_defs(cfg, kind)  # raises for the layer kinds not ported yet
    return attn.init_attn_cache(cfg, rt, batch, n_max, device)


def layer_prefill(cfg: ModelConfig, rt: AttentionRuntime, kind: tuple[str, str], p, x,
                  positions, cache):
    """Whole-prompt prefill of one layer into its contiguous arena."""
    _, mlp = kind
    y, cache = attn.attn_prefill(cfg, rt, p["mixer"], apply_norm(cfg, p["norm1"], x),
                                 positions, cache)
    return _apply_mlp_part(cfg, mlp, p, x + y), cache


def layer_decode(cfg: ModelConfig, rt: AttentionRuntime, kind: tuple[str, str], p, x_t,
                 pos: int, cache):
    """One-token decode of one layer, every row at position ``pos``."""
    _, mlp = kind
    y, cache = attn.attn_decode(cfg, rt, p["mixer"], apply_norm(cfg, p["norm1"], x_t), pos,
                                cache)
    return _apply_mlp_part(cfg, mlp, p, x_t + y), cache
