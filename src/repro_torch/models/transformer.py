"""Layer dispatch of the port (the JAX package's ``models/transformer.py``),
serving phases: a layer is (mixer, mlp), the mixer ``attn`` or ``mla`` and
the MLP ``dense``, ``moe`` or ``none``, over paged arenas (continuous
batching) and over contiguous arenas (the static engine and one-shot
admission). MoE's switch aux loss is computed and discarded, as the
reference's serving phases do."""
from __future__ import annotations

from repro_torch.configs import AttentionRuntime, ModelConfig
from repro_torch.models import attention_layer as attn
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import apply_mlp, apply_norm
from repro_torch.params import layer_defs


def _apply_mlp_part(cfg: ModelConfig, mlp: str, p, x):
    if mlp == "none":
        return x
    h = apply_norm(cfg, p["norm2"], x)
    if mlp == "moe":
        return x + moe_lib.apply_moe(cfg, p["mlp"], h)[0]
    return x + apply_mlp(cfg, p["mlp"], h)


def layer_paged_cache_init(cfg: ModelConfig, rt: AttentionRuntime,
                           kind: tuple[str, str], serving, device, tiered: bool = False):
    layer_defs(cfg, kind)  # raises for the layer kinds not ported yet
    if kind[0] == "mla":
        return mla_lib.init_paged_mla_cache(cfg, rt, serving, device)
    return attn.init_paged_attn_cache(cfg, rt, serving, device, tiered)


def layer_decode_rows(cfg: ModelConfig, rt: AttentionRuntime, kind: tuple[str, str],
                      p, x_t, rows, cache):
    """Continuous-batching decode of one layer: per-row positions and
    lengths via ``rows``."""
    mixer, mlp = kind
    fn = mla_lib.mla_decode_rows if mixer == "mla" else attn.attn_decode_rows
    y, cache = fn(cfg, rt, p["mixer"], apply_norm(cfg, p["norm1"], x_t), rows, cache)
    return _apply_mlp_part(cfg, mlp, p, x_t + y), cache


def layer_prefill_chunk(cfg: ModelConfig, rt: AttentionRuntime, tier: int, first: bool,
                        kind: tuple[str, str], p, x, positions, slot: int, block_row,
                        offset: int, valid: int, cache):
    """Chunked paged prefill of one layer for one request slot."""
    mixer, mlp = kind
    fn = mla_lib.mla_prefill_chunk if mixer == "mla" else attn.attn_prefill_chunk
    y, cache = fn(cfg, rt, tier, first, p["mixer"], apply_norm(cfg, p["norm1"], x), positions,
                  slot, block_row, offset, valid, cache)
    return _apply_mlp_part(cfg, mlp, p, x + y), cache


def layer_cache_init(cfg: ModelConfig, rt: AttentionRuntime, kind: tuple[str, str],
                     batch: int, n_max: int, device):
    layer_defs(cfg, kind)  # raises for the layer kinds not ported yet
    if kind[0] == "mla":
        return mla_lib.init_mla_cache(cfg, rt, batch, n_max, device)
    return attn.init_attn_cache(cfg, rt, batch, n_max, device)


def layer_prefill(cfg: ModelConfig, rt: AttentionRuntime, kind: tuple[str, str], p, x,
                  positions, cache):
    """Whole-prompt prefill of one layer into its contiguous arena."""
    mixer, mlp = kind
    fn = mla_lib.mla_prefill if mixer == "mla" else attn.attn_prefill
    y, cache = fn(cfg, rt, p["mixer"], apply_norm(cfg, p["norm1"], x), positions, cache)
    return _apply_mlp_part(cfg, mlp, p, x + y), cache


def layer_decode(cfg: ModelConfig, rt: AttentionRuntime, kind: tuple[str, str], p, x_t,
                 pos: int, cache):
    """One-token decode of one layer, every row at position ``pos``."""
    mixer, mlp = kind
    fn = mla_lib.mla_decode if mixer == "mla" else attn.attn_decode
    y, cache = fn(cfg, rt, p["mixer"], apply_norm(cfg, p["norm1"], x_t), pos, cache)
    return _apply_mlp_part(cfg, mlp, p, x_t + y), cache
