"""Layer dispatch of the port (the JAX package's ``models/transformer.py``),
serving phases: a layer is (mixer, mlp), the mixer ``attn``, ``xattn``,
``mla``, ``mamba``, ``mlstm`` or ``slstm`` and the MLP ``dense``, ``moe`` or
``none``, over paged arenas (continuous batching) and over contiguous
arenas (the static engine and one-shot admission). The recurrent mixers
keep an O(1) state a request instead of an arena: one row a slot, never
paged, and position-free, so the continuous decode runs their contiguous
step over every slot row (a retired slot's state is overwritten at its
next admission) and writes the new state in place. Chunked prefill has no
recurrent path (the engine admits such stacks one-shot). A cross-attention
layer keeps its request's patch K/V in a dense arena of ``num_patch_tokens``
rows (one a slot under continuous batching) whatever the mode, written at
prefill and only read by decode; it has no chunked prefill either. MoE's
switch aux loss is computed and discarded, as the reference's serving phases
do."""
from __future__ import annotations

from repro_torch.configs import AttentionRuntime, ModelConfig
from repro_torch.core import kv_cache as kvc
from repro_torch.models import attention_layer as attn
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import apply_mlp, apply_norm
from repro_torch.params import layer_defs

# mixer -> (state init, whole-sequence forward, one-token decode)
RECURRENT = {
    "mamba": (mamba_lib.init_mamba_state, mamba_lib.mamba_forward, mamba_lib.mamba_decode),
    "mlstm": (xlstm_lib.init_mlstm_state, xlstm_lib.mlstm_forward, xlstm_lib.mlstm_decode),
    "slstm": (xlstm_lib.init_slstm_state, xlstm_lib.slstm_forward, xlstm_lib.slstm_decode),
}


def _apply_mlp_part(cfg: ModelConfig, mlp: str, p, x):
    if mlp == "none":
        return x
    h = apply_norm(cfg, p["norm2"], x)
    if mlp == "moe":
        return x + moe_lib.apply_moe(cfg, p["mlp"], h)[0]
    return x + apply_mlp(cfg, p["mlp"], h)


def _patch_arena(cfg: ModelConfig, batch: int, device) -> kvc.DenseKVCache:
    """A cross-attention layer's K/V arena: ``num_patch_tokens`` rows a
    request."""
    return kvc.init_dense(batch, cfg.num_patch_tokens, cfg.num_kv_heads, cfg.head_dim,
                          cfg.param_dtype, device)


def layer_paged_cache_init(cfg: ModelConfig, rt: AttentionRuntime,
                           kind: tuple[str, str], serving, device, tiered: bool = False):
    layer_defs(cfg, kind)  # raises for an unknown layer kind
    if kind[0] in RECURRENT:  # one state row a slot
        return RECURRENT[kind[0]][0](cfg, serving.num_slots, device)
    if kind[0] == "xattn":  # static per request: one row a slot, not paged
        return _patch_arena(cfg, serving.num_slots, device)
    if kind[0] == "mla":
        return mla_lib.init_paged_mla_cache(cfg, rt, serving, device)
    return attn.init_paged_attn_cache(cfg, rt, serving, device, tiered)


def layer_decode_rows(cfg: ModelConfig, rt: AttentionRuntime, kind: tuple[str, str],
                      p, x_t, rows, cache):
    """Continuous-batching decode of one layer: per-row positions and
    lengths via ``rows``; a recurrent state is updated in place."""
    mixer, mlp = kind
    h = apply_norm(cfg, p["norm1"], x_t)
    if mixer in RECURRENT:
        y, new = RECURRENT[mixer][2](cfg, p["mixer"], h, cache)
        for dst, src in zip(cache, new):
            dst.copy_(src)
    elif mixer == "xattn":
        y, cache = attn.xattn_decode(cfg, rt, p["mixer"], h, cache)
    else:
        fn = mla_lib.mla_decode_rows if mixer == "mla" else attn.attn_decode_rows
        y, cache = fn(cfg, rt, p["mixer"], h, rows, cache)
    return _apply_mlp_part(cfg, mlp, p, x_t + y), cache


def layer_prefill_chunk(cfg: ModelConfig, rt: AttentionRuntime, tier: int, first: bool,
                        kind: tuple[str, str], p, x, positions, slot: int, block_row,
                        offset: int, valid: int, cache):
    """Chunked paged prefill of one layer for one request slot."""
    mixer, mlp = kind
    if mixer in RECURRENT or mixer == "xattn":
        raise ValueError(f"chunked prefill has no {mixer!r} path "
                         "(the engine admits such stacks one-shot)")
    fn = mla_lib.mla_prefill_chunk if mixer == "mla" else attn.attn_prefill_chunk
    y, cache = fn(cfg, rt, tier, first, p["mixer"], apply_norm(cfg, p["norm1"], x), positions,
                  slot, block_row, offset, valid, cache)
    return _apply_mlp_part(cfg, mlp, p, x + y), cache


def layer_cache_init(cfg: ModelConfig, rt: AttentionRuntime, kind: tuple[str, str],
                     batch: int, n_max: int, device):
    layer_defs(cfg, kind)  # raises for an unknown layer kind
    if kind[0] in RECURRENT:
        return RECURRENT[kind[0]][0](cfg, batch, device)
    if kind[0] == "xattn":
        return _patch_arena(cfg, batch, device)
    if kind[0] == "mla":
        return mla_lib.init_mla_cache(cfg, rt, batch, n_max, device)
    return attn.init_attn_cache(cfg, rt, batch, n_max, device)


def layer_prefill(cfg: ModelConfig, rt: AttentionRuntime, kind: tuple[str, str], p, x,
                  positions, cache, patches=None):
    """Whole-prompt prefill of one layer into its contiguous arena (a
    recurrent mixer starts from a fresh state, as the reference's does; a
    cross-attention layer attends over ``patches`` (B, P, D), the projected
    patches of the batch)."""
    mixer, mlp = kind
    h = apply_norm(cfg, p["norm1"], x)
    if mixer in RECURRENT:
        y, cache = RECURRENT[mixer][1](cfg, p["mixer"], h)
    elif mixer == "xattn":
        y, cache = attn.xattn_prefill(cfg, rt, p["mixer"], h, patches, cache)
    else:
        fn = mla_lib.mla_prefill if mixer == "mla" else attn.attn_prefill
        y, cache = fn(cfg, rt, p["mixer"], h, positions, cache)
    return _apply_mlp_part(cfg, mlp, p, x + y), cache


def layer_decode(cfg: ModelConfig, rt: AttentionRuntime, kind: tuple[str, str], p, x_t,
                 pos: int, cache):
    """One-token decode of one layer, every row at position ``pos``."""
    mixer, mlp = kind
    h = apply_norm(cfg, p["norm1"], x_t)
    if mixer in RECURRENT:
        y, cache = RECURRENT[mixer][2](cfg, p["mixer"], h, cache)
    elif mixer == "xattn":
        y, cache = attn.xattn_decode(cfg, rt, p["mixer"], h, cache)
    else:
        fn = mla_lib.mla_decode if mixer == "mla" else attn.attn_decode
        y, cache = fn(cfg, rt, p["mixer"], h, pos, cache)
    return _apply_mlp_part(cfg, mlp, p, x_t + y), cache
