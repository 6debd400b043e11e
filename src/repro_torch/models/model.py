"""Full model of the port (the JAX package's ``models/model.py``): embed ->
layers -> final norm -> LM head, for training (``forward_train``,
``loss_fn``) and for serving over contiguous arenas (``prefill``
and ``decode_step``: the static engine and one-shot admission, whose B=1
prefill ``pack_prefill_caches`` scatters into a slot's pages) and over
paged arenas (continuous batching): the decode step, prompt chunks, the
speculative verify chunk, tier escalation, defrag and the copy-on-write
page copy. A recurrent layer (Mamba, mLSTM, sLSTM) keeps a state of one row
a slot in place of an arena: one-shot admission packs a prefilled state
into its slot's row, and defrag, the page copy and escalation pass it by; so
do they a cross-attention layer's patch K/V, one row a slot.

Inputs (``prefill``): token prompts, an audio model's frames (B, S, D) in
place of the token lookup, and a text+patches model's patches (B, P, D),
projected through ``mm_proj`` once a prefill for every cross-attention
layer. Decode always feeds tokens (an audio model's codes).

The JAX package scans over stacked block parameters and caches; here a
Python loop walks the layers, each with its own parameter dict and its own
arena (so no stacked copy of an arena is ever needed). Arenas are updated
in place; the paged functions return them for symmetry with the reference,
and the contiguous ones return new containers, which carry the new
lengths."""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import AttentionRuntime, CPQCfg, ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, embed_inputs, lm_logits
from repro_torch.params import model_defs, spec_tree, stack_blocks, stack_defs, tree_map
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


def abstract_params(cfg: ModelConfig, stacked: bool = False):
    """The parameter tree on the ``meta`` device (shapes and dtypes,
    nothing allocated): the port's per-layer layout, or with ``stacked``
    the reference's (each block-pattern position's layers in one
    (num_blocks, ...) leaf)."""
    defs = model_defs(cfg)
    tree = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), defs)
    return stack_blocks(tree) if stacked else tree


def param_specs(cfg: ModelConfig, rules: dict, mesh_shape: dict | None = None,
                stacked: bool = False):
    """PartitionSpecs of the parameters from their logical axes
    (``params.spec_tree``): one a layer in the port's layout, or with
    ``stacked`` the reference's ``param_specs`` (a leading ``"layers"``
    axis, rule None, on each stacked block leaf)."""
    defs = model_defs(cfg)
    return spec_tree(stack_defs(defs) if stacked else defs, rules, mesh_shape)


def init_caches(cfg: ModelConfig, rt: AttentionRuntime, batch: int, n_max: int, device):
    """One contiguous (batch, n_max) arena per attention or MLA layer (MLA:
    its latent) and a fresh (batch, ...) state per recurrent layer, shaped
    like the parameter tree."""
    return _tree(cfg, [tfm.layer_cache_init(cfg, rt, kind, batch, n_max, device)
                       for kind in cfg.layer_kinds])


def check_inputs(cfg: ModelConfig) -> None:
    """Raise for a stack whose cross-attention layers would find no patches
    in its inputs (no published configuration has one)."""
    if cfg.input_kind != "text+patches" and any(m == "xattn" for m, _ in cfg.layer_kinds):
        raise ValueError(f"{cfg.name}: its xattn layers attend over patches, which "
                         f"input_kind={cfg.input_kind!r} does not carry (they need "
                         "input_kind='text+patches' and batch['patches'])")


def _patches(cfg: ModelConfig, params, batch: dict) -> Optional[torch.Tensor]:
    """The batch's patches (B, P, D) projected through ``mm_proj`` (a
    text+patches model), else None."""
    check_inputs(cfg)
    if cfg.input_kind != "text+patches":
        return None
    if "patches" not in batch:
        raise ValueError(f"{cfg.name} takes text+patches: the batch has no 'patches'")
    return batch["patches"].to(cfg.param_dtype) @ params["embed"]["mm_proj"]


# -------------------------------------------------------------------- train


def _barrier(tree):
    """The identity. The reference's ``_barrier`` is an optimization
    barrier that keeps XLA's partitioner from gathering the whole stacked
    block weights out of its scan; it pins sharding only, and the port
    keeps one tensor a layer on one device, so there is nothing to pin."""
    return tree


def forward_train(cfg: ModelConfig, params, batch: dict, remat: bool = True):
    """Teacher-forced forward of a training batch (the reference's dict:
    ``"tokens"`` (B, S) or ``"frames"`` (B, S, D), and ``"patches"`` for a
    text+patches model). Returns (logits (B, S, V) float32, the MoE aux
    loss summed over the layers, a float32 scalar).

    With ``remat`` the reference's two checkpoint levels: each block (one
    layer of every block-pattern position) is checkpointed, so the backward
    keeps only each block's input, and inside it each layer too when the
    pattern has more than one; the prefix layers are not."""
    S = (batch["tokens"] if "tokens" in batch else batch["frames"]).shape[1]
    positions = torch.arange(S, device=params["final_norm"]["scale"].device)
    x = embed_inputs(cfg, params["embed"], batch, positions)
    patches = _patches(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in zip(cfg.prefix_pattern, params["prefix"]):
        x, a = tfm.layer_train(cfg, kind, p, x, positions, patches)
        aux = aux + a

    def one_layer(kind):
        def f(x, p):
            return tfm.layer_train(cfg, kind, p, x, positions, patches)
        if remat and len(cfg.block_pattern) > 1:
            return partial(checkpoint, f, use_reentrant=False)
        return f

    layer_fns = [one_layer(k) for k in cfg.block_pattern]

    def body(x, block_params):
        block_params = _barrier(block_params)
        a_blk = torch.zeros((), dtype=torch.float32, device=x.device)
        for f, p in zip(layer_fns, block_params):
            x, a = f(x, p)
            a_blk = a_blk + a
        return x, a_blk

    if remat:
        body = partial(checkpoint, body, use_reentrant=False)
    for i in range(cfg.num_blocks):
        x, a = body(x, [b[i] for b in params["blocks"]])
        aux = aux + a
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params, batch: dict, remat: bool = True,
            aux_weight: float = 0.01):
    """Next-token cross entropy plus ``aux_weight`` times the MoE aux loss.
    ``batch["labels"]`` (B, S) int, -1 = padding. Returns (loss, {"nll",
    "aux"})."""
    logits, aux = forward_train(cfg, params, batch, remat)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = batch["labels"][:, 1:]
    ok = tgt >= 0
    nll = -torch.gather(logp, -1, tgt.clamp_min(0).long()[..., None])[..., 0]
    loss = torch.sum(nll * ok) / ok.sum().clamp_min(1)
    return loss + aux_weight * aux, {"nll": loss, "aux": aux}


# ------------------------------------------------------------------ serving


def prefill(cfg: ModelConfig, rt: AttentionRuntime, params, batch, caches,
            last_index: Optional[int] = None):
    """Prefill a batch of prompts into contiguous arenas. ``batch`` is the
    reference's dict: ``"tokens"`` (B, S) or an audio model's ``"frames"``
    (B, S, D), and a text+patches model's ``"patches"`` (B, P, D). Returns
    (logits (B, V) float32 of the last position, or of ``last_index`` when
    the prompt is right-padded to a bucket (one-shot admission), the new
    caches)."""
    prompt = batch["tokens"] if "tokens" in batch else batch["frames"]
    S = prompt.shape[1]
    positions = torch.arange(S, device=prompt.device)
    x = embed_inputs(cfg, params["embed"], batch, positions)
    patches = _patches(cfg, params, batch)
    new = []
    for kind, p, c in _layers(cfg, params, caches):
        x, c = tfm.layer_prefill(cfg, rt, kind, p, x, positions, c, patches)
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
    admission. A recurrent state's every leaf is written to row ``slot``; so
    is a cross-attention layer's patch K/V, whose length becomes the
    prefill's."""
    for (mixer, _), pc, sc in zip(cfg.layer_kinds, per_layer(cfg, paged), per_layer(cfg, src)):
        if mixer in tfm.RECURRENT:
            for dst, s in zip(pc, sc):
                dst[slot].copy_(s[0])
        elif mixer == "xattn":
            pc.k[slot].copy_(sc.k[0])
            pc.v[slot].copy_(sc.v[0])
            pc.length.copy_(sc.length)
        else:
            pgc.pack_into(rt.mode, pc, sc, block_row, slot)
    return paged


def init_paged_caches(cfg: ModelConfig, rt: AttentionRuntime, serving, device,
                      tiered: bool = False):
    """One paged arena per attention or MLA layer and a state of
    ``num_slots`` rows per recurrent layer, shaped like the parameter tree:
    {"prefix": [arena, ...], "blocks": [[arena per block] per position]}.
    ``tiered`` gives every layer a dense base arena and a CPQ escalation
    arena. Under a serving mesh (``rt.mesh``) every arena is placed over
    the mesh's model axis (``serving/sharded.shard_container``: a
    ``ShardedPagedCache`` of one container a shard, each on its device);
    recurrent and cross-attention state stays whole on ``device``, where
    the layers' projections run."""
    if rt.mesh is not None:
        import dataclasses

        from repro_torch.serving import sharded

        small = dataclasses.replace(serving, num_pages=2, num_slots=1, escalated_pages=2)

    def one(kind):
        if rt.mesh is not None and kind[0] in ("attn", "mla"):
            meta = tfm.layer_paged_cache_init(cfg, rt, kind, serving, "meta", tiered)
            probe = tfm.layer_paged_cache_init(cfg, rt, kind, small, "cpu", tiered)
            return sharded.shard_container(meta, rt.mesh, probe)
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


def verify_chunk_rows(cfg: ModelConfig, rt: AttentionRuntime, tier: int, first: bool,
                      params, tokens: torch.Tensor, slot: int,
                      block_row: torch.Tensor, offset: int, valid: int, caches):
    """Speculative verification chunk: the chunked paged forward pass of
    ``prefill_chunk_rows`` (writes land in the draft's scratch pages through
    ``block_row``) with the logits of every position kept: position
    ``offset + i`` scores candidate ``i + 1``. Returns (logits (1, C, V)
    f32, caches); rows at ``i >= valid`` are padding."""
    x = _chunk_forward(cfg, rt, tier, first, params, tokens, slot, block_row, offset,
                       valid, caches)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x), caches


def _attn_arenas(cfg: ModelConfig, caches):
    """The arenas of the attention and MLA layers, in layer order."""
    return (c for (mixer, _), c in zip(cfg.layer_kinds, per_layer(cfg, caches))
            if mixer in ("attn", "mla"))


def defrag_caches(cfg: ModelConfig, rt: AttentionRuntime, caches, perm: torch.Tensor):
    """Apply a scheduler defrag permutation (``Scheduler.plan_defrag``) to
    every attention and MLA layer's base arena pools, in place: mapped
    pages move onto the lowest physical ids."""
    for c in _attn_arenas(cfg, caches):
        pgc.permute_pool(c, perm)
    return caches


def copy_page_caches(cfg: ModelConfig, rt: AttentionRuntime, caches, src: int, dst: int):
    """Copy physical page ``src -> dst`` in every attention and MLA layer's
    base arena pools, in place: the copy-on-write split behind prefix sharing
    (a tiered arena copies its dense arm)."""
    for c in _attn_arenas(cfg, caches):
        pgc.copy_page(c, src, dst)
    return caches


def escalate_slot(cfg: ModelConfig, rt: AttentionRuntime, caches,
                  dense_row: torch.Tensor, cpq_row: torch.Tensor, slot: int,
                  length: int):
    """Watermark-policy tier escalation: re-compress slot ``slot``'s dense
    K/V into the CPQ arena of every tiered attention layer, in place.
    ``dense_row`` is the slot's block row before escalation, ``cpq_row`` its
    freshly allocated CPQ block row; the host frees the dense pages."""
    cpq_cfg = rt.cpq or CPQCfg()
    for kind, c in zip(cfg.layer_kinds, per_layer(cfg, caches)):
        if kind[0] != "attn" or not isinstance(pgc.logical_of(c), pgc.TieredPagedCache):
            continue
        # a sharded arena re-compresses each shard's heads on its device:
        # the CPQ fit is per (kv head, channel), so the shards' codes are
        # the slices of the whole arena's
        shards = c.shards if isinstance(c, pgc.ShardedPagedCache) else [c]
        for shard in shards:
            dev = shard.dense.k.device
            d_row, c_row = dense_row.to(dev), cpq_row.to(dev)
            src = pgc.compress_dense_slot(
                pgc.gather_pages(shard.dense.k, d_row[None]),
                pgc.gather_pages(shard.dense.v, d_row[None]), length, cpq_cfg)
            pgc.pack_cpq(shard.cpq, src, c_row, slot)
    return caches
