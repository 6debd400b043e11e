"""Mesh-native paged serving (the JAX package's ``serving/sharded.py``):
attention runs where the KV lives.

Every paged arena is split over its KV-HEAD axis across the serving mesh's
``model`` axis (``distributed/cache_specs.paged_container_specs``): one
single-device container per model shard, each on its device
(``paged_cache.ShardedPagedCache``). The paged decode and chunked-prefill
attends call the single-device branch of ``decode_attend_paged`` /
``chunk_attend_paged`` once a shard, with that shard's slice of the
query/key/value heads, on that shard's device, and concatenate the
per-head outputs on the lead device. Block tables, row state and the
scheduler stay single: a logical page is one slice on every device.

One controller, a grid of devices: the reference is single-controller
SPMD (one scheduler, ``shard_map`` around the attention calls only), and
so is this. The per-shard calls are issued one after another from the one
Python process; shards that share a card run on its current stream in
turn, so the kernels' split counters (``kernels/single_query.py``, one
buffer a device) are never in use by two launches at once.

Tier routing (mirrors ``decode_attend_paged``):

  dense / T2 CPQ / tiered   head-parallel: each shard runs the same kernel
                            (B1/B2, B5/B6; or the gather path) over its
                            (KV/mp)-head arena slice.
  T3 retrieval              head-parallel too: B7's scores, the top-k and
                            the re-score are all per query head, so each
                            shard runs them over its heads and the streams
                            are the unsharded engine's. (The reference keeps
                            T3 out of its shard_map and lets GSPMD run it
                            over the same head-sharded arenas.)
  T1 X / MLA latent         the pool has no head axis: its FEATURE axis is
                            split for capacity and gathered whole on each
                            shard's device before the absorbed attend (B3/
                            B4), query heads and W_UK/W_UV slices staying
                            split.
  T1+T2 / MLA-CPQ           their code pools replicate; they keep
                            global-semantics compute: every shard writes
                            the new codes into its own copy (and its slice
                            of T1's roped keys) on its device, then the
                            attend runs once, on the lead device, over the
                            pages the rows map (``cpq_x_decode``,
                            ``cpq_x_chunk``).

Numerics: every head's math runs once, on one device, from the same
operands as on one device, so sharded and unsharded greedy decode agree
token for token at float32 (tests/test_torch_sharded_engine.py). On the
card each shard's launch is planned as the whole call's
(``single_query.Whole``), so its arithmetic is the unsharded call's bit
for bit, in bf16 too; the price is that a shard's launch fills its card
only as far as the whole call's plan fills one card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.sharding import fit_spec_to_shape
from repro_torch.kernels import single_query
from repro_torch.serving import paged_cache as pgc

MODEL_AXIS = "model"

# the dim of each per-call attention operand that splits over the model
# axis where the shard count divides it (the reference's _ARG_SPECS fitted
# to the operand's shape): the query/kv-head axis, X's feature axis
_ARG_DIMS = {"q": 2, "k_t": 2, "v_t": 2, "k_c": 2, "v_c": 2, "x_t": 2, "x_c": 2,
             "k_rope_t": 2, "k_rope_c": 2, "q_nope": 2, "q_rope": 2, "w_k_nope": 1,
             "w_v": 1}


def supports(cache) -> bool:
    """Whether a (shard's) container runs its attends per shard. T1+T2 and
    MLA-CPQ (PagedCPQXCache) keep global-semantics compute."""
    return isinstance(cache, (pgc.PagedDenseKVCache, pgc.PagedCPQKVCache,
                              pgc.PagedXCache, pgc.TieredPagedCache,
                              pgc.PagedRetrievalCache))


def container_specs(cache, mesh):
    """Fitted PartitionSpec tree of a paged container: the intent of
    ``cache_specs.paged_container_specs``, fitted to the container's
    shapes, so that placement and the per-shard calls cannot disagree.
    Non-dividing axes (MLA's shared kv_r == 1 roped key) are held whole."""
    from repro_torch.distributed.cache_specs import paged_container_specs

    return pgc.tree_map(lambda sp, a: fit_spec_to_shape(sp, tuple(a.shape), mesh),
                        paged_container_specs(cache), cache)


def shard_container(cache, mesh, fill_probe) -> pgc.ShardedPagedCache:
    """Place a paged container over ``mesh``'s model axis. ``cache`` is the
    whole container on the meta device (shapes and dtypes); ``fill_probe``
    the same container built small on the CPU, whose leaves each hold the
    one value every element of that leaf starts at (zeros, or ones for the
    CPQ level counts and the T3 proxy scales). Each shard gets its slice of
    every split leaf and the whole of every other leaf, on its device."""
    specs = container_specs(cache, mesh)
    devices = mesh.axis_devices(MODEL_AXIS)
    mp = len(devices)

    def make(i, dev):
        def leaf(spec, meta, probe):
            shape = list(meta.shape)
            d = pgc.model_dim(spec)
            if d is not None:
                shape[d] //= mp
            value = probe.reshape(-1)[0].item() if probe.numel() else 0
            return torch.full(shape, value, dtype=meta.dtype, device=dev)
        return pgc.tree_map(leaf, specs, cache, fill_probe)

    return pgc.ShardedPagedCache(shards=[make(i, d) for i, d in enumerate(devices)],
                                 specs=specs, logical=cache, devices=devices)


def _operands(kw: dict, cache: pgc.ShardedPagedCache, i: int, dev) -> dict:
    """Shard ``i``'s operands: each present operand's head (or feature)
    slice, made contiguous (the kernels take contiguous tensors), on the
    shard's device; absent ones stay None."""
    out = {}
    for k, v in kw.items():
        if v is None:
            out[k] = None
            continue
        d = _ARG_DIMS[k]
        split = v.shape[d] % len(cache.shards) == 0
        out[k] = cache.shard_of(v, d if split else None, i).to(dev).contiguous()
    return out


def _on(dev, cached: dict, value):
    """``value`` (a tensor or a RowState) on ``dev``, moved once a call."""
    if dev not in cached:
        if isinstance(value, pgc.RowState):
            cached[dev] = pgc.RowState(*(t if t is None else t.to(dev) for t in value))
        else:
            cached[dev] = value.to(dev)
    return cached[dev]


def _latent_pools(cache: pgc.ShardedPagedCache) -> dict:
    """The whole latent X pool on each shard's device: the feature shards
    concatenated once a device (shards that share a device share the
    gather), or each shard's own pool where the feature axis is whole."""
    if pgc.model_dim(cache.specs.x) is None:
        return {i: s.x for i, s in enumerate(cache.shards)}
    whole = {}
    for dev in cache.devices:
        if dev not in whole:
            whole[dev] = torch.cat([s.x.to(dev) for s in cache.shards], dim=-1)
    return {i: whole[dev] for i, dev in enumerate(cache.devices)}


def _mapped_view(cache: pgc.ShardedPagedCache, table: torch.Tensor):
    """The pages ``table`` maps of a sharded CPQ-X arena, as one container
    on the lead device: a leaf every shard holds whole gives the lead
    shard's pages, a split leaf (T1's roped keys) each shard's pages
    gathered on its device and joined on the lead; the side state is the
    lead shard's. Returns (view, the table renumbered to the view's
    pages). The view's logical rows are the arena's, and only the mapped
    pages cross devices."""
    lead = cache.devices[0]
    flat = table.reshape(-1).long()

    def pages(spec, *parts):
        d = pgc.model_dim(spec)
        if d is None:
            return parts[0][flat]
        return torch.cat([p[flat.to(p.device)].to(lead) for p in parts], dim=d)

    shards, specs = cache.shards, cache.specs
    view = pgc.PagedCPQXCache(
        x=shards[0].x._replace(codes=pages(specs.x.codes, *(s.x.codes for s in shards)),
                               level=pages(specs.x.level, *(s.x.level for s in shards))),
        k_rope=pages(specs.k_rope, *(s.k_rope for s in shards)))
    return view, torch.arange(flat.numel(), dtype=table.dtype,
                              device=lead).reshape(table.shape)


def _leaf_part(cache: pgc.ShardedPagedCache, spec, t: torch.Tensor, i: int, dev):
    """Shard ``i``'s part of an operand written into a leaf of fitted spec
    ``spec`` (the operand's dims line up with the leaf's): its slice where
    the leaf splits, all of it where every shard holds the leaf whole."""
    return cache.shard_of(t, pgc.model_dim(spec), i).to(dev).contiguous()


def cpq_x_decode(rt, cache: pgc.ShardedPagedCache, rows: pgc.RowState, x_t, k_rope_t,
                 attend):
    """A decode step over a sharded CPQ-X arena (T1+T2, MLA-CPQ), whose code
    pools every shard holds whole: each shard HQE-appends the rows' new X
    (B, 1, Dm) into its own copy and writes its slice of their roped keys
    k_rope_t (B, 1, kv_r, R), on its device, from the same inputs, so the
    copies stay equal; then ``attend(view, table)`` runs once, on the lead
    device, over the rows' mapped pages (``_mapped_view``). Returns its
    output."""
    moved: dict = {}
    for i, (shard, dev) in enumerate(zip(cache.shards, cache.devices)):
        pgc.append_cpq_x(shard, _on(dev, moved, rows), x_t.to(dev),
                         _leaf_part(cache, cache.specs.k_rope, k_rope_t, i, dev), rt.cpq)
    return attend(*_mapped_view(cache, rows.block_table))


def cpq_x_chunk(rt, cache: pgc.ShardedPagedCache, *, first: bool, slot: int,
                block_row: torch.Tensor, offset: int, valid: int, x_c, k_rope_c, attend):
    """A prompt chunk over a sharded CPQ-X arena, as ``cpq_x_decode``: each
    shard compresses the chunk's X rows x_c (1, C, Dm) into its own copy
    and writes its slice of k_rope_c (1, C, kv_r, R); then ``attend(view,
    table)`` runs once on the lead device over the slot's pages (the table
    one row). Returns its output."""
    for i, (shard, dev) in enumerate(zip(cache.shards, cache.devices)):
        pgc.chunk_cpq_x(shard, rt.cpq, slot, block_row.to(dev), offset, valid, x_c.to(dev),
                        _leaf_part(cache, cache.specs.k_rope, k_rope_c, i, dev), first)
    return attend(*_mapped_view(cache, block_row[None]))


def _lead(*ts) -> torch.device:
    return next(t.device for t in ts if t is not None)


def _whole(cache: pgc.ShardedPagedCache, i: int) -> single_query.Whole:
    """The whole call that shard ``i``'s launches are planned as: same
    splits, same arithmetic a head as unsharded. A T1 / MLA arena's roped
    key groups are split with the heads or held whole (MLA's one shared
    roped key)."""
    mp = len(cache.shards)
    rope = getattr(cache.specs, "k_rope", None)
    groups = mp if rope is not None and pgc.model_dim(rope) is not None else 1
    return single_query.Whole(mp, groups, i)


def decode_attend_sharded(rt, cache: pgc.ShardedPagedCache, rows: pgc.RowState, *,
                          q, k_t, v_t, scale: float, x_t=None, k_rope_t=None,
                          q_nope=None, q_rope=None, w_k_nope=None, w_v=None):
    """``decode_attend_paged`` over a sharded arena: each shard writes its
    slice of the new token and sweeps its head shard; the per-head outputs
    are concatenated on the lead device. Returns (out (B, 1, H, Dv), cache)."""
    if not supports(cache.shards[0]):
        new_len = rows.lengths + rows.active.to(rows.lengths.dtype)
        return cpq_x_decode(rt, cache, rows, x_t, k_rope_t, lambda view, table:
                            pgc.cpq_x_decode_attend(view, table, new_len, q_nope, q_rope,
                                                    w_k_nope, w_v, scale)), cache
    rt_local = dataclasses.replace(rt, mesh=None)
    kw = dict(q=q, k_t=k_t, v_t=v_t, x_t=x_t, k_rope_t=k_rope_t, q_nope=q_nope,
              q_rope=q_rope, w_k_nope=w_k_nope, w_v=w_v)
    moved: dict = {}
    ops = [_operands(kw, cache, i, dev) for i, dev in enumerate(cache.devices)]
    rows_of = [_on(dev, moved, rows) for dev in cache.devices]
    if isinstance(cache.shards[0], pgc.PagedXCache):
        # split latent: every shard appends its feature slice, then each
        # attends over the pool gathered whole (heads stay split)
        for shard, a, r in zip(cache.shards, ops, rows_of):
            pgc.append_x(shard, r, a["x_t"], a["k_rope_t"])
        pools = _latent_pools(cache)

        def attend(i, shard, a, r):
            return _latent_decode(rt_local, pools[i], shard, a, r, scale, _whole(cache, i))
    else:
        def attend(i, shard, a, r):
            return pgc.decode_attend_paged(rt_local, shard, r, scale=scale,
                                           whole=_whole(cache, i), **a)[0]
    outs = [attend(i, shard, a, r)
            for i, (shard, a, r) in enumerate(zip(cache.shards, ops, rows_of))]
    lead = _lead(q, q_nope)
    return torch.cat([o.to(lead) for o in outs], dim=2), cache


def _latent_decode(rt_local, x_pages, shard: pgc.PagedXCache, a: dict, r: pgc.RowState,
                   scale: float, whole: single_query.Whole) -> torch.Tensor:
    """One shard's absorbed decode over the whole latent pool: B3, or the
    gather path."""
    from repro_torch.core.decomposed_attention import decomposed_attention
    from repro_torch.kernels.decomposed_attn import ops as t1_ops

    new_len = r.lengths + r.active.to(r.lengths.dtype)
    if rt_local.paged_kernels:
        return t1_ops.paged_decomposed_decode(a["q_nope"], a["q_rope"], x_pages,
                                              shard.k_rope, r.block_table, new_len,
                                              a["w_k_nope"], a["w_v"], scale, whole=whole)
    return decomposed_attention(
        a["q_nope"], a["q_rope"], pgc.gather_pages(x_pages, r.block_table),
        pgc.gather_pages(shard.k_rope, r.block_table), a["w_k_nope"], a["w_v"], new_len,
        scale)


def chunk_attend_sharded(rt, cache: pgc.ShardedPagedCache, *, tier: int, first: bool,
                         slot: int, block_row: torch.Tensor, offset: int, valid: int,
                         q, k_c, v_c, scale: float, x_c=None, k_rope_c=None,
                         q_nope=None, q_rope=None, w_k_nope=None, w_v=None):
    """``chunk_attend_paged`` over a sharded arena: the chunk's payload lands
    in each shard's slice and its C queries attend a head shard each.
    Prompt chunks and speculative verify chunks (``spec_len + 1``) share it.
    Returns (out (1, C, H, Dv), cache)."""
    if not supports(cache.shards[0]):
        return cpq_x_chunk(
            rt, cache, first=first, slot=slot, block_row=block_row, offset=offset,
            valid=valid, x_c=x_c, k_rope_c=k_rope_c, attend=lambda view, table:
            pgc.decomposed_cpq_chunk_prefill(q_nope, q_rope, view.x, view.k_rope, table[0],
                                             slot, x_c, k_rope_c, offset, valid, w_k_nope,
                                             w_v, scale)), cache
    rt_local = dataclasses.replace(rt, mesh=None)
    kw = dict(q=q, k_c=k_c, v_c=v_c, x_c=x_c, k_rope_c=k_rope_c, q_nope=q_nope,
              q_rope=q_rope, w_k_nope=w_k_nope, w_v=w_v)
    where = dict(tier=tier, first=first, slot=slot, offset=offset, valid=valid,
                 scale=scale)
    moved: dict = {}
    ops = [_operands(kw, cache, i, dev) for i, dev in enumerate(cache.devices)]
    rows = [_on(dev, moved, block_row) for dev in cache.devices]
    if isinstance(cache.shards[0], pgc.PagedXCache):
        for shard, a, row in zip(cache.shards, ops, rows):
            pgc.write_chunk_pages(shard.x, row, offset, valid, a["x_c"][0])
            if a["k_rope_c"] is not None:
                pgc.write_chunk_pages(shard.k_rope, row, offset, valid, a["k_rope_c"][0])
        pools = _latent_pools(cache)

        def attend(i, shard, a, row):
            return _latent_chunk(rt_local, pools[i], shard, a, row, offset, valid, scale,
                                 _whole(cache, i))
    else:
        def attend(i, shard, a, row):
            return pgc.chunk_attend_paged(rt_local, shard, block_row=row, **where,
                                          whole=_whole(cache, i), **a)[0]
    outs = [attend(i, shard, a, row)
            for i, (shard, a, row) in enumerate(zip(cache.shards, ops, rows))]
    lead = _lead(q, q_nope)
    return torch.cat([o.to(lead) for o in outs], dim=2), cache


def _latent_chunk(rt_local, x_pages, shard: pgc.PagedXCache, a: dict, row, offset: int,
                  valid: int, scale: float, whole: single_query.Whole) -> torch.Tensor:
    """One shard's chunk of C queries over the whole latent pool: B4, or
    the gather path."""
    from repro_torch.core.decomposed_attention import decomposed_attention
    from repro_torch.kernels.decomposed_attn import ops as t1_ops

    if rt_local.paged_kernels:
        return t1_ops.paged_decomposed_prefill(a["q_nope"], a["q_rope"], x_pages,
                                               shard.k_rope, row, offset, valid,
                                               a["w_k_nope"], a["w_v"], scale, whole=whole)
    C = a["q_nope"].shape[1]
    return decomposed_attention(
        a["q_nope"], a["q_rope"], pgc.gather_pages(x_pages, row[None]),
        pgc.gather_pages(shard.k_rope, row[None]), a["w_k_nope"], a["w_v"],
        offset + valid, scale, query_positions=offset + torch.arange(C, device=row.device))


def validate_serve_mesh(cfg, rt, tiered: bool = False) -> int:
    """Engine-construction guard: the ``model`` axis must divide every axis
    it shards, or the per-shard GQA group structure breaks. Returns the
    model-axis size (1 = no model sharding)."""
    from repro_torch.serving.scheduler import SchedulerConfigError

    mesh = rt.mesh
    if mesh is None:
        return 1
    if MODEL_AXIS not in mesh.axis_names:
        raise SchedulerConfigError(
            f"serving mesh needs a {MODEL_AXIS!r} axis; got {mesh.axis_names}")
    mp = mesh.shape[MODEL_AXIS]
    if mp == 1:
        return 1
    kinds = set(m for m, _ in cfg.layer_kinds)
    if cfg.num_heads % mp:
        raise SchedulerConfigError(
            f"model axis {mp} must divide num_heads {cfg.num_heads}")
    head_paged = "attn" in kinds and (tiered or rt.mode in (
        "dense", "cpq", "retrieval", "decomposed"))
    if head_paged and cfg.num_kv_heads % mp:
        raise SchedulerConfigError(
            f"model axis {mp} must divide num_kv_heads {cfg.num_kv_heads}")
    # CPQ-X latent tiers (decomposed_cpq / MLA-CPQ) replicate their code
    # pools (see cache_specs._paged_cpq_specs), so only the split latent
    # pools constrain the mesh
    if "attn" in kinds and rt.mode == "decomposed" and cfg.d_model % mp:
        raise SchedulerConfigError(
            f"model axis {mp} must divide d_model {cfg.d_model} (T1 X pages)")
    if "mla" in kinds and rt.mode != "cpq" and cfg.mla is not None \
            and cfg.mla.kv_lora_rank % mp:
        raise SchedulerConfigError(
            f"model axis {mp} must divide kv_lora_rank {cfg.mla.kv_lora_rank}")
    return mp

