"""Multi-head latent attention (DeepSeek-V2) of the port (the JAX package's
``models/mla.py``): training through the naive path (``mla_train``), and the
serving phases as an instance of T1's decomposition.

MLA caches a learned latent ``c_kv = Norm(X W_DKV)`` (``kv_lora_rank`` wide)
and one roped key of ``qk_rope_head_dim`` shared by every head, instead of
per-head K/V. Decode uses the absorbed form

    score_h = (q_nope_h W_UK_h^T) c^T + q_rope k_rope^T
    out_h   = (S c) W_UV_h

which is T1's ``(Q W_K^T) X^T`` / ``(S X) W_V`` with X the latent: so the
latent lives in T1's containers (X := c_kv, one roped group shared by the H
heads) and decode runs T1's kernels with ``w_k_nope = W_UK (L, H, Dn)``,
KV = H: B3 over the latent pages, B9 over a contiguous latent, and chunked
prefill B4. A whole prompt is attended densely (per-head K/V materialized),
through B8 with ``rt.paged_kernels``. Mode ``cpq`` keeps the latent in CPQ
codes (T2 on the latent); that tier reads it through the reference's
dequantize-and-gather path, which has no kernel. Every other mode caches
the latent itself.
"""
from __future__ import annotations

import torch

from repro_torch.configs import AttentionRuntime, ModelConfig
from repro_torch.core import cpq as cpq_lib
from repro_torch.core import kv_cache as kvc
from repro_torch.core.decomposed_attention import decomposed_attention
from repro_torch.core.flash_ref import attention_auto
from repro_torch.kernels.decomposed_attn import ops as t1_ops
from repro_torch.models.attention_layer import _prefill_attention
from repro_torch.models.layers import apply_rope, apply_rope_rows, rms_norm_vec, rope_tables
from repro_torch.params import ParamSpec
from repro_torch.serving import paged_cache as pgc


def _dims(cfg: ModelConfig):
    m = cfg.mla
    return m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim


def mla_defs(cfg: ModelConfig):
    d, H = cfg.d_model, cfg.num_heads
    L, Dn, Dr, Dv = _dims(cfg)
    dt = cfg.param_dtype
    return {"wq": ParamSpec((d, H * (Dn + Dr)), dt, ("embed", "heads")),
            "wdkv": ParamSpec((d, L + Dr), dt, ("embed", None)),
            "kv_norm": ParamSpec((L,), torch.float32, (None,), "ones"),
            "wuk": ParamSpec((L, H, Dn), dt, (None, "heads", None)),
            "wuv": ParamSpec((L, H, Dv), dt, (None, "heads", None)),
            "wo": ParamSpec((H * Dv, d), dt, ("heads", "embed"))}


def _project(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, T, D) -> q_nope (B, T, H, Dn), q_rope (B, T, H, Dr) unroped,
    the normed latent c (B, T, L) and the unroped shared key (B, T, 1, Dr)."""
    B, T, _ = x.shape
    L, Dn, Dr, _ = _dims(cfg)
    q = (x @ p["wq"]).reshape(B, T, cfg.num_heads, Dn + Dr)
    kv = x @ p["wdkv"]
    return q[..., :Dn], q[..., Dn:], rms_norm_vec(kv[..., :L], p["kv_norm"]), kv[..., None, L:]


def _q_ckv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    """The roped query slices and the latent of a prompt or chunk at
    ``positions`` (T,)."""
    q_nope, q_rope, c, k_rope = _project(cfg, p, x)
    cos, sin = rope_tables(positions, _dims(cfg)[2], cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin), c, apply_rope(k_rope, cos, sin)


def _q_ckv_rows(cfg: ModelConfig, p, x_t: torch.Tensor, positions: torch.Tensor):
    """``_q_ckv`` of one token per row, each at its own position (B,)."""
    q_nope, q_rope, c, k_rope = _project(cfg, p, x_t)
    cos, sin = rope_tables(positions, _dims(cfg)[2], cfg.rope_theta)
    return q_nope, apply_rope_rows(q_rope, cos, sin), c, apply_rope_rows(k_rope, cos, sin)


def _scale(cfg: ModelConfig) -> float:
    _, Dn, Dr, _ = _dims(cfg)
    return (Dn + Dr) ** -0.5


def _out(p, o: torch.Tensor) -> torch.Tensor:
    B, T = o.shape[:2]
    return o.reshape(B, T, -1) @ p["wo"]


# ----------------------------------------------------------------- train


def mla_train(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The naive path, not absorbed: per-head K/V made from the latent and
    causal attention over them (the dense oracle up to 1024 positions,
    flash attention beyond, Dh = Dn + Dr and Dv apart)."""
    B, T, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope, c, k_rope = _q_ckv(cfg, p, x, positions)
    k_nope = torch.einsum("btl,lhd->bthd", c, p["wuk"])
    v = torch.einsum("btl,lhd->bthd", c, p["wuv"])
    k = torch.cat([k_nope, k_rope.expand(B, T, H, k_rope.shape[-1])], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return _out(p, attention_auto(q, k, v, _scale(cfg), causal=True))


# ------------------------------------------------------------ contiguous


def init_mla_cache(cfg: ModelConfig, rt: AttentionRuntime, batch: int, n_max: int, device):
    L, _, Dr, _ = _dims(cfg)
    if rt.mode == "cpq":
        return kvc.init_cpq_x(batch, n_max, L, 1, Dr, rt.cpq, cfg.param_dtype, device)
    return kvc.init_x(batch, n_max, L, 1, Dr, cfg.param_dtype, device)


def mla_prefill(cfg: ModelConfig, rt: AttentionRuntime, p, x: torch.Tensor,
                positions: torch.Tensor, cache):
    """Whole-prompt prefill: dense causal attention over per-head K/V made
    from the latent (B8 or its plain version), and the latent (or its CPQ
    codes) and the shared roped key written at 0 .. S-1."""
    B, T, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope, c, k_rope = _q_ckv(cfg, p, x, positions)
    k_nope = torch.einsum("btl,lhd->bthd", c, p["wuk"])
    v = torch.einsum("btl,lhd->bthd", c, p["wuv"])
    k = torch.cat([k_nope, k_rope.expand(B, T, H, k_rope.shape[-1])], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = _prefill_attention(rt, q, k, v.contiguous(), _scale(cfg))
    n = kvc.host_length(T)
    kvc.append_tokens(cache.k_rope, k_rope, 0)
    if isinstance(cache, kvc.CPQXCache):
        xt = cpq_lib.cpq_compress_prefill(c[:, :, None, :], rt.cpq, cache.x.codes.shape[1])
        cache = kvc.CPQXCache(xt, cache.k_rope, n)
    else:
        cache = kvc.XCache(kvc.append_tokens(cache.x, c, 0), cache.k_rope, n)
    return _out(p, o), cache


def mla_decode(cfg: ModelConfig, rt: AttentionRuntime, p, x_t: torch.Tensor, pos: int,
               cache):
    """Absorbed decode over a contiguous latent, every row at position
    ``pos`` (a host int): B9 with ``rt.paged_kernels`` over the latent, the
    plain decomposition otherwise; a CPQ latent is dequantized whole, as
    the reference does."""
    q_nope, q_rope, c_t, k_rope_t = _q_ckv(cfg, p, x_t,
                                           torch.tensor([pos], device=x_t.device))
    new_len = pos + 1
    n = kvc.host_length(new_len)
    kvc.append_tokens(cache.k_rope, k_rope_t, pos)
    if isinstance(cache, kvc.CPQXCache):
        xt = cpq_lib.cpq_append_decode(cache.x, c_t[:, :, None, :], pos, rt.cpq)
        cache = kvc.CPQXCache(xt, cache.k_rope, n)
        c_arena = cpq_lib.cpq_dequant(xt, x_t.dtype)[:, :, 0, :]
    else:
        cache = kvc.XCache(kvc.append_tokens(cache.x, c_t, pos), cache.k_rope, n)
        if rt.paged_kernels:
            o = t1_ops.decomposed_decode(q_nope, q_rope, cache.x, cache.k_rope, new_len,
                                         p["wuk"], p["wuv"], _scale(cfg))
            return _out(p, o), cache
        c_arena = cache.x
    o = decomposed_attention(q_nope, q_rope, c_arena, cache.k_rope, p["wuk"], p["wuv"],
                             new_len, _scale(cfg))
    return _out(p, o), cache


# ----------------------------------------------------------------- paged


def init_paged_mla_cache(cfg: ModelConfig, rt: AttentionRuntime, serving, device):
    """Paged latent arena: X pages hold c_kv, k_rope pages the shared roped
    key (CPQ code pages of the latent in mode cpq)."""
    L, _, Dr, _ = _dims(cfg)
    if rt.mode == "cpq":
        return pgc.init_paged_cpq_x(serving.num_pages, serving.page_size, serving.num_slots,
                                    L, 1, Dr, rt.cpq, cfg.param_dtype, device)
    return pgc.init_paged_x(serving.num_pages, serving.page_size, L, 1, Dr,
                            cfg.param_dtype, device)


def mla_prefill_chunk(cfg: ModelConfig, rt: AttentionRuntime, tier: int, first: bool, p,
                      x: torch.Tensor, positions: torch.Tensor, slot: int, block_row,
                      offset: int, valid: int, cache):
    """One prompt chunk over the paged latent: its latent rows (and shared
    roped keys) go straight into the slot's pages and its queries run the
    absorbed decomposition over the slot's pages [0, offset + valid): B4
    with ``rt.paged_kernels``, the gather path otherwise. A CPQ latent
    compresses the chunk as it goes (level-0 fit on the ``first`` chunk)
    and attends through ``decomposed_cpq_chunk_prefill``."""
    q_nope, q_rope, c, k_rope = _q_ckv(cfg, p, x, positions)
    wuk, wuv, scale = p["wuk"], p["wuv"], _scale(cfg)

    def cpq_attend(latent, row):
        return pgc.decomposed_cpq_chunk_prefill(q_nope, q_rope, latent.x, latent.k_rope, row,
                                                slot, c, k_rope, offset, valid, wuk, wuv,
                                                scale)

    if isinstance(cache, pgc.ShardedPagedCache) and isinstance(cache.logical,
                                                               pgc.PagedCPQXCache):
        # a CPQ latent under a mesh keeps global-semantics compute over its
        # replicated code pools (serving/sharded.py)
        from repro_torch.serving import sharded

        o = sharded.cpq_x_chunk(rt, cache, first=first, slot=slot, block_row=block_row,
                                offset=offset, valid=valid, x_c=c, k_rope_c=k_rope,
                                attend=lambda view, table: cpq_attend(view, table[0]))
        return _out(p, o), cache
    if isinstance(cache, pgc.ShardedPagedCache):
        # mesh-native: query heads and W_UK/W_UV split over "model", the
        # latent pages split on their feature axis and gathered whole on
        # each shard's device (serving/sharded.py)
        from repro_torch.serving import sharded

        o, cache = sharded.chunk_attend_sharded(
            rt, cache, tier=tier, first=first, slot=slot, block_row=block_row,
            offset=offset, valid=valid, q=None, k_c=None, v_c=None, x_c=c,
            k_rope_c=k_rope, q_nope=q_nope, q_rope=q_rope, w_k_nope=wuk, w_v=wuv,
            scale=scale)
        return _out(p, o), cache
    if isinstance(cache, pgc.PagedCPQXCache):
        pgc.chunk_cpq_x(cache, rt.cpq, slot, block_row, offset, valid, c, k_rope, first)
        return _out(p, cpq_attend(cache, block_row)), cache
    pgc.write_chunk_pages(cache.x, block_row, offset, valid, c[0])
    pgc.write_chunk_pages(cache.k_rope, block_row, offset, valid, k_rope[0])
    if rt.paged_kernels:
        o = t1_ops.paged_decomposed_prefill(q_nope, q_rope, cache.x, cache.k_rope, block_row,
                                            offset, valid, wuk, wuv, scale)
    else:
        o = decomposed_attention(
            q_nope, q_rope, pgc.gather_pages(cache.x, block_row[None]),
            pgc.gather_pages(cache.k_rope, block_row[None]), wuk, wuv, offset + valid,
            scale, query_positions=offset + torch.arange(x.shape[1], device=x.device))
    return _out(p, o), cache


def mla_decode_rows(cfg: ModelConfig, rt: AttentionRuntime, p, x_t: torch.Tensor,
                    rows: pgc.RowState, cache):
    """Absorbed decode over the paged latent, every row at its own position
    (``rows.lengths``): B3 with ``rt.paged_kernels`` over the latent pages
    through the block table, the gather path otherwise; a CPQ latent keeps
    the reference's dequantize-and-gather path."""
    q_nope, q_rope, c_t, k_rope_t = _q_ckv_rows(cfg, p, x_t, rows.lengths)
    new_len = rows.lengths + rows.active.to(rows.lengths.dtype)
    wuk, wuv, scale = p["wuk"], p["wuv"], _scale(cfg)

    def cpq_attend(latent, table):
        c_arena = cpq_lib.cpq_dequant(pgc.logical_cpq(latent.x, table), x_t.dtype)[:, :, 0, :]
        return decomposed_attention(q_nope, q_rope, c_arena,
                                    pgc.gather_pages(latent.k_rope, table), wuk, wuv, new_len,
                                    scale)

    if isinstance(cache, pgc.ShardedPagedCache) and isinstance(cache.logical,
                                                               pgc.PagedCPQXCache):
        # global-semantics compute over the replicated code pools, as
        # mla_prefill_chunk's
        from repro_torch.serving import sharded

        o = sharded.cpq_x_decode(rt, cache, rows, c_t, k_rope_t, cpq_attend)
        return _out(p, o), cache
    if isinstance(cache, pgc.ShardedPagedCache):
        # mesh-native absorbed decode, as mla_prefill_chunk's
        from repro_torch.serving import sharded

        o, cache = sharded.decode_attend_sharded(
            rt, cache, rows, q=None, k_t=None, v_t=None, x_t=c_t, k_rope_t=k_rope_t,
            q_nope=q_nope, q_rope=q_rope, w_k_nope=wuk, w_v=wuv, scale=scale)
        return _out(p, o), cache
    if isinstance(cache, pgc.PagedCPQXCache):
        pgc.append_cpq_x(cache, rows, c_t, k_rope_t, rt.cpq)
        return _out(p, cpq_attend(cache, rows.block_table)), cache
    pgc.append_x(cache, rows, c_t, k_rope_t)
    if rt.paged_kernels:
        o = t1_ops.paged_decomposed_decode(q_nope, q_rope, cache.x, cache.k_rope,
                                           rows.block_table, new_len, wuk, wuv, scale)
        return _out(p, o), cache
    o = decomposed_attention(q_nope, q_rope, pgc.gather_pages(cache.x, rows.block_table),
                             pgc.gather_pages(cache.k_rope, rows.block_table), wuk, wuv,
                             new_len, scale)
    return _out(p, o), cache
