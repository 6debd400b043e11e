"""GQA/MQA/MHA attention layer of the port, serving phases over paged arenas
(the JAX package's ``models/attention_layer.py``). Ported: the dense,
decomposed (T1), CPQ (T2) and retrieval (T3) modes and the tiered dense +
CPQ arena; decomposed_cpq (T1+T2) raises ``NotImplementedError`` naming its
ROADMAP item.

Decomposed (T1) rope handling: rotations do not commute with W_K, so on
RoPE architectures only the first ``decoupled_rope_dims`` dims of each q
and k head are roped (with tables built for that width) and the roped key
slice is cached verbatim beside X; the remaining content dims go through
the decomposition. With absolute positions the slice is empty and T1 is
exact against dense attention."""
from __future__ import annotations

import torch

from repro_torch.configs import AttentionRuntime, CPQCfg, ModelConfig
from repro_torch.models.layers import apply_rope, apply_rope_rows, rms_norm_vec, rope_tables
from repro_torch.serving import paged_cache as pgc


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, T, D) -> q (B, T, H, Dh), k/v (B, T, KV, Dh)."""
    B, T, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, T, H, Dh)
    k = k.reshape(B, T, KV, Dh)
    v = v.reshape(B, T, KV, Dh)
    if cfg.qk_norm:
        q = rms_norm_vec(q, p["q_norm"])
        k = rms_norm_vec(k, p["k_norm"])
    return q, k, v


def decoupled_rope_dims(cfg: ModelConfig) -> int:
    """Roped head-dim slice cached verbatim in decomposed mode (0: exact T1)."""
    if cfg.pos_embedding != "rope":
        return 0
    return min(32, (cfg.head_dim // 4) * 2)


def _rope_first(x, d: int, rope, cos, sin):
    """``rope`` applied to the first ``d`` dims of x, the rest unchanged."""
    if d == x.shape[-1]:
        return rope(x, cos, sin)
    return torch.cat([rope(x[..., :d], cos, sin), x[..., d:]], dim=-1)


def _rope_qk(cfg: ModelConfig, q, k, positions_q, positions_k, dims: int | None = None):
    """Rope the first ``dims`` head dims (all if None)."""
    if cfg.pos_embedding != "rope":
        return q, k
    d = q.shape[-1] if dims is None else dims
    if d == 0:
        return q, k
    cq, sq = rope_tables(positions_q, d, cfg.rope_theta)
    ck, sk = rope_tables(positions_k, d, cfg.rope_theta)
    return _rope_first(q, d, apply_rope, cq, sq), _rope_first(k, d, apply_rope, ck, sk)


def _rope_qk_rows(cfg: ModelConfig, q, k, positions, dims: int | None = None):
    """Per-row decode rope of the first ``dims`` head dims (all if None):
    positions (B,), q/k (B, 1, H|KV, D)."""
    if cfg.pos_embedding != "rope":
        return q, k
    d = q.shape[-1] if dims is None else dims
    if d == 0:
        return q, k
    cos, sin = rope_tables(positions, d, cfg.rope_theta)
    return (_rope_first(q, d, apply_rope_rows, cos, sin),
            _rope_first(k, d, apply_rope_rows, cos, sin))


def _wk_wv_heads(cfg: ModelConfig, p):
    """Weight views of the T1 path, (Dm, KV, Dh) each, with the roped slice
    removed from W_K (content dims only). Returns (w_k_nope, w_v, rope_dims)."""
    d, KV, Dh = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    r = decoupled_rope_dims(cfg)
    return p["wk"].reshape(d, KV, Dh)[..., r:], p["wv"].reshape(d, KV, Dh), r


def _out(cfg: ModelConfig, p, o: torch.Tensor) -> torch.Tensor:
    B, T = o.shape[:2]
    return o.reshape(B, T, cfg.num_heads * cfg.head_dim) @ p["wo"]


def _scale(cfg: ModelConfig) -> float:
    return cfg.head_dim ** -0.5


def init_paged_attn_cache(cfg: ModelConfig, rt: AttentionRuntime, serving,
                          device, tiered: bool = False):
    """Per-layer paged arena of the configured mode; ``tiered`` pairs the
    dense base arena with a CPQ escalation arena of
    ``serving.escalated_pages`` pages."""
    kv, dh = cfg.num_kv_heads, cfg.head_dim
    if tiered:
        if rt.mode != "dense":
            raise ValueError("tier escalation starts from a dense base arena")
        return pgc.TieredPagedCache(
            dense=pgc.init_paged_dense(serving.num_pages, serving.page_size, kv, dh,
                                       dtype=cfg.param_dtype, device=device),
            cpq=pgc.init_paged_cpq(serving.escalated_pages, serving.page_size,
                                   serving.num_slots, kv, dh, rt.cpq or CPQCfg(),
                                   device=device))
    if rt.mode == "dense":
        return pgc.init_paged_dense(serving.num_pages, serving.page_size, kv, dh,
                                    dtype=cfg.param_dtype, device=device)
    if rt.mode == "decomposed":
        return pgc.init_paged_x(serving.num_pages, serving.page_size, cfg.d_model, kv,
                                decoupled_rope_dims(cfg), dtype=cfg.param_dtype,
                                device=device)
    if rt.mode == "cpq":
        return pgc.init_paged_cpq(serving.num_pages, serving.page_size,
                                  serving.num_slots, kv, dh, rt.cpq, device=device)
    if rt.mode == "retrieval":
        return pgc.init_paged_retrieval(serving.num_pages, serving.page_size,
                                        serving.num_slots, kv, dh, rt.retrieval,
                                        dtype=cfg.param_dtype, device=device)
    raise pgc.unported_mode(rt.mode)


def attn_prefill_chunk(cfg: ModelConfig, rt: AttentionRuntime, tier: int, first: bool,
                       p, x: torch.Tensor, positions: torch.Tensor, slot: int,
                       block_row: torch.Tensor, offset: int, valid: int, cache):
    """One prompt chunk of one slot: its K/V (CPQ codes, or T1's X rows and
    roped key slices) go straight into the slot's pages and its C queries
    attend [0, offset + valid). x (1, C, D) is the normed block input at
    absolute ``positions``, the operand T1 caches; ``tier`` (the arm of a
    tiered arena) and ``first`` (first chunk of the admission) are
    host-static."""
    q, k, v = _project_qkv(cfg, p, x)
    kw = dict(tier=tier, first=first, slot=slot, block_row=block_row, offset=offset,
              valid=valid, scale=_scale(cfg))
    if rt.mode == "decomposed":
        wk_nope, wv, r = _wk_wv_heads(cfg, p)
        q, k = _rope_qk(cfg, q, k, positions, positions, dims=r)
        out, cache = pgc.chunk_attend_paged(
            rt, cache, **kw, q=q, k_c=k, v_c=v, x_c=x, k_rope_c=k[..., :r], q_nope=q[..., r:],
            q_rope=q[..., :r], w_k_nope=wk_nope, w_v=wv)
    else:
        q, k = _rope_qk(cfg, q, k, positions, positions)
        out, cache = pgc.chunk_attend_paged(rt, cache, **kw, q=q, k_c=k, v_c=v)
    return _out(cfg, p, out), cache


def attn_decode_rows(cfg: ModelConfig, rt: AttentionRuntime, p, x_t: torch.Tensor,
                     rows: pgc.RowState, cache):
    """One-token decode against a paged arena. x_t (B, 1, D) normed block
    input (the operand T1 caches); per-row positions are ``rows.lengths``."""
    q, k, v = _project_qkv(cfg, p, x_t)
    if rt.mode == "decomposed":
        wk_nope, wv, r = _wk_wv_heads(cfg, p)
        q, k = _rope_qk_rows(cfg, q, k, rows.lengths, dims=r)
        out, cache = pgc.decode_attend_paged(
            rt, cache, rows, q=q, k_t=k, v_t=v, scale=_scale(cfg), x_t=x_t,
            k_rope_t=k[..., :r], q_nope=q[..., r:], q_rope=q[..., :r], w_k_nope=wk_nope,
            w_v=wv)
    else:
        q, k = _rope_qk_rows(cfg, q, k, rows.lengths)
        out, cache = pgc.decode_attend_paged(rt, cache, rows, q=q, k_t=k, v_t=v,
                                             scale=_scale(cfg))
    return _out(cfg, p, out), cache
