"""GQA/MQA/MHA attention layer of the port, serving phases (the JAX
package's ``models/attention_layer.py``): over paged arenas (chunked prefill
and per-row decode) and over contiguous arenas (``attn_prefill`` of a whole
prompt and ``attn_decode`` at one shared position: the static engine and
one-shot admission). Ported: the dense, decomposed (T1), CPQ (T2) and
retrieval (T3) modes and the tiered dense + CPQ arena; decomposed_cpq
(T1+T2) raises ``NotImplementedError`` naming its ROADMAP item.

Prefill attention over a whole prompt is dense and causal in every mode:
the contiguous flash kernel B8 with ``rt.paged_kernels`` (the default),
else its plain version, ``attention_auto``, as the reference computes it.

Decomposed (T1) rope handling: rotations do not commute with W_K, so on
RoPE architectures only the first ``decoupled_rope_dims`` dims of each q
and k head are roped (with tables built for that width) and the roped key
slice is cached verbatim beside X; the remaining content dims go through
the decomposition. With absolute positions the slice is empty and T1 is
exact against dense attention."""
from __future__ import annotations

import torch

from repro_torch.configs import AttentionRuntime, CPQCfg, ModelConfig
from repro_torch.core import attention as core_attn
from repro_torch.core.flash_ref import attention_auto
from repro_torch.kernels.flash_attn import ops as fa_ops
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


def init_attn_cache(cfg: ModelConfig, rt: AttentionRuntime, batch: int, n_max: int,
                    device):
    """Contiguous (batch, n_max) arena of the configured mode."""
    return core_attn.init_cache(
        rt, batch=batch, n_max=n_max, kv=cfg.num_kv_heads, dh=cfg.head_dim,
        d_model=cfg.d_model, rope_dims=decoupled_rope_dims(cfg), dtype=cfg.param_dtype,
        device=device)


def _prefill_attention(rt: AttentionRuntime, q, k, v, scale: float):
    """Causal attention over a whole prompt: B8 or its plain version."""
    if rt.paged_kernels:
        return fa_ops.flash_attention(q, k, v, scale, causal=True)
    return attention_auto(q, k, v, scale, causal=True)


def attn_prefill(cfg: ModelConfig, rt: AttentionRuntime, p, x: torch.Tensor,
                 positions: torch.Tensor, cache):
    """Dense prefill compute over the whole prompt and the mode's cache
    build. x (B, S, D) is the normed block input (the exact T1 operand);
    the cache records length S. T1 ropes only the cached slice of q and k,
    and its prefill attends over those partly roped q and k, as the
    reference does."""
    q, k, v = _project_qkv(cfg, p, x)
    r = decoupled_rope_dims(cfg)
    if rt.mode == "decomposed":
        q, k = _rope_qk(cfg, q, k, positions, positions, dims=r)
        k_rope = k[..., :r]
    else:
        q, k = _rope_qk(cfg, q, k, positions, positions)
        k_rope = None
    cache = core_attn.prefill_into_cache(rt, cache, k=k, v=v, x=x, k_rope=k_rope,
                                         length=x.shape[1])
    return _out(cfg, p, _prefill_attention(rt, q, k, v, _scale(cfg))), cache


def attn_decode(cfg: ModelConfig, rt: AttentionRuntime, p, x_t: torch.Tensor, pos: int,
                cache):
    """One-token decode over a contiguous arena, every row at position
    ``pos`` (a host int). x_t (B, 1, D) normed block input."""
    q, k, v = _project_qkv(cfg, p, x_t)
    positions = torch.tensor([pos], device=x_t.device)
    if rt.mode == "decomposed":
        wk_nope, wv, r = _wk_wv_heads(cfg, p)
        q, k = _rope_qk(cfg, q, k, positions, positions, dims=r)
        out, cache = core_attn.decode_attend(
            rt, cache, q=q, k_t=k, v_t=v, x_t=x_t, k_rope_t=k[..., :r], q_nope=q[..., r:],
            q_rope=q[..., :r], w_k_nope=wk_nope, w_v=wv, scale=_scale(cfg))
    else:
        q, k = _rope_qk(cfg, q, k, positions, positions)
        out, cache = core_attn.decode_attend(rt, cache, q=q, k_t=k, v_t=v, scale=_scale(cfg))
    return _out(cfg, p, out), cache


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
