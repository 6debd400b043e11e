"""Attention-mode dispatcher of the port (the JAX package's
``core/attention.py``): the reference attention over explicit K/V
(``dense_attention``, ``:34``), the chunked CPQ decode
(``cpq_chunked_decode_attention``, ``:68``), and the contiguous arenas of
the static ``ServeEngine`` and of one-shot admission:

  * ``init_cache``          build the decode arena for the configured mode
  * ``prefill_into_cache``  bulk-write the prompt (mode-specific compression)
  * ``decode_attend``       append one token and attend over the arena

Prefill compute is always dense; the mode decides what is cached and how
decode reads it. Modes ``dense``, ``decomposed`` (T1), ``cpq`` (T2) and
``retrieval`` (T3) are ported; ``decomposed_cpq`` raises, naming its ROADMAP
item. With ``rt.paged_kernels`` (the default) decode runs the hand-written
contiguous kernels: the flash kernel B8 over the written prefix (dense),
B9 (T1), B10 with bf16-rounded tiles (T2, the function of
``cpq_chunked_decode_attention``) and B7's proxy scores (T3); without it,
the plain functions below, as the JAX package computes them.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs import AttentionRuntime
from repro_torch.core import cpq as cpq_lib
from repro_torch.core import kv_cache as kvc
from repro_torch.core.kv_cache import length_mask

NEG_INF = -1e30


def dense_attention(
    q: torch.Tensor,              # (B, T, H, Dh)
    k: torch.Tensor,              # (B, S, KV, Dh)
    v: torch.Tensor,              # (B, S, KV, Dv)
    scale: float,
    causal: bool = True,
    q_offset: Union[int, torch.Tensor] = 0,   # absolute position of q[0]
    kv_length: Optional[Union[int, torch.Tensor]] = None,  # () or (B,)
    logit_bias: Optional[torch.Tensor] = None,  # broadcastable to (B, T, H, S)
) -> torch.Tensor:
    """Reference GQA scaled dot-product attention. Like the reference, it
    rounds the softmax weights to ``v.dtype`` before the weighted sum."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = H // KV
    dev = q.device
    qg = q.reshape(B, T, KV, g, Dh)
    s = torch.einsum("btkgd,bskd->btkgs", qg, k).float() * scale
    s = s.reshape(B, T, H, S)
    if logit_bias is not None:
        s = s + logit_bias

    pos_j = torch.arange(S, device=dev)
    ok = torch.ones((1, T, S), dtype=torch.bool, device=dev)
    if causal:
        pos_i = torch.arange(T, device=dev) + q_offset
        ok = ok & (pos_j[None, :] <= pos_i[:, None])[None]
    if kv_length is not None:
        ok = ok & length_mask(kv_length, S, dev)[:, None, :]
    s = s.masked_fill(~ok[:, :, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    wg = w.reshape(B, T, KV, g, S).to(v.dtype)
    return torch.einsum("btkgs,bskd->btkgd", wg, v).reshape(B, T, H, v.shape[-1])


def cpq_chunked_decode_attention(q: torch.Tensor, kt, vt, length, scale: float,
                                 chunk: int = 2048) -> torch.Tensor:
    """T2 decode attention that dequantizes CPQ codes chunk by chunk inside
    an online softmax. kt/vt are ``CPQTensor`` views (codes (B, N, KV, D),
    level (B, N, KV), scale/zero (B, L, KV, D)); ``length`` is () or (B,).
    Each dequantized chunk is rounded to bf16, as in the reference, and a
    level outside [0, L) reads scale = zero = 0 (its one-hot lookup).
    q (B, 1, H, Dh) -> (B, 1, H, Dv) in q's dtype."""
    B, _, H, Dh = q.shape
    N, KV = kt.codes.shape[1], kt.codes.shape[2]
    Dv = vt.codes.shape[3]
    g = H // KV
    c = min(chunk, N)
    dev = q.device
    qg = q[:, 0].reshape(B, KV, g, Dh).float()
    length = torch.as_tensor(length, device=dev).reshape(-1, 1)

    def dequant(t, lo, hi):
        lvl = t.level[:, lo:hi]
        return cpq_lib.decode_codes(t.codes[:, lo:hi], cpq_lib.take_levels(t.scale, lvl),
                                    cpq_lib.take_levels(t.zero, lvl), torch.bfloat16)

    m = torch.full((B, KV, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, g), dtype=torch.float32, device=dev)
    o = torch.zeros((B, KV, g, Dv), dtype=torch.float32, device=dev)
    for lo in range(0, N, c):
        hi = min(lo + c, N)
        k_hat = dequant(kt, lo, hi)                                  # (B, c, KV, Dh)
        s = torch.einsum("bkgd,bckd->bkgc", qg, k_hat.float()) * scale
        live = torch.arange(lo, hi, device=dev)[None, :] < length    # (B|1, c)
        s = torch.where(live[:, None, None, :], s, NEG_INF)
        m2 = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m2)
        p = torch.exp(s - m2[..., None])
        l = l * corr + p.sum(-1)
        v_hat = dequant(vt, lo, hi)
        o = o * corr[..., None] + torch.einsum("bkgc,bckd->bkgd", p, v_hat.float())
        m = m2
    out = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, Dv).to(q.dtype)


# ----------------------------------------------------------------- caches


def _unported(mode: str) -> NotImplementedError:
    return NotImplementedError(
        f"attention mode {mode!r} is not ported yet (ROADMAP A16); the port serves "
        "'dense', 'decomposed', 'cpq' and 'retrieval'")


def init_cache(rt: AttentionRuntime, *, batch: int, n_max: int, kv: int, dh: int,
               d_model: int, rope_dims: int, dtype=torch.bfloat16,
               device="cpu") -> kvc.Cache:
    if rt.mode == "dense":
        return kvc.init_dense(batch, n_max, kv, dh, dtype, device)
    if rt.mode == "decomposed":
        return kvc.init_x(batch, n_max, d_model, kv, rope_dims, dtype, device)
    if rt.mode == "cpq":
        return kvc.init_cpq(batch, n_max, kv, dh, rt.cpq, device)
    if rt.mode == "retrieval":
        return kvc.init_retrieval(batch, n_max, kv, dh, rt.retrieval, dtype, device)
    raise _unported(rt.mode)


def prefill_into_cache(rt: AttentionRuntime, cache: kvc.Cache, *,
                       k: torch.Tensor,                   # (B, S, KV, Dh) roped keys
                       v: torch.Tensor,                   # (B, S, KV, Dh)
                       x: Optional[torch.Tensor],         # (B, S, Dm) block input (T1)
                       k_rope: Optional[torch.Tensor],    # (B, S, KV, R) roped slice (T1)
                       length: int) -> kvc.Cache:
    """Write the prompt's cache payload at positions 0 .. S-1: K/V in place
    (dense, T3, plus T3's proxy codes fitted on the whole prompt), X and
    the roped key slices (T1), or level-0 CPQ codes fitted on the whole
    prompt (T2). Returns the container with length ``length``."""
    from repro_torch.core import retrieval_attention as ret_lib  # it imports this module

    n = kvc.host_length(length)
    if isinstance(cache, kvc.DenseKVCache):
        return kvc.DenseKVCache(kvc.append_tokens(cache.k, k, 0),
                                kvc.append_tokens(cache.v, v, 0), n)
    if isinstance(cache, kvc.XCache):
        if k_rope is not None:
            kvc.append_tokens(cache.k_rope, k_rope, 0)
        return kvc.XCache(kvc.append_tokens(cache.x, x, 0), cache.k_rope, n)
    if isinstance(cache, kvc.CPQKVCache):
        return kvc.CPQKVCache(
            cpq_lib.cpq_compress_prefill(k, rt.cpq, cache.k.codes.shape[1]),
            cpq_lib.cpq_compress_prefill(v, rt.cpq, cache.v.codes.shape[1]), n)
    if isinstance(cache, kvc.RetrievalCache):
        dp = rt.retrieval.proxy_dim or k.shape[-1]
        codes, pscale, pzero = ret_lib.fit_proxy(k[..., :dp], rt.retrieval.proxy_bits)
        return kvc.RetrievalCache(
            kvc.append_tokens(cache.k, k, 0), kvc.append_tokens(cache.v, v, 0),
            kvc.append_tokens(cache.proxy, codes, 0), pscale, pzero, n)
    raise TypeError(type(cache))


# ------------------------------------------------------------------ decode


def decode_attend(rt: AttentionRuntime, cache: kvc.Cache, *,
                  q: torch.Tensor,                       # (B, 1, H, Dh) roped query
                  k_t: torch.Tensor,                     # (B, 1, KV, Dh) roped new key
                  v_t: torch.Tensor,                     # (B, 1, KV, Dh)
                  x_t: Optional[torch.Tensor] = None,    # (B, 1, Dm)
                  k_rope_t: Optional[torch.Tensor] = None,  # (B, 1, KV, R)
                  q_nope: Optional[torch.Tensor] = None,    # (B, 1, H, Dn) (T1)
                  q_rope: Optional[torch.Tensor] = None,    # (B, 1, H, R) (T1)
                  w_k_nope: Optional[torch.Tensor] = None,  # (Dm, KV, Dn) (T1)
                  w_v: Optional[torch.Tensor] = None,       # (Dm, KV, Dh) (T1)
                  scale: float):
    """Append one token per row at slot ``cache.length`` and attend over
    the arena. Returns (out (B, 1, H, Dv), the container with length + 1)."""
    # imported here: these modules import this one
    from repro_torch.core import retrieval_attention as ret_lib
    from repro_torch.core.decomposed_attention import decomposed_attention
    from repro_torch.kernels.cpq_attn import ops as cpq_ops
    from repro_torch.kernels.decomposed_attn import ops as t1_ops
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.topk_retrieval import ops as t3_ops

    pos = int(cache.length)
    new_len = pos + 1
    n = kvc.host_length(new_len)
    fused = rt.paged_kernels

    if isinstance(cache, kvc.DenseKVCache):
        kvc.append_tokens(cache.k, k_t, pos)
        kvc.append_tokens(cache.v, v_t, pos)
        if fused:  # B8, non-causal over the written prefix
            out = fa_ops.flash_attention(q, cache.k[:, :new_len], cache.v[:, :new_len],
                                         scale, causal=False)
        else:
            out = dense_attention(q, cache.k, cache.v, scale, causal=False,
                                  kv_length=new_len)
        return out, cache._replace(length=n)

    if isinstance(cache, kvc.XCache):
        kvc.append_tokens(cache.x, x_t, pos)
        if k_rope_t is not None:
            kvc.append_tokens(cache.k_rope, k_rope_t, pos)
        if fused:
            out = t1_ops.decomposed_decode(q_nope, q_rope, cache.x, cache.k_rope, new_len,
                                           w_k_nope, w_v, scale)
        else:
            out = decomposed_attention(q_nope, q_rope, cache.x, cache.k_rope, w_k_nope, w_v,
                                       new_len, scale)
        return out, cache._replace(length=n)

    if isinstance(cache, kvc.CPQKVCache):
        kt = cpq_lib.cpq_append_decode(cache.k, k_t, pos, rt.cpq)
        vt = cpq_lib.cpq_append_decode(cache.v, v_t, pos, rt.cpq)
        if fused:
            out = cpq_ops.cpq_decode(q, kt, vt, new_len, scale)
        else:
            out = cpq_chunked_decode_attention(q, kt, vt, new_len, scale)
        return out, kvc.CPQKVCache(kt, vt, n)

    if isinstance(cache, kvc.RetrievalCache):
        cfg = rt.retrieval
        dp = cfg.proxy_dim or k_t.shape[-1]
        code_t = ret_lib.encode_proxy(k_t[..., :dp], cache.proxy_scale, cache.proxy_zero,
                                      cfg.proxy_bits)
        kvc.append_tokens(cache.k, k_t, pos)
        kvc.append_tokens(cache.v, v_t, pos)
        kvc.append_tokens(cache.proxy, code_t, pos)
        cache = cache._replace(length=n)
        if fused:
            out = t3_ops.retrieval_decode(q, cache, cfg, scale, calibrate=True)
        else:
            out = ret_lib.retrieval_attention(q, cache.k, cache.v, cache.proxy,
                                              cache.proxy_scale, cache.proxy_zero, new_len,
                                              cfg, scale)
        return out, cache

    raise TypeError(type(cache))
