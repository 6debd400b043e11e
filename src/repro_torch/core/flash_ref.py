"""Memory-efficient (flash) attention in plain PyTorch, the JAX package's
``core/flash_ref.py``: the forward, its custom backward as a
``torch.autograd.Function`` (the reference's ``jax.custom_vjp``), and
``attention_auto``, which picks the exact dense oracle for short shapes and
flash attention beyond. The forward is the plain version of the contiguous
flash kernel B8 (``kernels/flash_attn``); the backward has no kernel, as
the reference has none (it is plain jnp there).

The forward is a two-level online softmax: an outer loop over query chunks
and an inner loop over key chunks, so the (T x S) score matrix never exists
whole. It saves (q, k, v, out, lse). The backward is the reference's
two-pass schedule: a pass with the key chunks outside accumulates dk and dv
over the query chunks, then a pass with the query chunks outside
accumulates dq over the key chunks; every score tile is recomputed from
lse, with ``D = rowsum(dout * out)``. Where S or T is not a multiple of its
chunk, the last chunk is shorter (the reference pads it and masks the
padding, which computes the same). Under ``causal`` a tile whose keys all
lie past its last query adds exactly zero (its weights are
``exp(NEG_INF - lse)``), so the backward skips it. The weights are rounded
to v's dtype before the forward's value product, and every chunk's state
and every gradient accumulator stays float32, as in the reference.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _flash_fwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    causal: bool = True, q_offset: int = 0, kv_chunk: int = 1024,
                    q_chunk: int = 512):
    """q (B, T, H, Dh), k (B, S, KV, Dh), v (B, S, KV, Dv). Returns
    (out (B, T, H, Dv) in q's dtype, lse (B, T, H) float32)."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    g = H // KV
    kc, qc = min(kv_chunk, S), min(q_chunk, T)
    dev = q.device
    outs, lses = [], []
    for q0 in range(0, T, qc):
        qb = q[:, q0:q0 + qc]
        n = qb.shape[1]
        qg = qb.reshape(B, n, KV, g, Dh)
        qpos = torch.arange(q0, q0 + n, device=dev) + q_offset
        m = torch.full((B, n, KV, g), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, n, KV, g), dtype=torch.float32, device=dev)
        o = torch.zeros((B, n, KV, g, Dv), dtype=torch.float32, device=dev)
        for k0 in range(0, S, kc):
            kb, vb = k[:, k0:k0 + kc], v[:, k0:k0 + kc]
            s = torch.einsum("btkgd,bskd->btkgs", qg, kb).float() * scale
            kpos = torch.arange(k0, k0 + kb.shape[1], device=dev)
            if causal:
                ok = kpos[None, :] <= qpos[:, None]
                s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
            m2 = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m2)
            p = torch.exp(s - m2[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum(
                "btkgs,bskd->btkgd", p.to(vb.dtype), vb).float()
            m = m2
        outs.append((o / l.clamp_min(1e-30)[..., None]).reshape(B, n, H, Dv).to(q.dtype))
        lses.append((m + torch.log(l.clamp_min(1e-30))).reshape(B, n, H))
    return torch.cat(outs, 1), torch.cat(lses, 1)


def _flash_bwd(q, k, v, out, lse, dout, scale: float, causal: bool, q_offset: int,
               kv_chunk: int, q_chunk: int = 512):
    """The gradients (dq, dk, dv) of ``_flash_fwd_impl``'s out, in q's, k's
    and v's dtypes, from the saved (q, k, v, out, lse) and dout (B, T, H,
    Dv)."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    g = H // KV
    kc, qc = min(kv_chunk, S), min(q_chunk, T)
    dev = q.device
    qg = q.reshape(B, T, KV, g, Dh)
    dog = dout.reshape(B, T, KV, g, Dv).float()
    D = (dog * out.reshape(B, T, KV, g, Dv).float()).sum(-1)           # (B, T, KV, g)
    lseg = lse.reshape(B, T, KV, g)
    qpos = torch.arange(T, device=dev) + q_offset
    kpos = torch.arange(S, device=dev)
    q_tiles = [(q0, min(q0 + qc, T)) for q0 in range(0, T, qc)]
    k_tiles = [(k0, min(k0 + kc, S)) for k0 in range(0, S, kc)]

    def live(qt, kt) -> bool:
        return not causal or kt[0] <= q_offset + qt[1] - 1

    def tile(qt, kt):
        """(p, ds) of one (query chunk, key chunk) tile, float32."""
        (q0, q1), (k0, k1) = qt, kt
        s = torch.einsum("btkgd,bskd->btkgs", qg[:, q0:q1], k[:, k0:k1]).float() * scale
        if causal:
            ok = kpos[k0:k1][None, :] <= qpos[q0:q1][:, None]
            s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
        p = torch.exp(s - lseg[:, q0:q1, ..., None])
        dp = torch.einsum("btkgd,bskd->btkgs", dog[:, q0:q1], v[:, k0:k1].float())
        return p, p * (dp - D[:, q0:q1, ..., None]) * scale

    # pass 1: dk, dv (key chunks outside)
    dks, dvs = [], []
    for kt in k_tiles:
        n = kt[1] - kt[0]
        dk_c = torch.zeros((B, n, KV, Dh), dtype=torch.float32, device=dev)
        dv_c = torch.zeros((B, n, KV, Dv), dtype=torch.float32, device=dev)
        for qt in q_tiles:
            if live(qt, kt):
                p, ds = tile(qt, kt)
                dk_c += torch.einsum("btkgs,btkgd->bskd", ds, qg[:, qt[0]:qt[1]].float())
                dv_c += torch.einsum("btkgs,btkgd->bskd", p, dog[:, qt[0]:qt[1]])
        dks.append(dk_c)
        dvs.append(dv_c)
    # pass 2: dq (query chunks outside)
    dqs = []
    for qt in q_tiles:
        dq_c = torch.zeros((B, qt[1] - qt[0], KV, g, Dh), dtype=torch.float32, device=dev)
        for kt in k_tiles:
            if live(qt, kt):
                _, ds = tile(qt, kt)
                dq_c += torch.einsum("btkgs,bskd->btkgd", ds, k[:, kt[0]:kt[1]].float())
        dqs.append(dq_c)
    dq = torch.cat(dqs, 1).reshape(B, T, H, Dh)
    return dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The flash forward with the reference's custom backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, q_offset: int, kv_chunk: int):
        out, lse = _flash_fwd_impl(q, k, v, scale, causal, q_offset, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, q_offset, kv_chunk)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.saved_tensors, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    causal: bool = True, q_offset: int = 0,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Flash attention: (B, T, H, Dv) in q's dtype, differentiable in q, k
    and v through the custom backward."""
    return FlashAttention.apply(q, k, v, scale, causal, q_offset, kv_chunk)


def attention_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   causal: bool = True, q_offset: int = 0, kv_length=None,
                   flash_threshold: int = 1024) -> torch.Tensor:
    """The exact dense oracle for short shapes (or a length mask), the flash
    forward beyond ``flash_threshold``."""
    from repro_torch.core.attention import dense_attention

    T, S = q.shape[1], k.shape[1]
    if kv_length is not None or max(T, S) <= flash_threshold:
        return dense_attention(q, k, v, scale, causal=causal, q_offset=q_offset,
                               kv_length=kv_length)
    return flash_attention(q, k, v, scale, causal, q_offset)
