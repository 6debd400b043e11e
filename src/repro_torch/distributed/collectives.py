"""Collective patterns over per-shard tensors (the JAX package's
``distributed/collectives.py``).

1. ``flash_decoding_attention``: decode attention over a SEQUENCE-split
   cache. Each shard computes (m, l, o) over its own tokens on its device;
   one softmax combine (a max and two sums over the shards) merges them on
   the query's device, instead of gathering the cache.
2. ``ring_decomposed_scores``: T1's score stage over a sequence-split X
   cache with the query heads split too: each shard scores its heads
   against the resident X block while the blocks rotate shard to shard.

Where the reference runs ``shard_map`` with ``psum``/``pmax``/``ppermute``,
these take a list of per-shard tensors, one a device of the mesh axis, and
move data with peer copies (``Tensor.to``). The combines reduce in shard
order, so the result does not depend on timing.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def shard_along(x: torch.Tensor, dim: int, devices: list) -> list[torch.Tensor]:
    """Split ``x`` evenly along ``dim``, one part a device, each on it."""
    n = x.shape[dim] // len(devices)
    return [x.narrow(dim, i * n, n).to(d) for i, d in enumerate(devices)]


def _local_flash(q, k, v, scale, base, length):
    """q: (B, H, Dh); k/v: (B, n, KV, Dh), a shard starting at global
    position ``base``. Returns (m, l, o), the partial softmax stats in
    float32."""
    B, H, Dh = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, KV, g, Dh)
    s = torch.einsum("bkgd,bnkd->bkgn", qg, k).float() * scale
    pos = base + torch.arange(k.shape[1], device=k.device)
    s = torch.where((pos < length)[None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                            # (B, KV, g)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgn,bnkd->bkgd", p.to(v.dtype), v).float()
    return m, l, o


def flash_decoding_attention(mesh, seq_axis: str):
    """Returns fn(q (B, 1, H, Dh), k_shards, v_shards, length, scale) ->
    (B, 1, H, Dh) on q's device: the k/v shards (B, N/n, KV, Dh), one a
    device along ``seq_axis`` in sequence order, each on its device."""
    devices = mesh.axis_devices(seq_axis)

    def fn(q, k_shards, v_shards, length, scale: float):
        if len(k_shards) != len(devices) or len(v_shards) != len(devices):
            raise ValueError(f"{len(k_shards)} key and {len(v_shards)} value shards for "
                             f"{len(devices)} devices along {seq_axis!r}")
        parts, base = [], 0
        for k, v, dev in zip(k_shards, v_shards, devices):
            parts.append([t.to(q.device) for t in _local_flash(
                q[:, 0].to(dev), k, v, scale, base, length)])
            base += k.shape[1]
        m_g = parts[0][0]
        for m, _, _ in parts[1:]:
            m_g = torch.maximum(m_g, m)
        l_g = o_g = 0.0
        for m, l, o in parts:  # shard order: a fixed order of summation
            corr = torch.exp(m - m_g)
            l_g = l_g + l * corr
            o_g = o_g + o * corr[..., None]
        out = o_g / torch.clamp(l_g, min=1e-30)[..., None]
        B, KV, g, Dh = out.shape
        return out.reshape(B, 1, KV * g, Dh).to(q.dtype)

    return fn


def ring_decomposed_scores(mesh, axis: str):
    """T1's score stage R X^T with the query HEADS split over ``axis`` and
    the X cache SEQUENCE-split over the same axis, as a ring: at each of n
    steps every shard scores its heads against the X block it holds, then
    hands that block to the next shard.

    Returns fn(r_shards (B, H/n, Dm), x_shards (B, N/n, Dm)) -> scores, a
    list of (B, H/n, N), one a shard on its device."""
    devices = mesh.axis_devices(axis)
    n = len(devices)

    def fn(r_shards, x_shards):
        blocks = list(x_shards)           # blocks[i]: the X block shard i holds
        owner = list(range(n))            # the shard each held block came from
        scores = [[None] * n for _ in range(n)]
        for _ in range(n):
            for i in range(n):
                s = torch.einsum("bhm,bnm->bhn", r_shards[i], blocks[i]).float()
                scores[i][owner[i]] = s
            # one hop round the ring: shard i's block moves to shard i + 1
            blocks = [blocks[(i - 1) % n].to(devices[i]) for i in range(n)]
            owner = [owner[(i - 1) % n] for i in range(n)]
        return [torch.cat(row, dim=-1) for row in scores]

    return fn
