"""Block-paged KV arenas for continuous batching (the JAX package's
``serving/paged_cache.py``): the dense tier, the T1 X tier, the T2 CPQ tier,
the T3 retrieval tier and the tiered arena that pairs dense with CPQ.

The token axis is cut into fixed-size pages owned by a shared physical pool
``(P, page_size, KV, Dh)``; a per-slot block table ``(B, max_blocks)`` maps
logical blocks to physical pages. Physical page 0 is the null page:
unmapped block-table entries are 0 and inactive rows write there, so its
contents are garbage by design and no attention path reads them.

Unlike the JAX package, whose arrays are immutable, the writes here update
the arena tensors IN PLACE (``index_put_``), so a step never copies an
arena. Several inactive rows may write the same null-page slot in one step;
which value lands there is unspecified and harmless, because page 0 is
never read.

Per-token state is paged; per-sequence state (the CPQ scale/zero tables,
level counts and prune thresholds, the T3 proxy calibration) stays
slot-indexed ``(num_slots, ...)`` and is overwritten at admission.

Mode -> paged container:
  dense       PagedDenseKVCache   K, V pages
  decomposed  PagedXCache         block-input X pages + roped key slice (T1)
  cpq         PagedCPQKVCache     CPQ code/level pages, slot tables (T2)
  retrieval   PagedRetrievalCache K, V and int8 proxy-code pages, slot
                                  proxy calibration (T3)
  tiered      TieredPagedCache    dense base arena + CPQ escalation arena
The T1+T2 container is not ported yet; its mode raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import AttentionRuntime, CPQCfg
from repro_torch.core import attention as core_attn
from repro_torch.core import cpq as cpq_lib
from repro_torch.core import kv_cache as kvc
from repro_torch.core import retrieval_attention as ret_lib
from repro_torch.core.kv_cache import CPQKVCache
from repro_torch.core.decomposed_attention import decomposed_attention
from repro_torch.kernels.cpq_attn import ops as cpq_ops
from repro_torch.kernels.decomposed_attn import ops as t1_ops
from repro_torch.kernels.paged_attn import ops
from repro_torch.kernels.topk_retrieval import ops as t3_ops

NULL_PAGE = 0

UNPORTED_MODES = {"decomposed_cpq": "A16"}


def unported_mode(mode: str) -> NotImplementedError:
    return NotImplementedError(
        f"attention mode {mode!r} is not ported yet "
        f"(ROADMAP {UNPORTED_MODES.get(mode, 'A')}); the port serves 'dense', "
        "'decomposed', 'cpq' and 'retrieval'")


class RowState(NamedTuple):
    """Per-step request-row state of the decode step."""

    lengths: torch.Tensor      # (B,) int32 valid tokens per slot (= next position)
    block_table: torch.Tensor  # (B, max_blocks) int32 physical page ids; 0 = unmapped
    active: torch.Tensor       # (B,) bool: the row decodes this step (writes commit)
    tier: torch.Tensor         # (B,) int32: 0 = base tier, 1 = escalated (CPQ) tier
    alt_block_table: Optional[torch.Tensor] = None  # escalated-arena table (tiered)


# -------------------------------------------------------------- page plumbing


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Logical views: (P, page, ...) x (B, max_blocks) -> (B, max_blocks *
    page, ...). Unmapped blocks read the null page; mask by length."""
    g = pages[block_table.long()]  # (B, max_blocks, page, ...)
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def write_token_pages(pages: torch.Tensor, block_table: torch.Tensor,
                      lengths: torch.Tensor, active: torch.Tensor,
                      val: torch.Tensor) -> torch.Tensor:
    """Scatter one token per row at slot ``lengths[b]``, in place. val
    (B, ...). Inactive rows write the null page. The block index is clipped
    to the last block, as in the reference."""
    page_size, max_blocks = pages.shape[1], block_table.shape[1]
    lengths = lengths.long()
    blk = torch.clamp(lengths // page_size, 0, max_blocks - 1)
    page_idx = torch.gather(block_table.long(), 1, blk[:, None])[:, 0]
    page_idx = torch.where(active, page_idx, torch.zeros_like(page_idx))
    pages[page_idx, lengths % page_size] = val.to(pages.dtype)
    return pages


def write_prompt_pages(pages: torch.Tensor, block_row: torch.Tensor,
                       val: torch.Tensor) -> torch.Tensor:
    """Write a whole prompt into one slot's pages at positions 0 .. S-1, in
    place. val (S, ...). Positions whose block is unmapped or beyond the
    slot's capacity (bucket padding past ``max_blocks``) land on the null
    page, never wrapping round onto a mapped page."""
    return write_chunk_pages(pages, block_row, 0, val.shape[0], val)


def write_chunk_pages(pages: torch.Tensor, block_row: torch.Tensor, offset: int,
                      valid: int, vals: torch.Tensor) -> torch.Tensor:
    """Write one prompt chunk into one slot's pages at positions
    ``offset .. offset+C-1``, in place. vals (C, ...). Positions past
    ``offset + valid`` (chunk padding), unmapped blocks and blocks beyond
    the slot's capacity land on the null page."""
    C, page_size = vals.shape[0], pages.shape[1]
    idx = torch.arange(C, device=pages.device)
    pos = offset + idx
    blk = pos // page_size
    nb = block_row.shape[0]
    ok = (idx < valid) & (blk < nb)
    pidx = torch.where(ok, block_row.long()[torch.clamp(blk, 0, nb - 1)],
                       torch.zeros_like(blk))
    pages[pidx, pos % page_size] = vals.to(pages.dtype)
    return pages


# ----------------------------------------------------------------- allocator


class PageAllocator:
    """Host-side free list over the physical pool (page 0 reserved as null),
    with a per-page refcount. ``OutOfPages`` is the admission-control
    signal; ``DoubleFree`` is an error (releasing a page more often than it
    was referenced corrupts the free list)."""

    class OutOfPages(RuntimeError):
        pass

    class DoubleFree(RuntimeError):
        pass

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 1 allocatable page beyond the null page")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() hands out low ids first
        self._refs = [0] * num_pages

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def utilization(self) -> float:
        return self.num_used / max(self.num_pages - 1, 1)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise self.OutOfPages(f"want {n} pages, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def refcount(self, page: int) -> int:
        return self._refs[int(page)]

    def incref(self, page: int) -> None:
        p = int(page)
        if p == NULL_PAGE or self._refs[p] <= 0:
            raise self.DoubleFree(f"incref of unowned page {p}")
        self._refs[p] += 1

    def free(self, pages) -> list[int]:
        """Drop one reference per listed page; returns the pages that went
        back to the free list (refcount zero)."""
        released = []
        for p in pages:
            p = int(p)
            if p == NULL_PAGE:
                raise self.DoubleFree("freeing the null page")
            if self._refs[p] <= 0:
                raise self.DoubleFree(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                released.append(p)
        return released

    def relabel(self, perm, free: list[int]) -> None:
        """Defrag relabeling that preserves refcounts: page ``perm[new]``
        moves to id ``new``."""
        new_refs = [self._refs[int(old)] for old in perm]
        if sorted(new_refs) != sorted(self._refs):
            raise self.DoubleFree("relabel dropped or duplicated refcounts")
        zero = {p for p in range(1, self.num_pages) if new_refs[p] == 0}
        if set(int(p) for p in free) != zero:
            raise self.DoubleFree("relabel free list != zero-refcount pages")
        self._refs = new_refs
        self._free = [int(p) for p in free]


def pages_needed(tokens: int, page_size: int) -> int:
    return -(-int(tokens) // page_size)


def defrag_plan(block_table, num_pages: int, shared=None):
    """Compaction plan: remap every mapped page onto the lowest physical ids,
    ordered by (slot, logical block); pages in ``shared`` go first. Returns
    (perm, new_block_table, free) with ``perm[new_id] = old_id``."""
    bt = np.asarray(block_table)
    used: list[int] = []
    seen = set()
    for b in range(bt.shape[0]):
        for j in range(bt.shape[1]):
            p = int(bt[b, j])
            if p != NULL_PAGE and p not in seen:
                seen.add(p)
                used.append(p)
    if shared:
        used = ([p for p in used if p in shared]
                + [p for p in used if p not in shared])
    perm = [NULL_PAGE] + used
    in_front = set(perm)
    perm += [p for p in range(num_pages) if p not in in_front]
    remap = {old: new for new, old in enumerate(perm)}
    new_bt = np.array([[remap[int(p)] for p in row] for row in bt], dtype=bt.dtype)
    free = list(range(num_pages - 1, len(used), -1))
    return np.asarray(perm, dtype=np.int32), new_bt, free


# ------------------------------------------------------------- containers


class PagedDenseKVCache(NamedTuple):
    k: torch.Tensor  # (P, page, KV, Dh)
    v: torch.Tensor  # (P, page, KV, Dh)


class PagedXCache(NamedTuple):
    """T1 arena: the normed block input X per token, and the roped key slice
    of every kv head (zero-width without rope)."""

    x: torch.Tensor       # (P, page, Dm)
    k_rope: torch.Tensor  # (P, page, KV, R)


class PagedCPQTensor(NamedTuple):
    """CPQ arena: per-token code/level pages plus per-slot HQE side state."""

    codes: torch.Tensor       # (P, page, KV, D) int8
    level: torch.Tensor       # (P, page, KV) int32
    scale: torch.Tensor       # (num_slots, L, KV, D) f32
    zero: torch.Tensor        # (num_slots, L, KV, D) f32
    num_levels: torch.Tensor  # (num_slots, KV) int32
    prune_thr: torch.Tensor   # (num_slots, KV, D) f32


class PagedCPQKVCache(NamedTuple):
    k: PagedCPQTensor
    v: PagedCPQTensor


class PagedRetrievalCache(NamedTuple):
    """T3 arena: K and V pages, int8 proxy-code pages (stored code - 128) and
    each slot's proxy calibration, fitted on its first prompt chunk."""

    k: torch.Tensor            # (P, page, KV, Dh)
    v: torch.Tensor            # (P, page, KV, Dh)
    proxy: torch.Tensor        # (P, page, KV, Dp) int8
    proxy_scale: torch.Tensor  # (num_slots, KV, Dp) f32
    proxy_zero: torch.Tensor   # (num_slots, KV, Dp) f32


class TieredPagedCache(NamedTuple):
    """Dense base arena + CPQ escalation arena; ``RowState.tier`` selects the
    live one per row (the watermark policy's dense -> T2 target)."""

    dense: PagedDenseKVCache
    cpq: PagedCPQKVCache


def init_paged_dense(num_pages: int, page_size: int, kv: int, dh: int,
                     dtype=torch.bfloat16, device="cpu") -> PagedDenseKVCache:
    shape = (num_pages, page_size, kv, dh)
    return PagedDenseKVCache(torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device))


def init_paged_x(num_pages: int, page_size: int, dm: int, kv: int, rope_dims: int,
                 dtype=torch.bfloat16, device="cpu") -> PagedXCache:
    return PagedXCache(
        x=torch.zeros((num_pages, page_size, dm), dtype=dtype, device=device),
        k_rope=torch.zeros((num_pages, page_size, kv, rope_dims), dtype=dtype,
                           device=device))


def init_paged_retrieval(num_pages: int, page_size: int, num_slots: int, kv: int,
                         dh: int, cfg, dtype=torch.bfloat16,
                         device="cpu") -> PagedRetrievalCache:
    dp = cfg.proxy_dim or dh
    shape = (num_pages, page_size, kv, dh)
    return PagedRetrievalCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        proxy=torch.zeros((num_pages, page_size, kv, dp), dtype=torch.int8, device=device),
        proxy_scale=torch.ones((num_slots, kv, dp), dtype=torch.float32, device=device),
        proxy_zero=torch.zeros((num_slots, kv, dp), dtype=torch.float32, device=device))


def _init_paged_cpq_tensor(num_pages: int, page_size: int, num_slots: int, h: int,
                           d: int, cfg: CPQCfg, device) -> PagedCPQTensor:
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return PagedCPQTensor(
        codes=z((num_pages, page_size, h, d), torch.int8),
        level=z((num_pages, page_size, h), torch.int32),
        scale=z((num_slots, cfg.max_levels, h, d), torch.float32),
        zero=z((num_slots, cfg.max_levels, h, d), torch.float32),
        num_levels=torch.ones((num_slots, h), dtype=torch.int32, device=device),
        prune_thr=z((num_slots, h, d), torch.float32))


def init_paged_cpq(num_pages: int, page_size: int, num_slots: int, kv: int, dh: int,
                   cfg: CPQCfg, device="cpu") -> PagedCPQKVCache:
    return PagedCPQKVCache(
        k=_init_paged_cpq_tensor(num_pages, page_size, num_slots, kv, dh, cfg, device),
        v=_init_paged_cpq_tensor(num_pages, page_size, num_slots, kv, dh, cfg, device))


def logical_cpq(t: PagedCPQTensor, block_table: torch.Tensor) -> cpq_lib.CPQTensor:
    """Contiguous CPQTensor view of a paged CPQ arena: codes and levels
    gathered through the block table, the per-slot state as it is."""
    return cpq_lib.CPQTensor(
        codes=gather_pages(t.codes, block_table), scale=t.scale, zero=t.zero,
        level=gather_pages(t.level, block_table), num_levels=t.num_levels,
        prune_thr=t.prune_thr)


# ---------------------------------------------------------------- appends


def append_dense(cache: PagedDenseKVCache, rows: RowState, k_t: torch.Tensor,
                 v_t: torch.Tensor) -> PagedDenseKVCache:
    """k_t/v_t: (B, 1, KV, Dh) new token per row, written in place."""
    write_token_pages(cache.k, rows.block_table, rows.lengths, rows.active, k_t[:, 0])
    write_token_pages(cache.v, rows.block_table, rows.lengths, rows.active, v_t[:, 0])
    return cache


def append_x(cache: PagedXCache, rows: RowState, x_t: torch.Tensor,
             k_rope_t: torch.Tensor) -> PagedXCache:
    """x_t (B, 1, Dm) normed block input and k_rope_t (B, 1, KV, R) roped key
    slice of the new token per row, written in place."""
    write_token_pages(cache.x, rows.block_table, rows.lengths, rows.active, x_t[:, 0])
    write_token_pages(cache.k_rope, rows.block_table, rows.lengths, rows.active,
                      k_rope_t[:, 0])
    return cache


def append_cpq_tensor(t: PagedCPQTensor, rows: RowState, x_t: torch.Tensor,
                      cfg: CPQCfg) -> PagedCPQTensor:
    """HQE-encode one token per row and scatter its code and level through
    the block table, in place. The side state commits on active rows only."""
    code_t, level_t, scale, zero, num_levels = cpq_lib.cpq_encode_token(
        t.scale, t.zero, t.num_levels, t.prune_thr, x_t, cfg)
    act = rows.active
    t.scale.copy_(torch.where(act[:, None, None, None], scale, t.scale))
    t.zero.copy_(torch.where(act[:, None, None, None], zero, t.zero))
    t.num_levels.copy_(torch.where(act[:, None], num_levels, t.num_levels))
    write_token_pages(t.codes, rows.block_table, rows.lengths, act, code_t[:, 0])
    write_token_pages(t.level, rows.block_table, rows.lengths, act, level_t)
    return t


# ------------------------------------------------------------ prompt pack
#
# One-shot admission prefills a B=1 contiguous cache (core/kv_cache.py) of
# the bucket-padded prompt and scatters it into the slot's pages here, in
# place; escalation packs a re-compressed dense slot the same way.


def pack_dense(cache: PagedDenseKVCache, src: kvc.DenseKVCache,
               block_row: torch.Tensor) -> PagedDenseKVCache:
    write_prompt_pages(cache.k, block_row, src.k[0])
    write_prompt_pages(cache.v, block_row, src.v[0])
    return cache


def pack_x(cache: PagedXCache, src: kvc.XCache, block_row: torch.Tensor) -> PagedXCache:
    write_prompt_pages(cache.x, block_row, src.x[0])
    write_prompt_pages(cache.k_rope, block_row, src.k_rope[0])
    return cache


def pack_cpq_tensor(t: PagedCPQTensor, src: cpq_lib.CPQTensor, block_row: torch.Tensor,
                    slot: int) -> PagedCPQTensor:
    """Scatter a contiguous B=1 CPQTensor into slot ``slot``'s pages and
    side state, in place."""
    write_prompt_pages(t.codes, block_row, src.codes[0])
    write_prompt_pages(t.level, block_row, src.level[0])
    t.scale[slot] = src.scale[0]
    t.zero[slot] = src.zero[0]
    t.num_levels[slot] = src.num_levels[0]
    t.prune_thr[slot] = src.prune_thr[0]
    return t


def pack_cpq(cache: PagedCPQKVCache, src: CPQKVCache, block_row: torch.Tensor,
             slot: int) -> PagedCPQKVCache:
    pack_cpq_tensor(cache.k, src.k, block_row, slot)
    pack_cpq_tensor(cache.v, src.v, block_row, slot)
    return cache


def pack_retrieval(cache: PagedRetrievalCache, src: kvc.RetrievalCache,
                   block_row: torch.Tensor, slot: int) -> PagedRetrievalCache:
    write_prompt_pages(cache.k, block_row, src.k[0])
    write_prompt_pages(cache.v, block_row, src.v[0])
    write_prompt_pages(cache.proxy, block_row, src.proxy[0])
    cache.proxy_scale[slot] = src.proxy_scale[0]
    cache.proxy_zero[slot] = src.proxy_zero[0]
    return cache


def pack_into(rt_mode: str, cache, src, block_row: torch.Tensor, slot: int):
    """Mode dispatch of the admission pack (contiguous B=1 prefill -> a
    slot's pages); a tiered arena takes a dense source into its dense arm
    and a CPQ source into its CPQ arm."""
    if isinstance(cache, TieredPagedCache):
        if isinstance(src, kvc.DenseKVCache):
            pack_dense(cache.dense, src, block_row)
        else:
            pack_cpq(cache.cpq, src, block_row, slot)
        return cache
    if isinstance(cache, PagedDenseKVCache):
        return pack_dense(cache, src, block_row)
    if isinstance(cache, PagedXCache):
        return pack_x(cache, src, block_row)
    if isinstance(cache, PagedCPQKVCache):
        return pack_cpq(cache, src, block_row, slot)
    if isinstance(cache, PagedRetrievalCache):
        return pack_retrieval(cache, src, block_row, slot)
    raise unported_mode(rt_mode)


# --------------------------------------------------------------- traffic


def bytes_per_token(cache, page_size: int, cpq_cfg: Optional[CPQCfg] = None) -> float:
    """Per-token decode traffic of a paged arena: the payload (dense K and V,
    T1's X row and roped key slices, the CPQ accounting of
    ``cpq_bytes_per_token``, or T3's K and V plus one byte per proxy
    channel) plus the amortized block-table entry. A tiered
    arena counts its base tier."""
    overhead = 4.0 / page_size
    if isinstance(cache, TieredPagedCache):
        return bytes_per_token(cache.dense, page_size, cpq_cfg)
    if isinstance(cache, PagedDenseKVCache):
        payload = 2.0 * cache.k.shape[2] * cache.k.shape[3] * cache.k.element_size()
    elif isinstance(cache, PagedXCache):
        payload = (cache.x.shape[2] * cache.x.element_size()
                   + cache.k_rope.shape[2] * cache.k_rope.shape[3]
                   * cache.k_rope.element_size())
    elif isinstance(cache, PagedCPQKVCache):
        payload = 2.0 * cpq_lib.cpq_bytes_per_token(
            cpq_cfg or CPQCfg(), cache.k.codes.shape[2], cache.k.codes.shape[3])
    elif isinstance(cache, PagedRetrievalCache):
        payload = (2.0 * cache.k.shape[2] * cache.k.shape[3] * cache.k.element_size()
                   + cache.proxy.shape[2] * cache.proxy.shape[3])
    else:
        raise TypeError(type(cache))
    return payload + overhead


def arena_bytes(caches) -> int:
    """Total bytes of every arena tensor in a cache tree."""
    if isinstance(caches, torch.Tensor):
        return caches.numel() * caches.element_size()
    if isinstance(caches, dict):
        caches = list(caches.values())
    return sum(arena_bytes(c) for c in caches)


# ------------------------------------------------------- chunked prefill


def _slot_cpq(t: PagedCPQTensor, block_row: torch.Tensor, slot: int) -> cpq_lib.CPQTensor:
    """One slot's logical CPQTensor view (B=1): codes and levels gathered
    through its block row, side state sliced at ``slot``."""
    sl = slice(slot, slot + 1)
    return cpq_lib.CPQTensor(
        codes=gather_pages(t.codes, block_row[None]), scale=t.scale[sl],
        zero=t.zero[sl], level=gather_pages(t.level, block_row[None]),
        num_levels=t.num_levels[sl], prune_thr=t.prune_thr[sl])


def chunk_cpq_tensor(t: PagedCPQTensor, slot: int, block_row: torch.Tensor,
                     offset: int, valid: int, x_c: torch.Tensor, cfg: CPQCfg,
                     first: bool) -> PagedCPQTensor:
    """Compress one prompt chunk into a slot's code pages, in place: the
    first chunk fits the prune threshold and level 0 (the role the whole
    prompt plays in ``cpq_compress_prefill``); later chunks HQE-extend token
    by token like decode appends, never re-compressing earlier tokens.
    x_c (1, C, KV, D)."""
    sl = slice(slot, slot + 1)
    if first:
        codes, level, scale, zero, num_levels, thr = cpq_lib.cpq_fit_chunk(x_c, valid, cfg)
        t.prune_thr[slot] = thr[0]
    else:
        codes, level, scale, zero, num_levels = cpq_lib.cpq_encode_chunk(
            t.scale[sl], t.zero[sl], t.num_levels[sl], t.prune_thr[sl], x_c, valid, cfg)
    write_chunk_pages(t.codes, block_row, offset, valid, codes[0])
    write_chunk_pages(t.level, block_row, offset, valid, level[0])
    t.scale[slot] = scale[0]
    t.zero[slot] = zero[0]
    t.num_levels[slot] = num_levels[0]
    return t


def _chunk_mask_bias(n_prev: int, chunk: int, offset: int, valid: int,
                     device) -> torch.Tensor:
    """(C, n_prev + C) additive mask over [earlier-pages view | raw chunk]:
    earlier key j is live iff j < offset; chunk key i is live iff i < valid
    and i <= the query's chunk index."""
    prev = torch.arange(n_prev, device=device)
    idx = torch.arange(chunk, device=device)
    kp = torch.cat([prev, offset + idx])
    live = torch.cat([prev < offset, idx < valid])
    qp = offset + idx
    ok = live[None, :] & (kp[None, :] <= qp[:, None])
    return torch.where(ok, 0.0, core_attn.NEG_INF)


def cpq_chunk_prefill_attention(q, kt: PagedCPQTensor, vt: PagedCPQTensor,
                                block_row, slot: int, k_raw, v_raw, offset: int,
                                valid: int, scale: float) -> torch.Tensor:
    """Gather-path oracle of B6: earlier chunks are read back as dequantized
    codes (what decode reads), the current chunk attends its raw roped K/V
    causally. q (1, C, H, Dh); k_raw/v_raw (1, C, KV, Dh|Dv)."""
    k_hat = cpq_lib.cpq_dequant(_slot_cpq(kt, block_row, slot))
    v_hat = cpq_lib.cpq_dequant(_slot_cpq(vt, block_row, slot))
    k_all = torch.cat([k_hat.to(q.dtype), k_raw], dim=1)
    v_all = torch.cat([v_hat.to(q.dtype), v_raw], dim=1)
    bias = _chunk_mask_bias(k_hat.shape[1], q.shape[1], offset, valid, q.device)
    return core_attn.dense_attention(q, k_all, v_all, scale, causal=False,
                                     logit_bias=bias[None, :, None, :])


def _dense_chunk_attend(rt, k_pages, v_pages, block_row, offset: int, valid: int, q,
                        scale: float) -> torch.Tensor:
    """A chunk's C queries over the slot's K/V pages [0, offset + valid):
    B2 with ``rt.paged_kernels``, the gather path otherwise."""
    if rt.paged_kernels:
        return ops.paged_prefill(q, k_pages, v_pages, block_row, offset, valid, scale)
    return core_attn.dense_attention(
        q, gather_pages(k_pages, block_row[None]), gather_pages(v_pages, block_row[None]),
        scale, causal=True, q_offset=offset, kv_length=offset + valid)


def chunk_proxy(cache: PagedRetrievalCache, cfg, slot: int, block_row: torch.Tensor,
                offset: int, valid: int, k_c: torch.Tensor, first: bool) -> None:
    """Encode one prompt chunk's proxy codes into the slot's pages, in place.
    The first chunk fits the slot's proxy calibration on its own keys (the
    reference's behaviour: later chunks and decode appends encode with it,
    so a one-shot admission, which fits the whole prompt, can differ); the
    chunk's padding takes the last valid key first, so the per-channel
    min/max sees only real keys. k_c (1, C, KV, Dh) roped keys."""
    dp = cfg.proxy_dim or k_c.shape[-1]
    if first:
        idx = torch.arange(k_c.shape[1], device=k_c.device)
        edge = k_c[:, max(valid - 1, 0)][:, None]
        k_fit = torch.where((idx < valid)[None, :, None, None], k_c, edge)
        codes, pscale, pzero = ret_lib.fit_proxy(k_fit[..., :dp], cfg.proxy_bits)
        cache.proxy_scale[slot] = pscale[0]
        cache.proxy_zero[slot] = pzero[0]
    else:
        sl = slice(slot, slot + 1)
        codes = ret_lib.encode_proxy(k_c[..., :dp], cache.proxy_scale[sl],
                                     cache.proxy_zero[sl], cfg.proxy_bits)
    write_chunk_pages(cache.proxy, block_row, offset, valid, codes[0])


def _cpq_runtime(rt) -> AttentionRuntime:
    """The runtime of a tiered arena's CPQ arm."""
    return AttentionRuntime(mode="cpq", cpq=rt.cpq, paged_kernels=rt.paged_kernels)


def chunk_attend_paged(rt, cache, *, tier: int, first: bool, slot: int,
                       block_row: torch.Tensor, offset: int, valid: int,
                       q: torch.Tensor, k_c: torch.Tensor, v_c: torch.Tensor,
                       scale: float, x_c: Optional[torch.Tensor] = None,
                       k_rope_c: Optional[torch.Tensor] = None,
                       q_nope: Optional[torch.Tensor] = None,
                       q_rope: Optional[torch.Tensor] = None,
                       w_k_nope: Optional[torch.Tensor] = None,
                       w_v: Optional[torch.Tensor] = None):
    """Write one prompt chunk straight into the slot's arena pages, then
    attend the chunk's C queries over the slot's pages [0, offset + valid):
    the B2 (dense and T3), B4 (T1) or B6 (CPQ) kernel with
    ``rt.paged_kernels``, the gather path otherwise. A CPQ arena compresses
    the chunk as it goes (level-0 fit on the ``first`` chunk, HQE extension
    after) and reads earlier chunks through their codes; a T3 arena encodes
    the chunk's proxy codes the same way (``chunk_proxy``) and attends
    densely. A tiered arena runs the arm of the
    host-static admission ``tier``. q (1, C, H, Dh) roped; k_c/v_c
    (1, C, KV, Dh); slot/offset/valid host ints. The T1 arena takes instead
    x_c (1, C, Dm) normed block input, k_rope_c (1, C, KV, R), q_nope
    (1, C, H, Dn), q_rope (1, C, H, R), w_k_nope (Dm, KV, Dn) and w_v
    (Dm, KV, Dv). Returns (out (1, C, H, Dv), cache); rows past ``valid``
    are padding."""
    if isinstance(cache, TieredPagedCache):
        arm_rt, arm = (rt, cache.dense) if tier == 0 else (_cpq_runtime(rt), cache.cpq)
        out, _ = chunk_attend_paged(arm_rt, arm, tier=0, first=first, slot=slot,
                                    block_row=block_row, offset=offset, valid=valid,
                                    q=q, k_c=k_c, v_c=v_c, scale=scale)
        return out, cache
    if isinstance(cache, PagedDenseKVCache) and rt.mode == "dense":
        write_chunk_pages(cache.k, block_row, offset, valid, k_c[0])
        write_chunk_pages(cache.v, block_row, offset, valid, v_c[0])
        return _dense_chunk_attend(rt, cache.k, cache.v, block_row, offset, valid, q,
                                   scale), cache
    if isinstance(cache, PagedRetrievalCache) and rt.mode == "retrieval":
        chunk_proxy(cache, rt.retrieval, slot, block_row, offset, valid, k_c, first)
        write_chunk_pages(cache.k, block_row, offset, valid, k_c[0])
        write_chunk_pages(cache.v, block_row, offset, valid, v_c[0])
        # prefill COMPUTE is dense (T3 gates decode reads only): the K/V
        # pages hold the raw payload, so the dense chunk kernel serves them
        return _dense_chunk_attend(rt, cache.k, cache.v, block_row, offset, valid, q,
                                   scale), cache
    if isinstance(cache, PagedXCache) and rt.mode == "decomposed":
        write_chunk_pages(cache.x, block_row, offset, valid, x_c[0])
        write_chunk_pages(cache.k_rope, block_row, offset, valid, k_rope_c[0])
        if rt.paged_kernels:
            out = t1_ops.paged_decomposed_prefill(q_nope, q_rope, cache.x, cache.k_rope,
                                                  block_row, offset, valid, w_k_nope,
                                                  w_v, scale)
        else:
            qpos = offset + torch.arange(q.shape[1], device=q.device)
            out = decomposed_attention(
                q_nope, q_rope, gather_pages(cache.x, block_row[None]),
                gather_pages(cache.k_rope, block_row[None]), w_k_nope, w_v,
                offset + valid, scale, query_positions=qpos)
        return out, cache
    if isinstance(cache, PagedCPQKVCache) and rt.mode == "cpq":
        chunk_cpq_tensor(cache.k, slot, block_row, offset, valid, k_c, rt.cpq, first)
        chunk_cpq_tensor(cache.v, slot, block_row, offset, valid, v_c, rt.cpq, first)
        if rt.paged_kernels:
            out = cpq_ops.paged_cpq_prefill(q, cache.k, cache.v, k_c, v_c, slot,
                                            block_row, offset, valid, scale)
        else:
            out = cpq_chunk_prefill_attention(q, cache.k, cache.v, block_row, slot,
                                              k_c, v_c, offset, valid, scale)
        return out, cache
    raise _unported_cache(rt, cache)


# ------------------------------------------------------------ decode attend


def decode_attend_paged(rt, cache, rows: RowState, *, q: torch.Tensor,
                        k_t: torch.Tensor, v_t: torch.Tensor, scale: float,
                        x_t: Optional[torch.Tensor] = None,
                        k_rope_t: Optional[torch.Tensor] = None,
                        q_nope: Optional[torch.Tensor] = None,
                        q_rope: Optional[torch.Tensor] = None,
                        w_k_nope: Optional[torch.Tensor] = None,
                        w_v: Optional[torch.Tensor] = None):
    """Write one token per row through the block table, then attend with
    per-row lengths: the B1 (dense), B3 (T1), B5 (CPQ) or B7 (T3) kernel
    with ``rt.paged_kernels`` (the default), the gather path otherwise. A tiered
    arena runs both arms on every row, each arm's writes masked to its own
    tier's rows and the CPQ arm reading ``rows.alt_block_table``, and picks
    each row's output by tier, as the reference does. Inactive rows write
    the null page and their output is garbage the engine never reads.
    q (B, 1, H, Dh) roped; k_t/v_t (B, 1, KV, Dh). The T1 arena takes instead
    x_t (B, 1, Dm) normed block input, k_rope_t (B, 1, KV, R), q_nope
    (B, 1, H, Dn), q_rope (B, 1, H, R), w_k_nope (Dm, KV, Dn) and w_v
    (Dm, KV, Dv). Returns (out (B, 1, H, Dv), cache)."""
    if isinstance(cache, TieredPagedCache):
        rows_d = rows._replace(active=rows.active & (rows.tier == 0))
        rows_c = rows._replace(active=rows.active & (rows.tier == 1),
                               block_table=rows.alt_block_table)
        out_d, _ = decode_attend_paged(rt, cache.dense, rows_d, q=q, k_t=k_t,
                                       v_t=v_t, scale=scale)
        out_c, _ = decode_attend_paged(_cpq_runtime(rt), cache.cpq, rows_c, q=q,
                                       k_t=k_t, v_t=v_t, scale=scale)
        return torch.where((rows.tier == 1)[:, None, None, None], out_c, out_d), cache
    new_len = rows.lengths + rows.active.to(rows.lengths.dtype)
    if isinstance(cache, PagedDenseKVCache) and rt.mode == "dense":
        append_dense(cache, rows, k_t, v_t)
        if rt.paged_kernels:
            return ops.paged_decode(q, cache.k, cache.v, rows.block_table, new_len,
                                    scale), cache
        out = core_attn.dense_attention(
            q, gather_pages(cache.k, rows.block_table),
            gather_pages(cache.v, rows.block_table),
            scale, causal=False, kv_length=new_len)
        return out, cache
    if isinstance(cache, PagedRetrievalCache) and rt.mode == "retrieval":
        cfg = rt.retrieval
        dp = cfg.proxy_dim or k_t.shape[-1]
        code_t = ret_lib.encode_proxy(k_t[..., :dp], cache.proxy_scale, cache.proxy_zero,
                                      cfg.proxy_bits)
        append_dense(cache, rows, k_t, v_t)
        write_token_pages(cache.proxy, rows.block_table, rows.lengths, rows.active,
                          code_t[:, 0])
        if rt.paged_kernels:
            return retrieval_decode_paged(cache, rows.block_table, new_len, q, cfg,
                                          scale), cache
        out = ret_lib.retrieval_attention(
            q, gather_pages(cache.k, rows.block_table),
            gather_pages(cache.v, rows.block_table),
            gather_pages(cache.proxy, rows.block_table),
            cache.proxy_scale, cache.proxy_zero, new_len, cfg, scale)
        return out, cache
    if isinstance(cache, PagedXCache) and rt.mode == "decomposed":
        append_x(cache, rows, x_t, k_rope_t)
        if rt.paged_kernels:
            return t1_ops.paged_decomposed_decode(q_nope, q_rope, cache.x, cache.k_rope,
                                                  rows.block_table, new_len, w_k_nope,
                                                  w_v, scale), cache
        out = decomposed_attention(
            q_nope, q_rope, gather_pages(cache.x, rows.block_table),
            gather_pages(cache.k_rope, rows.block_table), w_k_nope, w_v, new_len, scale)
        return out, cache
    if isinstance(cache, PagedCPQKVCache) and rt.mode == "cpq":
        append_cpq_tensor(cache.k, rows, k_t, rt.cpq)
        append_cpq_tensor(cache.v, rows, v_t, rt.cpq)
        if rt.paged_kernels:
            return cpq_ops.paged_cpq_decode(q, cache.k, cache.v, rows.block_table,
                                            new_len, scale), cache
        out = core_attn.cpq_chunked_decode_attention(
            q, logical_cpq(cache.k, rows.block_table),
            logical_cpq(cache.v, rows.block_table), new_len, scale)
        return out, cache
    raise _unported_cache(rt, cache)


def retrieval_decode_paged(cache: PagedRetrievalCache, block_table: torch.Tensor,
                           lengths: torch.Tensor, q: torch.Tensor, cfg,
                           scale: float) -> torch.Tensor:
    """Kernel route of T3 decode: B7 scores every row's proxy code pages
    through the block table, ``select_topk`` picks over the same N =
    max_blocks * page positions as the gathered view, each picked logical
    position is translated to its (page, slot) through the block table, and
    only the picked K/V are read for the exact re-score and calibration. No
    logical view of K, V or the codes is formed. q (B, 1, H, Dh) roped;
    lengths (B,) after this step's append. Returns (B, 1, H, Dh)."""
    B, _, H, Dh = q.shape
    page, KV = cache.k.shape[1], cache.k.shape[2]
    dp = cfg.proxy_dim or Dh
    sp = t3_ops.paged_proxy_scores(q[:, 0, :, :dp], cache.proxy_scale, cache.proxy_zero,
                                   cache.proxy, block_table, lengths,
                                   block_table.shape[1] * page, q_scale=scale)[:, None]
    idx = ret_lib.select_topk(sp, lengths, cfg)                  # (B, 1, H, K) logical
    phys = torch.gather(block_table.long(), 1,
                        (idx // page).reshape(B, -1)).reshape(idx.shape)
    kvh = (torch.arange(H, device=q.device) // (H // KV))[None, None, :, None]
    slot = idx % page
    return ret_lib.attend_selected(q, cache.k[phys, slot, kvh], cache.v[phys, slot, kvh],
                                   idx, sp, lengths, scale)


def _unported_cache(rt, cache) -> NotImplementedError:
    if rt.mode in UNPORTED_MODES:
        return unported_mode(rt.mode)
    return NotImplementedError(
        f"attention mode {rt.mode!r} over a {type(cache).__name__} is not ported")


# ------------------------------------------------------- tier escalation (T2)


def compress_dense_slot(k_log: torch.Tensor, v_log: torch.Tensor, length: int,
                        cfg: CPQCfg) -> CPQKVCache:
    """Re-compress one slot's gathered dense K/V into CPQ tensors: the
    watermark policy's dense -> T2 migration. k_log/v_log (1, Npad, KV, Dh)
    logical views; positions at or past ``length`` are replaced by the last
    valid token, so the prune quantile and the level-0 range see only real
    data."""
    n = k_log.shape[1]
    last = min(max(length - 1, 0), n - 1)
    keep = (torch.arange(n, device=k_log.device) < length)[None, :, None, None]

    def valid_only(a):
        return torch.where(keep, a, a[:, last:last + 1])

    return CPQKVCache(cpq_lib.cpq_compress_prefill(valid_only(k_log), cfg, n),
                      cpq_lib.cpq_compress_prefill(valid_only(v_log), cfg, n),
                      kvc.host_length(length))
