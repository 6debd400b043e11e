"""Block-paged KV arenas for continuous batching, dense tier (the JAX
package's ``serving/paged_cache.py``).

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

Only the dense tier is ported. The other containers (T1 X pages, T2 CPQ
codes, T3 retrieval, the tiered arena) raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import attention as core_attn
from repro_torch.kernels.paged_attn import ops

NULL_PAGE = 0

UNPORTED_MODES = {"decomposed": "A13", "cpq": "A14", "retrieval": "A15",
                  "decomposed_cpq": "A16"}


def unported_mode(mode: str) -> NotImplementedError:
    return NotImplementedError(
        f"attention mode {mode!r} is not ported yet "
        f"(ROADMAP {UNPORTED_MODES.get(mode, 'A')}); the port serves 'dense'")


class RowState(NamedTuple):
    """Per-step request-row state of the decode step."""

    lengths: torch.Tensor      # (B,) int32 valid tokens per slot (= next position)
    block_table: torch.Tensor  # (B, max_blocks) int32 physical page ids; 0 = unmapped
    active: torch.Tensor       # (B,) bool: the row decodes this step (writes commit)
    tier: torch.Tensor         # (B,) int32: 0 = base tier (tiered arenas not ported)


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


# ------------------------------------------------------------- dense arena


class PagedDenseKVCache(NamedTuple):
    k: torch.Tensor  # (P, page, KV, Dh)
    v: torch.Tensor  # (P, page, KV, Dh)


def init_paged_dense(num_pages: int, page_size: int, kv: int, dh: int,
                     dtype=torch.bfloat16, device="cpu") -> PagedDenseKVCache:
    shape = (num_pages, page_size, kv, dh)
    return PagedDenseKVCache(torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device))


def append_dense(cache: PagedDenseKVCache, rows: RowState, k_t: torch.Tensor,
                 v_t: torch.Tensor) -> PagedDenseKVCache:
    """k_t/v_t: (B, 1, KV, Dh) new token per row, written in place."""
    write_token_pages(cache.k, rows.block_table, rows.lengths, rows.active, k_t[:, 0])
    write_token_pages(cache.v, rows.block_table, rows.lengths, rows.active, v_t[:, 0])
    return cache


def _require_dense(rt, cache) -> None:
    if rt.mode != "dense":
        raise unported_mode(rt.mode)
    if not isinstance(cache, PagedDenseKVCache):
        raise NotImplementedError(
            f"paged container {type(cache).__name__} is not ported yet")


def bytes_per_token(cache: PagedDenseKVCache, page_size: int) -> float:
    """Per-token decode traffic of the dense arena: K and V payload plus the
    amortized block-table entry."""
    return (2.0 * cache.k.shape[2] * cache.k.shape[3] * cache.k.element_size()
            + 4.0 / page_size)


def arena_bytes(caches) -> int:
    """Total bytes of every arena tensor in a cache tree."""
    if isinstance(caches, torch.Tensor):
        return caches.numel() * caches.element_size()
    if isinstance(caches, dict):
        caches = list(caches.values())
    return sum(arena_bytes(c) for c in caches)


# ------------------------------------------------------------- attention


def decode_attend_paged(rt, cache: PagedDenseKVCache, rows: RowState, *,
                        q: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor,
                        scale: float):
    """Write one token per row through the block table, then attend with
    per-row lengths: the B1 kernel with ``rt.paged_kernels`` (the default),
    the gather path otherwise. Inactive rows write the null page and their
    output is garbage the engine never reads. q (B, 1, H, Dh) roped;
    k_t/v_t (B, 1, KV, Dh). Returns (out (B, 1, H, Dv), cache)."""
    _require_dense(rt, cache)
    new_len = rows.lengths + rows.active.to(rows.lengths.dtype)
    cache = append_dense(cache, rows, k_t, v_t)
    if rt.paged_kernels:
        out = ops.paged_decode(q, cache.k, cache.v, rows.block_table, new_len, scale)
    else:
        out = core_attn.dense_attention(
            q, gather_pages(cache.k, rows.block_table),
            gather_pages(cache.v, rows.block_table),
            scale, causal=False, kv_length=new_len)
    return out, cache


def chunk_attend_paged(rt, cache: PagedDenseKVCache, *, block_row: torch.Tensor,
                       offset: int, valid: int, q: torch.Tensor,
                       k_c: torch.Tensor, v_c: torch.Tensor, scale: float):
    """Write one prompt chunk's K/V straight into the slot's pages, then
    attend the chunk's C queries over the pages [0, offset + valid): the B2
    kernel with ``rt.paged_kernels``, the gather path otherwise. q
    (1, C, H, Dh) roped; k_c/v_c (1, C, KV, Dh); offset/valid host ints.
    Returns (out (1, C, H, Dv), cache); rows past ``valid`` are padding."""
    _require_dense(rt, cache)
    write_chunk_pages(cache.k, block_row, offset, valid, k_c[0])
    write_chunk_pages(cache.v, block_row, offset, valid, v_c[0])
    if rt.paged_kernels:
        out = ops.paged_prefill(q, cache.k, cache.v, block_row, offset, valid, scale)
    else:
        out = core_attn.dense_attention(
            q, gather_pages(cache.k, block_row[None]),
            gather_pages(cache.v, block_row[None]),
            scale, causal=True, q_offset=offset, kv_length=offset + valid)
    return out, cache
