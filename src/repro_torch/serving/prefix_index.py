"""Prefix index over page-aligned token prefixes (prefix sharing / COW).

At millions of users most prompts open with a shared system prefix or a
multi-turn chat history already served once — the paper's KV-growth
bottleneck is mostly DUPLICATED cache. This index maps page-aligned token
prefixes to the physical pages that already hold their K/V, so admission can
mount a request's shared prefix as refcount bumps (zero arena writes) and
chunked prefill streams only the unshared tail.

Structure: a hash-consed radix over FULL pages of token ids. Every node is
keyed by the byte string of the WHOLE prefix up to and including its page
(int32 little-endian), so a key is content-addressed — independent of which
request registered it and of the physical page id currently serving it. A
parent->children edge set supports the one partial match allowed per lookup
(divergence MID-page: the request mounts a full registered page but only its
first j < page_size tokens; the first tail write then copy-on-writes it).

The index is WEAK — it holds no page references and never contributes to a
refcount. That keeps the serving invariant crisp (a page's refcount equals
the number of block-table entries mapping it; free-list membership <=>
refcount 0, property-tested in tests/test_serving_prefix.py). The owner
(the scheduler) must therefore:

  * ``forget(page)`` when a page's refcount hits zero (the allocator's
    ``free`` returns exactly those), and when a lone owner is about to
    overwrite a registered page in place (content would no longer match);
  * ``relabel(remap)`` when defrag renames physical pages.

Unreachable entries are self-healing: dropping a node orphans its subtree,
but keys are full-prefix content hashes, so re-registering the parent prefix
under any page makes the (still content-correct) descendants reachable again.

Only FULL pages register: a full page is immutable under normal operation
(its owner writes at positions >= its length only), which is what makes the
mapped payload safe to share by construction.
"""
from __future__ import annotations

import numpy as np

_ROOT = b""


class PrefixIndex:
    """Weak page-aligned token-prefix -> physical-page index (one arena)."""

    def __init__(self, page_size: int):
        assert page_size >= 1
        self.page_size = page_size
        self._page_of: dict[bytes, int] = {}   # prefix key -> physical page
        self._key_of: dict[int, bytes] = {}    # physical page -> its key
        self._children: dict[bytes, set[bytes]] = {}  # parent key -> child keys
        self.hits = 0        # lookups that matched >= 1 token
        self.misses = 0

    def __len__(self) -> int:
        return len(self._page_of)

    @staticmethod
    def _key(ctx: np.ndarray, n_tokens: int) -> bytes:
        return np.ascontiguousarray(ctx[:n_tokens], dtype="<i4").tobytes()

    # ------------------------------------------------------------- lookup

    def match(self, context) -> tuple[list[int], int]:
        """Longest indexed prefix of ``context``: the chain of full-page
        matches plus at most one partial match into a child page (shared
        for reads — attention masks by length — and COW'd at first write).
        Capped at ``len(context) - 1`` tokens so at least one tail token
        remains to prefill (the first emitted token's logits must come from
        a computed tail chunk). Returns (pages in block order, tokens)."""
        ctx = np.asarray(context, np.int32)
        ps = self.page_size
        limit = len(ctx) - 1
        pages: list[int] = []
        shared = 0
        key = _ROOT
        while shared + ps <= limit:
            nxt = self._key(ctx, shared + ps)
            page = self._page_of.get(nxt)
            if page is None:
                break
            pages.append(page)
            shared += ps
            key = nxt
        # one partial continuation: the child page sharing the longest
        # non-empty token run with the tail (mid-page divergence)
        best_page, best_j = None, 0
        for ck in self._children.get(key, ()):
            page = self._page_of.get(ck)
            if page is None:
                continue  # orphaned edge (child re-registers it later)
            blk = np.frombuffer(ck, dtype="<i4")[shared:]
            cap = min(len(blk), limit - shared)
            j = 0
            while j < cap and blk[j] == ctx[shared + j]:
                j += 1
            if j > best_j:
                best_page, best_j = page, j
        if best_page is not None:
            pages.append(best_page)
            shared += best_j
        self.hits += bool(shared)
        self.misses += not shared
        return pages, shared

    # ----------------------------------------------------------- maintain

    def insert(self, context, pages, start_block: int, end_block: int) -> int:
        """Register blocks ``[start_block, end_block)`` of a request whose
        cache holds ``context`` with its block-ordered physical ``pages``.
        Returns the caller's new durable watermark: the first block index NOT
        covered by an entry the caller can rely on. Entries pointing at the
        caller's OWN pages are durable (they live exactly as long as the
        caller holds the page), so the watermark advances past them; a key
        already held by a DIFFERENT page (a concurrent owner of the same
        prefix registered first) keeps its incumbent — dedup — but stops the
        walk WITHOUT advancing, so the caller retries that block on its next
        call and re-registers its own copy if the incumbent has since been
        forgotten. That retry is what lets the index survive the original
        registrant's retirement while equal-content pages are still
        resident."""
        ctx = np.asarray(context, np.int32)
        ps = self.page_size
        for b in range(start_block, end_block):
            page = int(pages[b])
            key = self._key(ctx, (b + 1) * ps)
            incumbent = self._page_of.get(key)
            if incumbent == page:
                continue  # already ours (e.g. mounted FROM the index)
            if incumbent is not None or page in self._key_of:
                return b  # foreign incumbent (or page answers another key)
            self._page_of[key] = page
            self._key_of[page] = key
            self._children.setdefault(key[:-4 * ps], set()).add(key)
        return end_block

    def forget(self, page: int) -> bool:
        """Drop one page's registration (refcount hit zero, or its lone
        owner is about to overwrite it in place). Descendant entries stay:
        they are unreachable until the same prefix re-registers, at which
        point they are reachable AND still content-correct."""
        key = self._key_of.pop(int(page), None)
        if key is None:
            return False
        del self._page_of[key]
        parent = key[:-4 * self.page_size]
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(key)
            if not kids:
                del self._children[parent]
        return True

    def relabel(self, remap) -> None:
        """Defrag renamed physical pages: ``remap[old_id] -> new_id`` (dict
        or array). Keys are content-addressed and do not change."""
        self._page_of = {k: int(remap[p]) for k, p in self._page_of.items()}
        self._key_of = {int(remap[p]): k for p, k in self._key_of.items()}

    def registered_pages(self) -> set[int]:
        return set(self._key_of)
