"""Host-side continuous-batching scheduler (a copy of the JAX package's
``serving/scheduler.py``; the speculative-draft lifecycle ``begin_draft`` /
``commit_draft`` waits for ROADMAP A12, so ``Request.draft`` stays None).

Pure bookkeeping: an admission queue, a slot table, per-arena page
allocators, and the memory watermark policy. The engine (engine.py) consults
it every step and turns its decisions into cache operations.

Request lifecycle:

    queued --admit--> prefilling --finish_prefill--> running --retire--> done
                \\          |                           | preempt (out of
                 \\         | preempt /                 | pages: recompute-
                  <---------+--- deescalate ------------+ style, vLLM)

``prefilling`` is the chunked-admission window: the slot and its pages are
owned, but the prompt is still streaming into the arena chunk by chunk
(at most one chunk per engine tick, interleaved with the decode step) and
the row does not decode yet. The one-shot path (prefill_chunk == 0)
passes through it within a single engine tick.

Decision/mechanism split: WHICH request admits (and into which tier), which
slot holder a page-starved grower evicts, which dense row escalates under
critical pressure, and which T2 row de-escalates when pressure clears are
all delegated to a ``SchedulerPolicy`` (serving/policies.py; default
``FifoPolicy`` is decision-identical to the pre-policy scheduler). This
module keeps the mechanisms those decisions drive.

Watermark policy (free-page fraction of the DENSE base arena):

  * ``free < low_watermark``       new admissions are assigned the compressed
                                   tier (T2 CPQ arena) — the paper's
                                   "dynamically compress" applied at entry.
  * ``free < critical_watermark``  the longest running dense request is
                                   escalated in place: its K/V pages are
                                   re-compressed into the CPQ arena and the
                                   dense pages freed (engine runs the
                                   ``model.escalate_slot``).
  * ``free > high_watermark``      (policies with de-escalation enabled)
                                   an escalated row is restored to the dense
                                   tier by chunked re-admission — CPQ codes
                                   are lossy, so the dense K/V is rebuilt by
                                   the same exact context replay preemption
                                   uses.

Only dense -> T2 is escalatable post-hoc: T1 (decomposed) needs the
pre-projection operand X, which a dense cache never stored; T2 compresses
exactly what is cached. T1 tiers are chosen at engine construction instead.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.configs import ServingCfg
from repro_torch.serving.paged_cache import (NULL_PAGE, PageAllocator, defrag_plan,
                                       pages_needed)
from repro_torch.serving.prefix_index import PrefixIndex
from repro_torch.serving.request import SamplingParams, SloClass


class SchedulerConfigError(ValueError):
    pass


@dataclass
class Request:
    """One serving request. ``prompt`` is immutable; ``generated`` accumulates
    across preemptions (re-admission prefills prompt + generated)."""

    rid: int
    prompt: np.ndarray                      # (S,) int32
    max_new_tokens: int
    arrival: float = 0.0                    # decode-step time units
    # -- request-centric API (serving/request.py); None = legacy defaults
    # derived by the engine from its GenerationConfig on admission --
    sampling: Optional[SamplingParams] = None
    slo: Optional[SloClass] = None          # policies read via slo_of()
    stream: Optional[Callable] = None       # per-token RequestOutput callback
    session_id: Optional[str] = None        # replica-affinity key (router)
    # -- scheduler-owned state --
    state: str = "queued"                   # queued | prefilling | running | done
    slot: int = -1
    tier: int = 0                           # 0 = base, 1 = escalated/compressed
    pages: list = field(default_factory=list)
    generated: list = field(default_factory=list)
    length: int = 0                         # valid cache tokens
    prefill_target: int = 0                 # context tokens this admission owes
    token_steps: list = field(default_factory=list)  # emission tick per token
    admitted_step: int = -1
    first_token_step: int = -1
    done_step: int = -1
    finish_reason: str = ""
    preemptions: int = 0
    escalated: bool = False
    deescalations: int = 0
    # prefix sharing bookkeeping: tokens mounted from the index at the LAST
    # admission (zero arena writes; chunked prefill starts at this offset)
    # and the high-water block count already registered into the index
    shared_tokens: int = 0
    indexed_blocks: int = 0
    cow_copies: int = 0
    # set between deescalate() and the re-admission it exists for: the
    # recovery replay must land DENSE (policies pin its tier; falling back
    # to T2 would be a full-context recompute for nothing)
    recovering: bool = False
    # deadline-aware shedding (policies.derive_deadlines): ABSOLUTE engine
    # ticks; math.inf = none. Blown budgets retire the request with
    # finish_reason "timeout" at the next tick boundary. ttft_deadline only
    # applies while no first token has been emitted.
    deadline: float = float("inf")
    ttft_deadline: float = float("inf")
    # open speculative draft: scratch pages + aliased-page references
    # between begin_draft and commit/abort (not ported: stays None). Any
    # release path (retire/preempt/escalate/deescalate) aborts it first.
    draft: Optional[object] = None

    @property
    def context(self) -> np.ndarray:
        """Tokens to prefill on (re-)admission."""
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)]).astype(np.int32)

    @property
    def num_generated(self) -> int:
        return len(self.generated)

    @property
    def stop_ids(self) -> frozenset:
        return (frozenset(self.sampling.stop_token_ids)
                if self.sampling is not None else frozenset())


class Scheduler:
    def __init__(self, serving: ServingCfg, tiered: bool = False,
                 policy=None, share_prefix: Optional[bool] = None):
        from repro_torch.serving.policies import FifoPolicy

        self.cfg = serving
        self.tiered = tiered
        self.policy = policy if policy is not None else FifoPolicy()
        if serving.max_len < 2:
            raise SchedulerConfigError("max_len < 2")
        self.dense_alloc = PageAllocator(serving.num_pages)
        self.cpq_alloc = PageAllocator(serving.escalated_pages) if tiered else None
        # prefix sharing: a WEAK index over the BASE (dense-tier) arena only
        # — CPQ / retrieval pages dequantize through per-slot side state
        # fitted to one request's stream, so mounting them elsewhere would
        # break bit-parity. The engine passes its own gate (chunked modes
        # only); direct constructions default to ServingCfg.share_prefix.
        if share_prefix is None:
            share_prefix = getattr(serving, "share_prefix", False)
        self.prefix_index = (PrefixIndex(serving.page_size)
                             if share_prefix else None)
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * serving.num_slots
        S, M = serving.num_slots, serving.max_blocks_per_slot
        self.block_tables = np.zeros((S, M), np.int32)       # base arena
        self.alt_block_tables = np.zeros((S, M), np.int32) if tiered else None
        self.lengths = np.zeros((S,), np.int32)
        self.tiers = np.zeros((S,), np.int32)
        self.stats = {"admitted": 0, "retired": 0, "preemptions": 0,
                      "escalations": 0, "deescalations": 0,
                      "peak_dense_pages": 0, "defrags": 0,
                      "prefix_hits": 0, "shared_prefix_tokens": 0,
                      "shared_prefix_pages": 0, "cow_copies": 0,
                      "timeouts": 0, "spec_steps": 0, "spec_drafted": 0,
                      "spec_accepted": 0}

    # ------------------------------------------------------------- queries

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def occupied(self) -> list[Request]:
        """Every slot holder — decoding AND mid-prefill (all own pages)."""
        return [r for r in self.slots if r is not None]

    def running(self) -> list[Request]:
        """Rows that decode this step (prefill finished)."""
        return [r for r in self.slots if r is not None and r.state == "running"]

    def prefilling(self) -> list[Request]:
        """Chunked admissions still streaming their prompt, oldest first."""
        rows = [r for r in self.slots
                if r is not None and r.state == "prefilling"]
        return sorted(rows, key=lambda r: r.admitted_step)

    def active_mask(self) -> np.ndarray:
        return np.array([r is not None and r.state == "running"
                         for r in self.slots], bool)

    def free_frac(self) -> float:
        return self.dense_alloc.num_free / max(self.dense_alloc.num_pages - 1, 1)

    def arena_stats(self) -> dict:
        """Public allocator/defrag counters (the engine folds these into its
        serve() stats; bench_serving and the sharded watermark read them here
        instead of reaching into ``dense_alloc`` / ``cpq_alloc``). All counts
        are LOGICAL pages — under a model-sharded mesh every logical page is
        one per-device slice, so fractions (and the watermark thresholds
        derived from them) are mesh-invariant."""
        out = {
            "dense_pages_used": self.dense_alloc.num_used,
            "dense_pages_free": self.dense_alloc.num_free,
            "dense_arena_utilization": self.dense_alloc.utilization,
            "defrags": self.stats["defrags"],
        }
        if self.cpq_alloc is not None:
            out["cpq_pages_used"] = self.cpq_alloc.num_used
            out["cpq_arena_utilization"] = self.cpq_alloc.utilization
        if self.prefix_index is not None:
            out["prefix_index_pages"] = len(self.prefix_index)
            out["prefix_hits"] = self.stats["prefix_hits"]
        return out

    def plan_defrag(self):
        """Compact the BASE (dense-tier) arena: relabel every mapped page
        onto the lowest physical ids (paged_cache.defrag_plan), rewrite the
        block tables and every tier-0 request's page list, and rebuild the
        allocator free list. SHARED pages (refcount > 1) compact FIRST —
        every sharer's sequential page reads start from the same dense
        low-id cluster, so the hottest pages get the tightest locality.
        Returns the (num_pages,) permutation to apply to every base-arena
        page pool (``perm[new_id] = old_id``), or None when the arena is
        already compact. Escalated (tier-1) pages live in the CPQ arena and
        are untouched."""
        if any(r.draft is not None for r in self.occupied()):
            # an open speculative draft owns scratch pages that are
            # invisible to the block tables — relabeling now would mark
            # them free (DoubleFree in relabel). Drafts close within the
            # engine tick; compaction just waits one tick.
            return None
        shared = {p for p in range(1, self.cfg.num_pages)
                  if self.dense_alloc.refcount(p) > 1}
        perm, new_bt, free = defrag_plan(self.block_tables,
                                         self.cfg.num_pages, shared=shared)
        if all(int(p) == i for i, p in enumerate(perm)):
            return None
        remap = {int(old): new for new, old in enumerate(perm)}
        self.block_tables[:] = new_bt
        for r in self.occupied():
            if r.tier == 0:
                r.pages = [remap[int(p)] for p in r.pages]
        # shared pages move ONCE (defrag_plan dedups via its ``seen`` set)
        # and every owner's table entry was rewritten above; the allocator
        # carries each page's refcount to its new id and the prefix index
        # renames its physical ids (keys are content-addressed)
        self.dense_alloc.relabel(perm, free)
        if self.prefix_index is not None:
            self.prefix_index.relabel(remap)
        self.stats["defrags"] += 1
        return perm

    def _arena(self, tier: int) -> PageAllocator:
        return self.cpq_alloc if tier == 1 else self.dense_alloc

    def _tables(self, tier: int) -> np.ndarray:
        return self.alt_block_tables if tier == 1 else self.block_tables

    # ----------------------------------------------------------- admission

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.cfg.max_len:
            raise SchedulerConfigError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new {req.max_new_tokens} exceeds max_len {self.cfg.max_len}")
        req.state = "queued"
        self.queue.append(req)

    def admit_next(self, now: float, step: int) -> Optional[Request]:
        """Admit the policy's pick into a vacated slot. The policy chooses
        WHICH arrived request and WHICH tier (``select_admission``; the
        default FifoPolicy requires the queue head to be admissible — no
        head-of-line bypass); this method performs the mechanics."""
        if not self.queue:
            return None
        try:
            slot = self.slots.index(None)
        except ValueError:
            return None
        sel = self.policy.select_admission(self, now)
        if sel is None:
            return None
        req, tier = sel
        arena = self._arena(tier)
        ctx = req.context
        need = pages_needed(len(ctx), self.cfg.page_size)
        # prefix sharing (base tier only): mount already-resident pages for
        # the longest indexed prefix — refcount bumps, ZERO arena writes —
        # and stream chunked prefill over the unshared tail only. The match
        # is capped at len(ctx)-1 so the first token's logits always come
        # from a computed tail chunk (token-exactness).
        shared_pages: list[int] = []
        shared_tokens = 0
        if tier == 0 and self.prefix_index is not None:
            # heal first: a retirement may have just forgotten entries whose
            # content is still resident in OTHER rows' pages (their earlier
            # registrations deduped against the retiree's). Re-registering
            # live rows is watermark-cheap and closes the one-tick window
            # between a registrant's release and the next chunk pump.
            for live in self.slots:
                if live is not None:
                    self.register_prefix(live)
            shared_pages, shared_tokens = self.prefix_index.match(ctx)
        self.queue.remove(req)
        req.recovering = False
        fresh = arena.alloc(need - len(shared_pages))
        for p in shared_pages:
            arena.incref(p)
        req.pages = [int(p) for p in shared_pages] + fresh
        req.state, req.slot, req.tier = "prefilling", slot, tier
        req.prefill_target = len(ctx)
        req.length = shared_tokens  # prefix pre-mounted; chunks grow the tail
        req.shared_tokens = shared_tokens
        req.indexed_blocks = 0
        if req.admitted_step < 0:
            req.admitted_step = step
        self.slots[slot] = req
        tables = self._tables(tier)
        tables[slot, :] = NULL_PAGE
        tables[slot, :need] = req.pages
        if self.tiered:
            self._tables(1 - tier)[slot, :] = NULL_PAGE
        self.lengths[slot] = shared_tokens
        self.tiers[slot] = tier
        if shared_tokens:
            self.stats["prefix_hits"] += 1
            self.stats["shared_prefix_tokens"] += shared_tokens
            self.stats["shared_prefix_pages"] += len(shared_pages)
        self.stats["admitted"] += 1
        self.stats["peak_dense_pages"] = max(self.stats["peak_dense_pages"],
                                             self.dense_alloc.num_used)
        return req

    def note_chunk(self, req: Request, n_tokens: int) -> None:
        """A prompt chunk of ``n_tokens`` valid tokens landed in the arena."""
        assert req.state == "prefilling"
        req.length = min(req.length + n_tokens, req.prefill_target)
        self.lengths[req.slot] = req.length

    def finish_prefill(self, req: Request) -> None:
        """The full context is in the arena: the row starts decoding."""
        assert req.state == "prefilling"
        req.state = "running"
        req.length = req.prefill_target
        self.lengths[req.slot] = req.length

    # -------------------------------------------------------------- growth

    def ensure_writable(self, req: Request) -> bool:
        """Map a page for the next token write (position ``req.length``).
        False => the tier arena is out of pages (caller preempts/escalates)."""
        blk = req.length // self.cfg.page_size
        if blk >= self.cfg.max_blocks_per_slot:
            return False  # context ceiling — caller retires
        tables = self._tables(req.tier)
        if tables[req.slot, blk] != NULL_PAGE:
            return True
        arena = self._arena(req.tier)
        if not arena.can_alloc(1):
            return False
        page = arena.alloc(1)
        req.pages += page
        tables[req.slot, blk] = page[0]
        self.stats["peak_dense_pages"] = max(self.stats["peak_dense_pages"],
                                             self.dense_alloc.num_used)
        return True

    # ------------------------------------------------- speculative drafts

    def abort_draft(self, req: Request) -> None:
        """Close the draft accepting nothing: drop the aliased references
        and free the scratch pages. The target row is untouched — reject
        costs zero arena writes."""
        d = req.draft
        if d is None:
            return
        self._free_pages(0, d.aliased)
        self._free_pages(0, d.scratch)
        req.draft = None

    # ------------------------------------------------ prefix sharing / COW

    def _free_pages(self, tier: int, pages) -> None:
        """The ONE funnel every page release goes through: the allocator
        decrefs, and pages whose refcount hit zero leave the prefix index
        (free-list membership <=> refcount 0 <=> not indexed)."""
        released = self._arena(tier).free(pages)
        if tier == 0 and self.prefix_index is not None:
            for p in released:
                self.prefix_index.forget(p)

    def cow_plan(self, req: Request) -> Optional[tuple[int, int]]:
        """Copy-on-write guard, called BEFORE any write into the block that
        holds position ``req.length`` (the next chunk/decode write target).

        A shared mapping there (refcount > 1) splits: allocate a private
        page, remap this owner's block-table entry, decref the shared page
        — the caller must then run the page copy ``src -> dst``
        before writing. A lone-owner mapping that is still REGISTERED is
        about to stop matching its key (the write diverges mid-page), so it
        just leaves the index in place. Raises ``PageAllocator.OutOfPages``
        when the split cannot get a page (caller applies the same pressure
        valves as page growth). Returns (src, dst) or None."""
        if req.tier != 0 or req.slot < 0:
            return None
        blk = req.length // self.cfg.page_size
        if blk >= self.cfg.max_blocks_per_slot:
            return None  # growth's length-cap path owns this case
        page = int(self.block_tables[req.slot, blk])
        if page == NULL_PAGE:
            return None
        if self.dense_alloc.refcount(page) <= 1:
            # private already — but a registered page's content is about to
            # diverge from its key past position ``length``: unregister
            if self.prefix_index is not None:
                self.prefix_index.forget(page)
            return None
        dst = self.dense_alloc.alloc(1)[0]
        self.block_tables[req.slot, blk] = dst
        req.pages[req.pages.index(page)] = dst
        self._free_pages(0, [page])  # decref; other owners keep the original
        req.cow_copies += 1
        self.stats["cow_copies"] += 1
        self.stats["peak_dense_pages"] = max(self.stats["peak_dense_pages"],
                                             self.dense_alloc.num_used)
        return page, dst

    def register_prefix(self, req: Request) -> None:
        """Register every newly COMPLETED page of ``req``'s context into the
        prefix index (full pages are immutable, hence safe to share). Called
        after prefill finishes and whenever decode fills a page — so a
        multi-turn follow-up sharing this request's whole history mounts it
        from the index. Registration never takes a reference: the index is
        weak, and entries die with the page (``_free_pages``)."""
        if (self.prefix_index is None or req.tier != 0 or req.slot < 0
                or req.state not in ("prefilling", "running")):
            return
        ctx = req.context
        full = min(req.length, len(ctx)) // self.cfg.page_size
        if full > req.indexed_blocks:
            req.indexed_blocks = self.prefix_index.insert(
                ctx, req.pages, req.indexed_blocks, full)

    # ---------------------------------------------------- retire / preempt

    def _release(self, req: Request) -> None:
        self.abort_draft(req)
        self._free_pages(req.tier, req.pages)
        req.pages = []
        req.indexed_blocks = 0
        slot = req.slot
        self.block_tables[slot, :] = NULL_PAGE
        if self.tiered:
            self.alt_block_tables[slot, :] = NULL_PAGE
        self.lengths[slot] = 0
        self.tiers[slot] = 0
        self.slots[slot] = None
        req.slot = -1

    def retire(self, req: Request, step: int, reason: str) -> None:
        self._release(req)
        req.state, req.done_step, req.finish_reason = "done", step, reason
        req.tier = 0
        self.stats["retired"] += 1

    def preempt(self, req: Request) -> None:
        """Recompute-style preemption: free everything, requeue at the FRONT
        (its context re-prefills on the next admission)."""
        self._release(req)
        req.state, req.tier, req.length = "queued", 0, 0
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self.queue.appendleft(req)

    def preemption_victim(self, exclude: Request) -> Optional[Request]:
        """Policy-chosen eviction victim among slot holders (decoding or
        mid-prefill — both own pages) in the SAME arena the blocked request
        allocates from. Default (fifo): the youngest."""
        return self.policy.preemption_victim(self, exclude)

    # ------------------------------------------------- escalation / recovery

    def escalation_candidate(self) -> Optional[Request]:
        """Under critical pressure: the policy's pick among running dense
        requests whose compressed footprint fits the CPQ arena. Default
        (fifo): the longest."""
        if not self.tiered:
            return None
        return self.policy.escalation_candidate(self)

    def deescalation_candidate(self) -> Optional[Request]:
        """When dense pressure clears (free fraction above the HIGH
        watermark): the policy's pick among escalated (T2) running rows
        whose full context fits the dense arena, or None (default fifo:
        de-escalation is opt-in)."""
        if not self.tiered:
            return None
        return self.policy.deescalation_candidate(self)

    def deescalate(self, req: Request) -> None:
        """T2 -> dense recovery via chunked re-admission: CPQ codes are
        lossy, so the dense K/V is rebuilt by replaying the request's
        ``prompt + generated`` context through the normal (chunked)
        admission path. Mechanically a preemption — free everything, requeue
        at the FRONT — tracked separately in the stats; the re-admission
        lands dense because the policy only volunteers rows when the free
        fraction sits above ``high_watermark`` (hysteresis)."""
        assert req.tier == 1 and req.slot >= 0, "de-escalating a dense row"
        self._release(req)
        req.state, req.tier, req.length = "queued", 0, 0
        req.deescalations += 1
        req.recovering = True
        self.stats["deescalations"] += 1
        self.queue.appendleft(req)

    def apply_escalation(self, req: Request) -> tuple[np.ndarray, np.ndarray]:
        """Move ``req``'s page ownership dense -> CPQ arena. Returns
        (dense_row, cpq_row) block rows for the re-compression (the
        dense_row is the PRE-escalation mapping the gather reads)."""
        assert self.tiered and req.tier == 0
        self.abort_draft(req)   # drafts are a tier-0 feature
        slot = req.slot
        dense_row = self.block_tables[slot].copy()
        need = pages_needed(req.length + 1, self.cfg.page_size)
        new_pages = self.cpq_alloc.alloc(need)
        # shared dense pages just decref (another owner may keep them live);
        # the re-compressed CPQ copy is private to this slot either way
        self._free_pages(0, req.pages)
        req.pages = new_pages
        req.indexed_blocks = 0
        req.tier, req.escalated = 1, True
        self.tiers[slot] = 1
        self.block_tables[slot, :] = NULL_PAGE
        self.alt_block_tables[slot, :] = NULL_PAGE
        self.alt_block_tables[slot, :need] = new_pages
        self.stats["escalations"] += 1
        return dense_row, self.alt_block_tables[slot].copy()