"""Speculative decoding over paged arenas: drafting and draft bookkeeping
(the JAX package's ``serving/speculative.py``).

Decode at low occupancy is bound by streaming the weights: every generated
token reads the whole weight set once. Speculative decoding spends that one
read on up to ``ServingCfg.spec_len`` candidate tokens:

1. Drafting costs no model: ``propose_ngram`` (prompt lookup) guesses the
   next tokens from the request's own context, the tokens that followed
   the latest earlier occurrence of its longest recurring suffix n-gram.
2. Draft rows alias the target's pages: ``Scheduler.begin_draft`` takes a
   reference on every page the row maps and allocates scratch pages only
   for the blocks the candidates land in. A partial frontier page is
   replaced by a scratch page seeded with its payload (the engine's page
   copy), so verification never writes into a page the target or a prefix
   sharer still owns; a rejected draft leaves the target's arena as it was.
3. Verification is one chunked paged forward pass
   (``model.verify_chunk_rows``: the chunked-prefill forward, B2 on the
   dense arena, with the logits of every position kept), so all k
   candidates are scored in a single model invocation.
4. Position ``L + i``'s logits are drawn through the request's own sampler
   at stream index ``num_generated + i``; a candidate is accepted iff it
   equals that draw. A committed token is therefore always the request's
   own ``fold_in(seed, token_index)`` draw (the argmax for greedy rows):
   streams are identical with speculation on and off.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class DraftState:
    """Page bookkeeping for one open draft (between ``begin_draft`` and
    ``commit_draft`` / ``abort_draft``). ``scratch[i]`` is the fresh page
    standing in for logical block ``blocks[i]`` in the draft's view of the
    row; ``aliased`` are the target's pages the draft holds one reference
    each on. ``copy_src >= 0`` names the partial frontier page whose payload
    must seed ``scratch[0]`` before the verify chunk runs."""

    tokens: list = field(default_factory=list)   # drafted candidate tokens
    scratch: list = field(default_factory=list)  # fresh pages, block order
    blocks: list = field(default_factory=list)   # logical blocks they cover
    aliased: list = field(default_factory=list)  # target pages incref'd
    copy_src: int = -1


def propose_ngram(ctx: np.ndarray, max_ngram: int, k: int) -> np.ndarray:
    """Prompt-lookup drafting: match the longest suffix n-gram (``n =
    max_ngram`` down to 1) against the earlier context; the latest
    occurrence wins and the ``k`` tokens that followed it are the draft.
    Returns (<= k,) int32, possibly empty (no n-gram recurs)."""
    ctx = np.asarray(ctx, np.int32)
    T = int(len(ctx))
    if k <= 0 or T < 2:
        return np.zeros((0,), np.int32)
    for n in range(min(max_ngram, T - 1), 0, -1):
        pat = ctx[T - n:]
        # windows start at 0 .. T-n-1: a match must be followed by at least
        # one context token
        hay = np.lib.stride_tricks.sliding_window_view(ctx[:T - 1], n)
        hits = np.nonzero((hay == pat[None, :]).all(axis=1))[0]
        if len(hits):
            start = int(hits[-1]) + n
            return ctx[start:start + k].copy()
    return np.zeros((0,), np.int32)
