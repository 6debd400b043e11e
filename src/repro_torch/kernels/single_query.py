"""Launch plan of the kernels that merge key splits in their last block (B8's
decode route and B10, ``flash_attn/csrc/single_query.cuh``; the tensor-core
route of B2 and B6, ``paged_attn/csrc/paged_chunk.cuh``): how the key range
is split, and the counters on which the last block of each unit learns that
it merges the splits.

The splits are sized so that the grid holds at most ``BLOCKS_PER_SM``
blocks per SM (all resident at once: the kernels take up to 128 registers a
thread at the served shapes), each with at least ``MIN_SPLIT_KEYS`` keys
(its four warps then have a full batch of loads in flight each). The counters live in one zeroed
int32 buffer per device, grown when a launch needs more; each launch leaves
the counters it used at zero. Launches that share the buffer run on one
stream, one after another, as the engines issue them.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

BLOCKS_PER_SM = 4
MAX_HEAD_DIM = 256   # Dh and Dv: multiples of the 16-byte chunk up to this
MIN_SPLIT_KEYS = 64
SPLIT_ALIGN = 16

_counters: dict[torch.device, torch.Tensor] = {}


@dataclasses.dataclass(frozen=True)
class Whole:
    """The whole call a serving mesh's model shard launches a part of: the
    shard (``shard``) holds 1/``heads`` of the call's kv (and query) heads
    and 1/``rope_groups`` of a T1 call's roped key groups (1 where those
    are held whole). The plans that size their splits by the units they can
    fill (B1's ring, the tensor-core chunks of B2, B4 and B6, B3) take it,
    so a shard splits each head's keys as the whole call does, and B3 adds
    each head's roped term in the cluster rank that adds it in the whole
    call: every head's arithmetic is the whole call's, bit for bit.
    ``serving/sharded.py`` makes one for each shard's call; ``WHOLE`` is
    a call that is whole."""

    heads: int = 1
    rope_groups: int = 1
    shard: int = 0


WHOLE = Whole()


def plan(pairs: int, length: int, device: torch.device, min_keys: int = MIN_SPLIT_KEYS,
         max_splits: int | None = None) -> tuple[int, int]:
    """(splits, keys per split) for ``pairs`` (row, kv head, head group)
    units over ``length`` keys each: splits of at least ``min_keys`` keys,
    and at most ``max_splits`` of them."""
    sms = _sm_count(device)
    most = max(1, -(-length // min_keys))
    splits = min(most, max(1, BLOCKS_PER_SM * sms // pairs), max_splits or most)
    keys = -(-max(length, 1) // splits)
    keys = -(-keys // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-max(length, 1) // keys), keys


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def counters(n: int, device: torch.device) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters on ``device``, kept between
    launches."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf
