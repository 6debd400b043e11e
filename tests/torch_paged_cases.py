"""Paged-attention test layouts shared by the port's kernel tests, free of
JAX so that the CUDA cases also run where JAX is not installed.
``pool_layout`` is ``test_kernels_paged._pool_layout`` verbatim. The engine
parity helpers at the end (``smoke_pair``, ``serve_pair``) import JAX when
called, never at import."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

DECODE_CASES = [  # seed, page, nb, B, KV, g, Dh
    (0, 4, 4, 3, 2, 1, 16),
    (1, 1, 3, 2, 1, 4, 8),    # page_size 1: one token per page
    (2, 8, 2, 2, 4, 1, 32),
    (3, 5, 4, 4, 2, 4, 16),   # odd page size, partial last pages
    (4, 4, 1, 1, 1, 1, 8),    # single block
    (5, 16, 4, 3, 4, 4, 64),  # the served page size and head dim
]

PREFILL_CASES = [  # seed, offset, valid, KV, g
    (0, 0, 8, 2, 1), (1, 8, 8, 2, 4), (2, 8, 3, 1, 4), (3, 4, 1, 2, 1),
    (4, 12, 5, 4, 1), (5, 21, 8, 2, 4),
]

# chunks at the served shape and around it, for B2 (prefill_inputs) and B6
# (cpq_prefill_inputs): qwen1.5-0.5b's chunk of 16 tokens over pages of 16
# at Dh 64 and G 1 (a first chunk, a mid-page offset, valid < C), a GQA
# chunk (G 4, Dh 128: four 16-row tiles per kv head), a chunk of 8 (R = 8 <
# 16 query rows) and one past 512 keys, which the card's tensor-core route
# splits across blocks
SERVED_PREFILL_CASES = [  # seed, offset, valid, KV, g, Dh, page, nb, C
    (10, 0, 16, 16, 1, 64, 16, 32, 16),
    (11, 213, 16, 16, 1, 64, 16, 32, 16),
    (12, 300, 11, 16, 1, 64, 16, 32, 16),
    (13, 150, 16, 2, 4, 128, 16, 16, 16),
    (14, 37, 8, 4, 1, 64, 16, 8, 8),
    (15, 901, 10, 4, 1, 64, 16, 64, 16),
]


# B2 at the speculative verify chunk's shapes: C = spec_len + 1 query rows
# (2, 5, 9), valid = C or fewer, at offsets 0, 1, 15, 17 and the block
# ceiling less C, over a draft's block row (verify_inputs), at qwen1.5-0.5b's
# widths (KV 16, G 1) and at G 2
VERIFY_CASES = [  # seed, offset, valid, KV, g, C
    (20 + i, off if off >= 0 else 1024 + off, valid, 16 // g, g, C)
    for i, (off, valid, g, C) in enumerate(
        (off, valid, g, C) for C, valid in ((2, 2), (5, 5), (9, 9), (9, 3))
        for g in (1, 2) for off in (0, 1, 15, 17, -C))]


def verify_inputs(seed, offset, valid, KV, g, C, Dh=64, page=16, nb=64):
    """q, k/v pools (null page poisoned) and a draft's block row: another
    slot's pages for the history and scratch pages from the frontier block
    on, the first holding the frontier page's payload; offset, valid, scale."""
    rng = np.random.default_rng(seed)
    P = 2 * nb + 8
    kp = rng.normal(size=(P, page, KV, Dh)).astype(np.float32)
    vp = rng.normal(size=(P, page, KV, Dh)).astype(np.float32)
    kp[0] = vp[0] = 1e3
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    first, last = offset // page, (offset + valid - 1) // page
    row = perm[:nb].copy()
    scratch = perm[nb:nb + last - first + 1]
    if offset % page:
        kp[scratch[0]], vp[scratch[0]] = kp[row[first]], vp[row[first]]
    row[first:last + 1] = scratch
    q = rng.normal(size=(1, C, KV * g, Dh)).astype(np.float32)
    return q, kp, vp, row, offset, valid, Dh ** -0.5


def served_prefill_inputs(seed, offset, valid, KV, g, Dh, page, nb, C):
    """``prefill_inputs`` of a SERVED_PREFILL_CASES case."""
    return prefill_inputs(seed, offset, valid, KV, g, page=page, nb=nb, C=C, Dh=Dh)


def served_cpq_prefill_inputs(seed, offset, valid, KV, g, Dh, page, nb, C):
    """``cpq_prefill_inputs`` (4-bit codes, as served) of a
    SERVED_PREFILL_CASES case."""
    return cpq_prefill_inputs(seed, offset, valid, KV, g, Dh, page=page, nb=nb, C=C, bits=4)


def pool_layout(rng, B, nb, page):
    """Random paged layout: per-row lengths (0..capacity), pages assigned in
    PERMUTED physical order, unmapped entries left at the null page 0."""
    num_pages = 1 + B * nb + int(rng.integers(0, 4))  # spare pages stay stale
    lengths = np.array([int(rng.integers(0, nb * page + 1)) for _ in range(B)],
                       np.int32)
    if B > 1 and rng.random() < 0.5:
        lengths[int(rng.integers(0, B))] = 0          # force an empty row
    perm = rng.permutation(np.arange(1, num_pages)).tolist()
    bt = np.zeros((B, nb), np.int32)
    for b in range(B):
        for j in range(-(-int(lengths[b]) // page)):
            bt[b, j] = perm.pop()
    return num_pages, lengths, bt


def decode_inputs(seed, page, nb, B, KV, g, Dh):
    """q, k/v pools (null page poisoned), block table, lengths, scale."""
    rng = np.random.default_rng(seed)
    num_pages, lengths, bt = pool_layout(rng, B, nb, page)
    kp = rng.normal(size=(num_pages, page, KV, Dh)).astype(np.float32)
    vp = rng.normal(size=(num_pages, page, KV, Dh)).astype(np.float32)
    kp[0] = vp[0] = 1e3
    q = rng.normal(size=(B, 1, KV * g, Dh)).astype(np.float32)
    return q, kp, vp, bt, lengths, Dh ** -0.5


# decodes at the served page size and head dims, for B1 on the CPU (against
# the JAX kernel) and on the card: a row of length 0, of length 1, rows
# ending on a 16-key tile boundary, a row at the full capacity, at
# qwen1.5-0.5b's 16 kv heads and at a GQA shape (G 4, Dh 128)
SERVED_DECODE_CASES = [  # seed, page, nb, B, KV, g, Dh, lengths
    (50, 16, 8, 3, 16, 1, 64, (0, 128, 17)),
    (51, 16, 8, 3, 16, 1, 64, (1, 64, 48)),
    (52, 16, 8, 3, 8, 4, 128, (64, 0, 40)),
]
# the card only: the served decode's shape (8 rows over 64 pages of 16, a
# capacity of 1024 keys) with lengths 0, 1, on tile and rank boundaries and
# at the full capacity, and the same at GQA (KV 8, G 4, Dh 128)
CARD_DECODE_CASES = [  # seed, page, nb, B, KV, g, Dh, lengths
    (53, 16, 64, 8, 16, 1, 64, (0, 1, 256, 1024, 77, 576, 767, 16)),
    (54, 16, 64, 8, 8, 4, 128, (0, 1024, 512, 33, 300, 128, 1000, 1)),
]


def served_decode_inputs(seed, page, nb, B, KV, g, Dh, lengths):
    """``decode_inputs`` with the given ``lengths``: permuted pages, the
    unmapped tail of every row at the poisoned null page."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + B * nb
    perm = rng.permutation(np.arange(1, num_pages)).tolist()
    bt = np.zeros((B, nb), np.int32)
    for b in range(B):
        for j in range(-(-lengths[b] // page)):
            bt[b, j] = perm.pop()
    kp = rng.normal(size=(num_pages, page, KV, Dh)).astype(np.float32)
    vp = rng.normal(size=(num_pages, page, KV, Dh)).astype(np.float32)
    kp[0] = vp[0] = 1e3
    q = rng.normal(size=(B, 1, KV * g, Dh)).astype(np.float32)
    return q, kp, vp, bt, np.array(lengths, np.int32), Dh ** -0.5


def prefill_inputs(seed, offset, valid, KV, g, page=4, nb=8, C=8, Dh=16):
    """q, k/v pools (null page poisoned), the slot's permuted block row with
    its unmapped tail at the null page, offset, valid, scale."""
    rng = np.random.default_rng(seed)
    P = nb + 3
    kp = rng.normal(size=(P, page, KV, Dh)).astype(np.float32)
    vp = rng.normal(size=(P, page, KV, Dh)).astype(np.float32)
    kp[0] = vp[0] = 1e3
    mapped = -(-(offset + valid) // page)
    row = np.zeros((nb,), np.int32)
    row[:mapped] = rng.permutation(np.arange(1, P))[:mapped]
    q = rng.normal(size=(1, C, KV * g, Dh)).astype(np.float32)
    return q, kp, vp, row, offset, valid, 0.3


def tensors(*arrays, device="cpu", dtype=torch.float32):
    """numpy -> torch; float arrays take ``dtype``, int arrays keep theirs."""
    return [torch.tensor(a, device=device, dtype=dtype if a.dtype == np.float32 else None)
            for a in arrays]


# ---------------------------------------------------------------- T2 / CPQ

CPQ_DECODE_CASES = [  # seed, page, nb, B, KV, g, Dh, bits
    (0, 4, 4, 2, 2, 2, 16, 8),
    (1, 2, 3, 3, 1, 4, 8, 4),
    (2, 8, 2, 2, 4, 1, 32, 8),
    (3, 3, 4, 2, 2, 1, 16, 4),    # odd page size
    (4, 16, 4, 3, 4, 1, 64, 4),   # the served page size and head dim
]

# decodes at the served page size and head dim, for B5 on the CPU (against
# the JAX kernel) and on the card: a row of length 0, a row whose length
# ends on a split boundary or spans two splits (of 64 keys: the card test
# sets them so), and the last row live over an all-null block row (the CPQ
# arm of a tiered decode); at qwen1.5-0.5b's 16 kv heads and at a GQA shape
# (G 4, Dh 128)
SERVED_CPQ_DECODE_CASES = [  # seed, page, nb, B, KV, g, Dh, bits, lengths
    (30, 16, 8, 3, 16, 1, 64, 4, (0, 128, 17)),
    (31, 16, 8, 3, 16, 1, 64, 4, (100, 64, 33)),
    (32, 16, 8, 3, 8, 4, 128, 4, (64, 0, 40)),
]
# the card only: the served decode's shape (B 8, 64 pages of 16, 8 splits of
# 128 keys), lengths on split boundaries, and at GQA
CARD_CPQ_DECODE_CASES = [  # seed, page, nb, B, KV, g, Dh, bits, lengths
    (33, 16, 64, 8, 16, 1, 64, 4, (0, 256, 512, 1024, 77, 300, 767, 33)),
    (34, 16, 64, 8, 8, 4, 128, 4, (512, 0, 1000, 256, 65, 1, 700, 129)),
]

CPQ_PREFILL_CASES = [  # seed, offset, valid, KV, g, Dh
    (0, 0, 8, 2, 2, 8),           # first chunk: the raw tail only
    (1, 8, 4, 2, 2, 8),
    (2, 12, 8, 2, 2, 8),
    (3, 5, 3, 1, 4, 16),          # mid-page offset, valid < C
    (4, 21, 8, 2, 1, 64),         # the served head dim
]

CPQ_LEVELS = 4


def cpq_pool(rng, P, page, KV, D, slots, bits, L, poison_levels=True):
    """A CPQ arena of P pages: codes of ``bits``-bit values (some pruned),
    levels in [0, L), per-slot scale/zero tables. Page 0, the null page,
    holds full-range codes and, with ``poison_levels``, levels outside
    [0, L) that must read scale = zero = 0. Returns (codes, level, scale,
    zero) numpy arrays."""
    codes = (rng.integers(0, 1 << bits, size=(P, page, KV, D)) - 128).astype(np.int8)
    level = rng.integers(0, L, size=(P, page, KV)).astype(np.int32)
    codes[0] = rng.integers(-128, 128, size=codes[0].shape)
    if poison_levels:
        level[0] = np.where(rng.random(level[0].shape) < 0.5, L + 3, -2)
    # each level spans a range of width 1.2 to 3 around 0, as fitted K/V do
    width = rng.uniform(1.2, 3.0, size=(slots, L, KV, D))
    scale = (width / ((1 << bits) - 2)).astype(np.float32)
    zero = (-width / 2 + 0.1 * rng.normal(size=width.shape)).astype(np.float32)
    return codes, level, scale, zero


def cpq_decode_inputs(seed, page, nb, B, KV, g, Dh, bits, poison_levels=True):
    """q, K and V arenas (tuples of cpq_pool arrays, tables per row), block
    table, lengths, scale. Besides the ragged rows of ``pool_layout``, the
    last row has a live length over an all-null block row, as the CPQ arm of
    a tiered decode sees a dense-tier row."""
    rng = np.random.default_rng(seed)
    num_pages, lengths, bt = pool_layout(rng, B, nb, page)
    if B > 1:
        bt[-1] = 0
        lengths[-1] = min(page + 1, nb * page)
    kt = cpq_pool(rng, num_pages, page, KV, Dh, B, bits, CPQ_LEVELS, poison_levels)
    vt = cpq_pool(rng, num_pages, page, KV, Dh, B, bits, CPQ_LEVELS, poison_levels)
    q = rng.normal(size=(B, 1, KV * g, Dh)).astype(np.float32)
    return q, kt, vt, bt, lengths, 0.17


def served_cpq_decode_inputs(seed, page, nb, B, KV, g, Dh, bits, lengths):
    """``cpq_decode_inputs`` with the given ``lengths`` (permuted pages, the
    unmapped tail of every row at the null page), the last row live over an
    all-null block row."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + B * nb
    perm = rng.permutation(np.arange(1, num_pages)).tolist()
    bt = np.zeros((B, nb), np.int32)
    for b in range(B - 1):
        for j in range(-(-lengths[b] // page)):
            bt[b, j] = perm.pop()
    kt = cpq_pool(rng, num_pages, page, KV, Dh, B, bits, CPQ_LEVELS)
    vt = cpq_pool(rng, num_pages, page, KV, Dh, B, bits, CPQ_LEVELS)
    q = rng.normal(size=(B, 1, KV * g, Dh)).astype(np.float32)
    return q, kt, vt, bt, np.array(lengths, np.int32), 0.17


def cpq_prefill_inputs(seed, offset, valid, KV, g, Dh, page=4, nb=8, C=8, bits=8,
                       poison_levels=True):
    """q, K and V arenas (two slots), the chunk's raw K/V, slot 1, its block
    row (permuted pages, unmapped tail at the null page), offset, valid,
    scale."""
    rng = np.random.default_rng(seed)
    P = nb + 3
    kt = cpq_pool(rng, P, page, KV, Dh, 2, bits, CPQ_LEVELS, poison_levels)
    vt = cpq_pool(rng, P, page, KV, Dh, 2, bits, CPQ_LEVELS, poison_levels)
    mapped = -(-(offset + valid) // page)
    row = np.zeros((nb,), np.int32)
    row[:mapped] = rng.permutation(np.arange(1, P))[:mapped]
    q = rng.normal(size=(1, C, KV * g, Dh)).astype(np.float32)
    k_raw = rng.normal(size=(1, C, KV, Dh)).astype(np.float32)
    v_raw = rng.normal(size=(1, C, KV, Dh)).astype(np.float32)
    return q, kt, vt, k_raw, v_raw, 1, row, offset, valid, 0.3


def cpq_arena(pool, device="cpu"):
    """A port ``PagedCPQTensor`` from cpq_pool arrays."""
    from repro_torch.serving.paged_cache import PagedCPQTensor

    codes, level, scale, zero = (torch.tensor(a, device=device) for a in pool)
    slots, _, KV, D = scale.shape
    return PagedCPQTensor(codes, level, scale, zero,
                          torch.ones((slots, KV), dtype=torch.int32, device=device),
                          torch.zeros((slots, KV, D), device=device))


# ---------------------------------------------------------------- T1 / X

T1_DECODE_CASES = [  # seed, page, nb, B, H, Dm, kv_r, Rr
    (0, 4, 4, 2, 4, 16, 1, 8),      # shared roped key (MLA layout)
    (1, 4, 3, 3, 4, 16, 2, 8),      # per-kv-head roped keys, 2 heads per group
    (2, 2, 4, 2, 8, 32, 4, 4),
    (3, 8, 2, 2, 4, 16, 1, 0),      # absolute positions: no roped term
    (4, 5, 3, 1, 2, 8, 2, 8),       # odd page size
    (5, 16, 4, 3, 16, 64, 16, 8),   # the served page size, 16 heads = kv_r
    (6, 4, 2, 2, 24, 3072, 8, 8),   # phi4-mini's d_model: 24 heads over 8 roped groups
    (7, 8, 2, 2, 8, 4096, 1, 0),    # opt-6.7b's d_model, no roped term
]

T1_PREFILL_CASES = [  # seed, offset, valid, H, Dm, kv_r, Rr
    (0, 0, 8, 4, 16, 2, 8),         # first chunk
    (1, 8, 8, 4, 16, 1, 8),         # shared roped key
    (2, 8, 3, 4, 32, 4, 4),         # valid < C
    (3, 5, 1, 2, 16, 2, 0),         # mid-page offset, one valid token, no rope
    (4, 21, 8, 8, 64, 8, 8),
]

# the widths the CUDA kernels are built for: qwen1.5-0.5b (H 16, Dm 1024,
# kv_r 16, Rr 32), an MLA-like shape at deepseek-v2-lite's widths (Dm 512,
# one shared roped key of 64) and a no-rope shape
T1_WIDE = [(16, 1024, 16, 32), (16, 512, 1, 64), (8, 256, 1, 0)]  # H, Dm, kv_r, Rr

# chunks at qwen1.5-0.5b's served T1 shape (C 16 over pages of 16, H 16,
# Dm 1024, 16 roped groups of 32), for B4 on the CPU (against the JAX
# kernel) and on the card: a first chunk, a mid-page offset, valid < C, a
# chunk of 8 (half of each 16-row tile is padding on the card's tensor-core
# route) and one past 512 keys (several key splits there)
SERVED_T1_PREFILL_CASES = [  # seed, offset, valid, H, Dm, kv_r, Rr, page, nb, C
    (20, 0, 16, 16, 1024, 16, 32, 16, 8, 16),
    (21, 213, 16, 16, 1024, 16, 32, 16, 16, 16),
    (22, 300, 11, 16, 1024, 16, 32, 16, 20, 16),
    (23, 37, 8, 16, 1024, 16, 32, 16, 4, 8),
    (24, 520, 16, 16, 1024, 16, 32, 16, 34, 16),
    (25, 213, 16, 16, 512, 1, 64, 16, 16, 16),   # deepseek-v2-lite's latent (MLA)
]


# decodes at qwen1.5-0.5b's served T1 shape (pages of 16, H 16, Dm 1024, 16
# roped groups of 32), for B3 on the CPU (against the JAX kernel) and on the
# card: a row of length 0, a full row, partial last pages, and rows over
# more than one key split of the card's tensor-core route (of 64 keys: the
# card tests set them so)
SERVED_T1_DECODE_CASES = [  # seed, page, nb, B, H, Dm, kv_r, Rr, lengths
    (40, 16, 8, 3, 16, 1024, 16, 32, (0, 128, 77)),
    (41, 16, 8, 3, 16, 1024, 16, 32, (100, 64, 17)),
    (42, 16, 8, 2, 16, 1024, 16, 32, (1, 65)),
    (47, 16, 8, 3, 16, 512, 1, 64, (0, 128, 77)),  # deepseek-v2-lite's latent (MLA)
]


def t1_decode_inputs(seed, page, nb, B, H, Dm, kv_r, Rr):
    """r, q_rope, X and roped-key pools (null page poisoned), block table,
    lengths, scale for the T1 decode sweep."""
    rng = np.random.default_rng(seed)
    num_pages, lengths, bt = pool_layout(rng, B, nb, page)
    xp = rng.normal(size=(num_pages, page, Dm)).astype(np.float32)
    krp = rng.normal(size=(num_pages, page, kv_r, Rr)).astype(np.float32)
    xp[0] = krp[0] = 1e3
    r = rng.normal(size=(B, H, Dm)).astype(np.float32)
    qr = rng.normal(size=(B, H, Rr)).astype(np.float32)
    return r, qr, xp, krp, bt, lengths, (Dm + Rr) ** -0.5


def served_t1_decode_inputs(seed, page, nb, B, H, Dm, kv_r, Rr, lengths):
    """``t1_decode_inputs`` with the given ``lengths``: permuted pages, the
    unmapped tail of every row at the poisoned null page."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + B * nb
    perm = rng.permutation(np.arange(1, num_pages)).tolist()
    bt = np.zeros((B, nb), np.int32)
    for b in range(B):
        for j in range(-(-lengths[b] // page)):
            bt[b, j] = perm.pop()
    xp = rng.normal(size=(num_pages, page, Dm)).astype(np.float32)
    krp = rng.normal(size=(num_pages, page, kv_r, Rr)).astype(np.float32)
    xp[0] = krp[0] = 1e3
    r = rng.normal(size=(B, H, Dm)).astype(np.float32)
    qr = rng.normal(size=(B, H, Rr)).astype(np.float32)
    return r, qr, xp, krp, bt, np.array(lengths, np.int32), (Dm + Rr) ** -0.5


def served_t1_prefill_inputs(seed, offset, valid, H, Dm, kv_r, Rr, page, nb, C):
    """``t1_prefill_inputs`` of a SERVED_T1_PREFILL_CASES case."""
    return t1_prefill_inputs(seed, offset, valid, H, Dm, kv_r, Rr, page=page, nb=nb, C=C)


def t1_prefill_inputs(seed, offset, valid, H, Dm, kv_r, Rr, page=4, nb=8, C=8):
    """r, q_rope, X and roped-key pools (null page poisoned), the slot's
    permuted block row with its unmapped tail at the null page, offset,
    valid, scale for the T1 chunk sweep."""
    rng = np.random.default_rng(seed)
    P = nb + 3
    xp = rng.normal(size=(P, page, Dm)).astype(np.float32)
    krp = rng.normal(size=(P, page, kv_r, Rr)).astype(np.float32)
    xp[0] = krp[0] = 1e3
    mapped = -(-(offset + valid) // page)
    row = np.zeros((nb,), np.int32)
    row[:mapped] = rng.permutation(np.arange(1, P))[:mapped]
    r = rng.normal(size=(C, H, Dm)).astype(np.float32)
    qr = rng.normal(size=(C, H, Rr)).astype(np.float32)
    return r, qr, xp, krp, row, offset, valid, (Dm + Rr) ** -0.5


# ---------------------------------------------------------------- T3 / proxy

PROXY_CASES = [  # seed, page, nb, B, KV, g, Dp
    (0, 4, 4, 3, 2, 1, 16),
    (1, 1, 3, 2, 1, 4, 32),      # page_size 1: one token per page
    (2, 8, 2, 2, 4, 2, 16),
    (3, 5, 4, 4, 2, 4, 16),      # odd page size, partial last pages
    (4, 4, 1, 1, 1, 8, 64),      # single block
    (5, 16, 4, 3, 16, 1, 64),    # the served page size, kv heads and Dp
    (6, 4, 3, 2, 8, 3, 32),      # G = 3 (phi4-mini: 24 heads over 8 kv heads)
]

# the served call's shape (qwen1.5-0.5b: 8 rows over 64 pages of 16, KV 16,
# G 1, Dp 64), n short of the capacity, and GQA shapes (G 3, phi4-mini's,
# and G 4 at Dp 128), each with an empty row and a row past n
SERVED_PROXY_CASES = [  # seed, page, nb, B, KV, g, Dp, lengths, n
    (20, 16, 64, 8, 16, 1, 64, (0, 1, 64, 1024, 77, 576, 767, 1000), 1000),
    (21, 16, 8, 3, 8, 3, 128, (128, 0, 33), 100),
    (22, 16, 8, 4, 8, 4, 128, (0, 128, 17, 90), 128),
]

CONTIG_PROXY_CASES = [  # seed, B, N, KV, g, Dp, length, block_n
    (0, 2, 40, 2, 1, 16, 40, 16),     # N not a multiple of the block
    (1, 1, 37, 1, 4, 32, 20, 16),     # a partial length
    (2, 3, 64, 4, 2, 64, 0, 32),      # length 0: every score masked
    (3, 2, 50, 16, 1, 64, 33, 1024),  # one block wider than N
    (4, 2, 45, 8, 3, 64, 40, 16),     # G = 3
]


def proxy_tables(rng, B, KV, Dp):
    """Per-slot proxy scale/zero tables, as fitted keys of spread ~3 give."""
    scale = rng.uniform(0.005, 0.03, size=(B, KV, Dp)).astype(np.float32)
    zero = (-1.5 + 0.3 * rng.normal(size=(B, KV, Dp))).astype(np.float32)
    return scale, zero


def proxy_inputs(seed, page, nb, B, KV, g, Dp):
    """q (B, H, Dp) pre-scaled, proxy scale/zero (B, KV, Dp), code pages
    (P, page, KV, Dp) int8 with the null page poisoned at the top code,
    block table, lengths."""
    rng = np.random.default_rng(seed)
    num_pages, lengths, bt = pool_layout(rng, B, nb, page)
    codes = rng.integers(-128, 128, size=(num_pages, page, KV, Dp)).astype(np.int8)
    codes[0] = 127
    scale, zero = proxy_tables(rng, B, KV, Dp)
    q = (rng.normal(size=(B, KV * g, Dp)) * Dp ** -0.5).astype(np.float32)
    return q, scale, zero, codes, bt, lengths


def served_proxy_inputs(seed, page, nb, B, KV, g, Dp, lengths, n):
    """``proxy_inputs`` with the given ``lengths`` (permuted pages, the
    unmapped tail of every row at the poisoned null page), and n."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + B * nb
    perm = rng.permutation(np.arange(1, num_pages)).tolist()
    bt = np.zeros((B, nb), np.int32)
    for b in range(B):
        for j in range(-(-lengths[b] // page)):
            bt[b, j] = perm.pop()
    codes = rng.integers(-128, 128, size=(num_pages, page, KV, Dp)).astype(np.int8)
    codes[0] = 127
    scale, zero = proxy_tables(rng, B, KV, Dp)
    q = (rng.normal(size=(B, KV * g, Dp)) * Dp ** -0.5).astype(np.float32)
    return q, scale, zero, codes, bt, np.array(lengths, np.int32), n


def contig_proxy_inputs(seed, B, N, KV, g, Dp, length):
    """qs (B, KV, G, Dp), qz (B, KV, G, 1), codes (B, N, KV, Dp) int8 for
    B7's contiguous contract, and its length."""
    rng = np.random.default_rng(seed)
    qs = (rng.normal(size=(B, KV, g, Dp)) * 0.02).astype(np.float32)
    qz = rng.normal(size=(B, KV, g, 1)).astype(np.float32)
    codes = rng.integers(-128, 128, size=(B, N, KV, Dp)).astype(np.int8)
    return qs, qz, codes, length


# ------------------------------------------------------ contiguous (B8-B10)

FLASH_CASES = [  # seed, B, T, S, H, KV, D, causal, arena (S <= arena: k, v a prefix)
    (0, 2, 128, 128, 4, 2, 64, True, 128),    # the five cases of tests/test_kernels.py
    (1, 2, 256, 256, 8, 8, 128, True, 256),
    (2, 2, 100, 100, 4, 1, 32, False, 100),
    (3, 2, 192, 192, 6, 3, 64, True, 192),
    (4, 2, 128, 128, 4, 4, 64, True, 128),
    (5, 3, 1, 75, 4, 4, 64, False, 80),       # a decode token over a written prefix
    (6, 1, 77, 77, 2, 2, 16, True, 77),       # T and S no block multiple
    (7, 1, 70, 70, 8, 1, 256, True, 70),      # MQA at Dh 256 (gemma-2b), G = 8
    (8, 2, 100, 100, 8, 2, 128, True, 128),   # GQA at Dh 128, T no multiple of 64
    # cross-attention (llama-vision's 32 heads over 8 of 128, here 8 over 2):
    (9, 2, 64, 200, 8, 2, 128, False, 200),   # the prompt over more patch keys, T < S
    (10, 1, 77, 200, 8, 2, 128, False, 208),  # ... T no tile multiple, k and v a prefix
    (11, 2, 1, 200, 8, 2, 128, False, 200),   # a decode token over every patch key
]


def flash_inputs(seed, B, T, S, H, KV, D, causal, arena):
    """q (B, T, H, D), and k, v: the first S tokens of (B, arena, KV, D)
    arenas; scale."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, arena, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, arena, KV, D)).astype(np.float32)
    return q, k, v, D ** -0.5


CONTIG_T1_CASES = [  # seed, B, N, H, Dm, kv_r, Rr, length
    (0, 2, 40, 4, 16, 1, 8, 40),       # shared roped key (the TPU kernel's layout)
    (1, 3, 37, 4, 16, 2, 8, 30),       # per-kv-head roped keys, length < N
    (2, 2, 50, 8, 32, 4, 0, 49),       # no roped term
    (3, 2, 33, 16, 1024, 16, 32, 20),  # qwen1.5-0.5b's T1 widths
    (4, 1, 20, 16, 512, 1, 64, 7),     # an MLA-like shape
    (5, 2, 24, 24, 3072, 1, 32, 21),   # phi4-mini's d_model, one shared roped key
    (6, 1, 18, 8, 4096, 1, 0, 18),     # opt-6.7b's d_model, no roped term
    (7, 2, 300, 16, 1024, 16, 32, 290),  # qwen1.5-0.5b's widths past one key split
]


def contig_t1_inputs(seed, B, N, H, Dm, kv_r, Rr, length):
    """r, q_rope, x (B, N, Dm), k_rope (B, N, kv_r, Rr), length, scale."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(B, H, Dm), f(B, H, Rr), f(B, N, Dm), f(B, N, kv_r, Rr), length,
            (Dm + Rr) ** -0.5)


CONTIG_CPQ_CASES = [  # seed, B, N, KV, g, Dh, bits, length
    (0, 2, 40, 2, 1, 16, 4, 40),
    (1, 3, 70, 2, 4, 32, 8, 55),     # G = 4, length < N
    (2, 2, 130, 4, 2, 64, 4, 129),   # N past two splits of 64
]


def contig_cpq_inputs(seed, B, N, KV, g, Dh, bits, length):
    """q (B, KV, G, Dh) and contiguous K and V arenas as cpq_pool arrays
    (codes (B, N, KV, D), levels (B, N, KV), tables (B, L, KV, D); about one
    code in 2^bits pruned, levels in [0, L)), length, scale."""
    rng = np.random.default_rng(seed)
    arenas = [cpq_pool(rng, B, N, KV, Dh, B, bits, CPQ_LEVELS, poison_levels=False)
              for _ in range(2)]
    q = rng.normal(size=(B, KV, g, Dh)).astype(np.float32)
    return q, arenas[0], arenas[1], length, 0.17


# ------------------------------------------- engine parity: JAX and the port

TIMERS = ("wall_time_s", "tokens_per_s")


def smoke_pair(arch="qwen1.5-0.5b", num_blocks=2):
    """(cfg, tcfg, params, tparams): ``arch``'s f32 smoke config in the JAX
    package and in the port, cut to ``num_blocks`` blocks, with the same
    seeded weights on both sides."""
    import jax

    from repro.configs import ARCHS, smoke_config
    from repro.models import model as JM
    import repro_torch as T
    from repro_torch.params import from_jax

    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32",
                              num_blocks=num_blocks)
    tcfg = dataclasses.replace(T.smoke_config(T.ARCHS[arch]), dtype="float32",
                               num_blocks=num_blocks)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, from_jax(jax.tree.map(np.asarray, params), device="cpu")


def packages():
    """(J, T): the names a parity test builds engines and requests from, in
    the JAX package and in the port."""
    from repro import configs as jconfigs
    from repro.serving import engine as jeng, policies as jpol, request as jreq
    from repro.serving import trace as jtrace
    from repro.serving.scheduler import Request as JRequest
    import repro_torch as T
    from repro_torch.serving import policies as tpol, request as treq
    from repro_torch.serving import trace as ttrace

    J = SimpleNamespace(ServingCfg=jconfigs.ServingCfg,
                        AttentionRuntime=jconfigs.AttentionRuntime,
                        Engine=jeng.ContinuousServeEngine,
                        GenerationConfig=jeng.GenerationConfig, Request=JRequest,
                        ServeRequest=jreq.ServeRequest,
                        SamplingParams=jreq.SamplingParams, SloClass=jreq.SloClass,
                        policies=jpol, trace=jtrace, device={})
    P = SimpleNamespace(ServingCfg=T.ServingCfg, AttentionRuntime=T.AttentionRuntime,
                        Engine=T.ContinuousServeEngine,
                        GenerationConfig=T.GenerationConfig, Request=T.Request,
                        ServeRequest=T.ServeRequest, SamplingParams=T.SamplingParams,
                        SloClass=treq.SloClass, policies=tpol, trace=ttrace,
                        device={"device": "cpu"})
    return J, P


def assert_same(a, b, what=""):
    """Two results dicts, stats dicts or metrics dicts are equal, key by key,
    apart from the wall-clock timers."""
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for key in a:
        if key in TIMERS:
            continue
        if isinstance(a[key], dict):
            assert_same(a[key], b[key], f"{what}[{key}]")
        else:
            np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]),
                                          err_msg=f"{what}[{key}]")


def serve_pair(model, requests, serving, *, gen=None, rt=None, policy=None,
               drive=None):
    """Serve the same traffic on the JAX engine and on the port's, and
    assert identical results, stats and output events (tokens and their
    ticks). ``requests(ns)`` builds the request list from a package
    namespace of ``packages()``; ``serving``, ``gen`` and ``rt`` are keyword
    dicts of ServingCfg, GenerationConfig and AttentionRuntime; ``policy`` a
    name or a callable ``(ns) -> policy object``. ``drive(eng, ns)``
    replaces ``eng.serve(requests(ns), gen)`` (for step-driven traffic) and
    returns the engine's results. Returns ((jres, jstats), (tres, tstats))."""
    cfg, tcfg, params, tparams = model
    out = []
    for ns, c, p in zip(packages(), (cfg, tcfg), (params, tparams)):
        pol = policy(ns) if callable(policy) else policy
        eng = ns.Engine(c, p, rt=ns.AttentionRuntime(**(rt or {})),
                        serving=ns.ServingCfg(**serving), policy=pol, **ns.device)
        g = ns.GenerationConfig(**(gen or {}))
        if drive is None:
            res, stats = eng.serve(requests(ns), g)
        else:
            eng.reset(g)
            res, stats = drive(eng, ns), eng.stats()
        events = [dataclasses.astuple(e) for e in eng.pending_outputs()]
        out.append((res, stats, events))
    (jres, jst, jev), (tres, tst, tev) = out
    assert_same(jres, tres, "results")
    assert_same(jst, tst, "stats")
    assert jev == tev
    assert tst["dense_pages_leaked"] == 0
    return (jres, jst), (tres, tst)
