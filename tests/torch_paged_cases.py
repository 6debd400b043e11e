"""Paged-attention test layouts shared by the port's kernel tests, free of
JAX so that the CUDA cases also run where JAX is not installed.
``pool_layout`` is ``test_kernels_paged._pool_layout`` verbatim."""
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
