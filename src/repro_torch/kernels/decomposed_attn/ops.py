"""T1 decomposed-attention kernels of the port: wrappers, plain versions,
counters.

  ``paged_decomposed_decode``   B3: replaces ``paged_decomposed_decode_fwd``
                                (src/repro/kernels/decomposed_attn/kernel.py:244)
  ``paged_decomposed_prefill``  B4: replaces ``paged_decomposed_prefill_fwd``
                                (src/repro/kernels/decomposed_attn/kernel.py:187)
  ``decomposed_decode``         B9: replaces ``decomposed_decode_fwd``
                                (src/repro/kernels/decomposed_attn/kernel.py:298),
                                the static engine's T1 decode over contiguous
                                (B, N, ...) arenas with one length

The work is split as the JAX ops split it (``decomposed_attn/ops.py``): the
query side ``R = q_nope W_K^T`` is an einsum cast to the arena dtype, the
sweep over the X pages (both cascaded products and the online softmax) is
the kernel, which returns ``P`` (rows, H, Dm), and ``out = P W_V`` is an
einsum in the arena dtype. ``*_fwd`` is the sweep alone,
with the JAX kernels' arguments: given CPU tensors it runs the plain PyTorch
version (``*_plain``, which the tests hold against the JAX kernels); given
CUDA tensors it launches the hand-written CUDA kernel in ``csrc/`` on the
current stream, or raises. It never falls back. Every launch adds one to the
``launches`` counter of the wrapper it serves.

Semantics (the TPU kernels'): scores ``R . X + q_rope . k_rope`` (the roped
key of the head's group: ``kr_pages`` holds ``kv_r`` groups, per kv head or
one shared) times ``scale``, softmax in float32 with ``P`` accumulated in
float32 and cast to the arena dtype. Physical page 0 is the null page;
positions at or past a row's length contribute nothing and a row of length
0 returns zeros. ``Rr == 0`` (absolute positions) has no roped term. The
CUDA kernels take d_model up to 8192 (a multiple of 8 past 2048, of 16 past
4096).

Each kernel has two routes, picked from dtype and widths before the launch
and counted apart, each kernel in its own counter: B4 by
``t1_prefill_route`` in ``ROUTE_LAUNCHES``, B3 and B9 by
``t1_decode_route`` in ``DECODE_ROUTE_LAUNCHES`` and
``CONTIG_ROUTE_LAUNCHES``:

  ``tensor_core``  B4: bf16, d_model a multiple of 8 up to ``MAX_CHUNK_DM``,
                   a roped slice of 0 or a multiple of 8 up to
                   ``MAX_CHUNK_RR``: mma.sync (``csrc/paged_decomposed_chunk.cuh``),
                   one launch, a row tile's key splits one thread-block
                   cluster that merges through distributed shared memory.
                   B3 and B9: bf16, d_model a multiple of 8 up to
                   ``TOKEN_SLICE * TOKEN_MAX_CLUSTER``, a roped slice of 0 or
                   a multiple of 8 whose kv_r groups a cluster's
                   ``TOKEN_ROPE_STEPS`` hold: mma.sync (``csrc/t1_token.cuh``),
                   one launch, d_model cut over a thread-block cluster that
                   shares partial scores through distributed shared memory,
                   key splits (``t1_decode_plan``) merged by the last block on
                   ``single_query.counters``
  ``sweep``        float32 (TF32 would miss the float32 gate) and every
                   other width: the CUDA-core sweep (``csrc/paged_decomposed.cuh``,
                   which the three kernels share) and its merge pass
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build, single_query
from repro_torch.kernels.paged_attn.ops import NEG_INF, aligned16, run
from repro_torch.kernels.paged_attn.ops import _check_cuda as _check_common

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"paged_decomposed_decode": CSRC / "paged_decomposed_decode.cu",
           "paged_decomposed_prefill": CSRC / "paged_decomposed_prefill.cu",
           "decomposed_decode": CSRC / "decomposed_decode.cu"}
# pass 1 cuts the key range into runs of whole pages of about this many
# tokens, one block per run and 16 query rows (csrc/paged_decomposed.cuh).
# A block fills an SM (512 threads at 128 registers) and walks its run one
# 8-key tile at a time, so short runs keep that walk short while the live
# runs of a served batch (a few thousand keys) still fit the 132 SMs in one
# wave; each run writes a (16, Dm) float32 partial that pass 2 merges
SPLIT_TOKENS = {"decode": 16, "prefill": 32}  # the contiguous decode as "decode"
# query rows per block (kRows) up to d_model 2048; wider models take 4 or 2
# rows a block, whose partials fit in the buffer sized for 16
ROWS = 16
ROUTE_LAUNCHES = {"tensor_core": 0, "sweep": 0}  # B4's launches by route
MAX_CHUNK_DM = 1024   # the tensor-core route: d_model (its warps' slices of O in registers)
MAX_CHUNK_RR = 64     # ... and the roped slice (k16 steps of the first warps)
CHUNK_ROWS = 16       # ... query rows per block (one m16 tile of one roped group)
CHUNK_KEYS = 32       # ... keys per tile
CHUNK_SPLIT_KEYS = 64  # ... least keys per split (two tiles)
# ... and most splits: a row tile's splits are one thread-block cluster, and
# on an H100 16 clusters of 8 blocks of 184 KB of shared memory did not fit
# the card at once where clusters of 4 did (PERF.md, section 6)
MAX_CHUNK_SPLITS = 4
DECODE_ROUTE_LAUNCHES = {"tensor_core": 0, "sweep": 0}  # B3's launches by route
CONTIG_ROUTE_LAUNCHES = {"tensor_core": 0, "sweep": 0}  # B9's launches by route
TOKEN_ROWS = 16         # B3's and B9's tensor-core route: heads per block (one m16 tile)
TOKEN_SLICE = 128       # ... d_model columns per block, one rank of a cluster
TOKEN_MAX_CLUSTER = 8   # ... blocks per cluster (portable): d_model up to 1024
TOKEN_ROPE_STEPS = 4    # ... roped k16 steps per block
TOKEN_KEYS = 192        # ... most keys per split (a block holds its split's keys at once)
# ... B3's splits, planned from the capacity: at least this many keys, and
# at most TOKEN_MAX_SPLITS of them or single_query.BLOCKS_PER_SM blocks an
# SM (most splits of a served batch lie past their rows' lengths and exit
# at once, as B5's do). B9 plans from its length, and there the fewest
# splits were fastest (PERF.md, section 6)
TOKEN_SPLIT_KEYS = 128
TOKEN_MAX_SPLITS = 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # is_bf16, r, q_rope, x_pages, kr_pages, block_table, lengths, out, part,
    # B, H, kv_r, Rr, Dm, page, nb, pages_per_split, scale, stream
    "paged_decomposed_decode": [_I] + [_P] * 8 + [_I] * 8 + [_F, _P],
    # is_bf16, r, q_rope, x_pages, kr_pages, block_row, out, part,
    # C, H, kv_r, Rr, Dm, page, nb, pages_per_split, offset, valid, scale, stream
    "paged_decomposed_prefill": [_I] + [_P] * 7 + [_I] * 10 + [_F, _P],
    # r, q_rope, x_pages, kr_pages, block_row, out,
    # C, H, kv_r, Rr, Dm, page, nb, offset, valid, splits, split_keys, scale, stream
    "paged_decomposed_prefill_mma": [_P] * 6 + [_I] * 11 + [_F, _P],
    # is_bf16, r, q_rope, x, k_rope, out, part,
    # B, H, kv_r, Rr, Dm, N, length, split_tokens, scale, stream
    "decomposed_decode": [_I] + [_P] * 6 + [_I] * 8 + [_F, _P],
    # r, q_rope, x_pages, kr_pages, block_table, lengths, out, part, counters,
    # B, H, kv_r, Rr, Dm, page, nb, splits, split_keys, scale, stream
    "paged_decomposed_decode_mma": [_P] * 9 + [_I] * 9 + [_F, _P],
    # r, q_rope, x, k_rope, out, part, counters,
    # B, H, kv_r, Rr, Dm, N, length, splits, split_keys, scale, stream
    "decomposed_decode_mma": [_P] * 7 + [_I] * 9 + [_F, _P],
}


def launcher(name: str, entry: str | None = None):
    """The C entry point ``<entry or name>_launch`` of ``name``'s source,
    building its library first."""
    entry = entry or name
    return build.c_function(SOURCES[name], f"{entry}_launch", _ARGTYPES[entry])


def t1_prefill_route(dtype: torch.dtype, Dm: int, Rr: int) -> str:
    """The route B4 takes on the card: ``tensor_core`` for bf16 with d_model
    a multiple of 8 up to MAX_CHUNK_DM and a roped slice of 0 or a multiple
    of 8 up to MAX_CHUNK_RR, ``sweep`` otherwise."""
    if (dtype == torch.bfloat16 and Dm % 8 == 0 and 8 <= Dm <= MAX_CHUNK_DM
            and Rr % 8 == 0 and 0 <= Rr <= MAX_CHUNK_RR):
        return "tensor_core"
    return "sweep"


def t1_chunk_plan(C: int, H: int, kv_r: int, end: int, device: torch.device):
    """The tensor-core route's key splits over its row tiles (CHUNK_ROWS rows
    of one roped group each): ``single_query.plan`` over the tiles and
    ``end`` keys (about one wave, at least CHUNK_SPLIT_KEYS keys and at most
    MAX_CHUNK_SPLITS splits), in whole tiles of CHUNK_KEYS. Returns
    (splits, split_keys)."""
    tiles = kv_r * -(-(H // kv_r) * C // CHUNK_ROWS)
    splits, keys = single_query.plan(tiles, end, device, CHUNK_SPLIT_KEYS, MAX_CHUNK_SPLITS)
    keys = -(-keys // CHUNK_KEYS) * CHUNK_KEYS
    return -(-end // keys), keys


def t1_decode_route(dtype: torch.dtype, H: int, Dm: int, kv_r: int, Rr: int) -> str:
    """The route B3 and B9 take on the card: ``tensor_core`` for bf16 with
    d_model a multiple of 8 up to TOKEN_SLICE * TOKEN_MAX_CLUSTER and a
    roped slice of 0 or a multiple of 8 whose kv_r groups (one key's kv_r *
    Rr roped columns, cut in k16 steps over the cluster's blocks) need at
    most TOKEN_ROPE_STEPS steps a block; ``sweep`` otherwise."""
    if (dtype != torch.bfloat16 or Dm % 8 or not 8 <= Dm <= TOKEN_SLICE * TOKEN_MAX_CLUSTER
            or H < 1 or Rr < 0 or Rr % 8):
        return "sweep"
    cluster = -(-Dm // TOKEN_SLICE)
    steps = -(-(kv_r * Rr) // 16) if Rr else 0
    return "tensor_core" if -(-steps // cluster) <= TOKEN_ROPE_STEPS else "sweep"


def t1_decode_plan(B: int, H: int, Dm: int, capacity: int, device: torch.device,
                   of: str = "length"):
    """The tensor-core route's key splits over ``capacity`` keys a row, ``of``
    "length" (B9: its host length; the fewest splits of at most TOKEN_KEYS
    keys) or "capacity" (B3: the arena's nb * page, planned on the host
    without reading the lengths, which live on the card; splits of at least
    TOKEN_SPLIT_KEYS keys, at most TOKEN_MAX_SPLITS of them or
    single_query.BLOCKS_PER_SM blocks an SM over the B * ceil(H / 16) *
    ceil(Dm / 128) blocks of a split, then as many more as keep every split
    within TOKEN_KEYS keys). Keys a multiple of 16. Returns (splits,
    split_keys)."""
    n = max(capacity, 1)
    splits = 1
    if of == "capacity":
        units = B * -(-H // TOKEN_ROWS) * -(-Dm // TOKEN_SLICE)
        room = max(1, single_query.BLOCKS_PER_SM * single_query._sm_count(device) // units)
        splits = min(-(-n // TOKEN_SPLIT_KEYS), room, TOKEN_MAX_SPLITS)
    per = -(-n // max(splits, -(-n // TOKEN_KEYS)))  # keys per split, at most TOKEN_KEYS
    keys = -(-per // 16) * 16
    return -(-n // keys), keys


def _token_scratch(B: int, H: int, Dm: int, splits: int, device):
    """(partials, counters) of a tensor-core T1 decode: the split partials
    (m, l and a 16 x TOKEN_SLICE float32 slice of O per block and split)
    and one zeroed counter per block of a split."""
    units = B * -(-H // TOKEN_ROWS) * -(-Dm // TOKEN_SLICE)
    n = units * splits * TOKEN_ROWS * (TOKEN_SLICE + 2) if splits > 1 else 1
    return (torch.empty(n, dtype=torch.float32, device=device),
            single_query.counters(units, device))


def _kv_r(q_rope, kr_pages) -> int:
    return kr_pages.shape[2] if q_rope.shape[-1] else 1


def _check_cuda(name: str, r, q_rope, x_pages, kr_pages, ints: list[torch.Tensor]):
    """Device, dtype and layout checks (B1's), and the head grouping; the
    kernels' shape limits (Dm, span, shared memory) are enforced by their C
    entry point, which ``run`` turns into a raise."""
    _check_common(name, [x_pages, r, q_rope, kr_pages], ints)
    kv_r = _kv_r(q_rope, kr_pages)
    if r.shape[-2] % kv_r:
        raise ValueError(f"{name}: {r.shape[-2]} heads are not divisible by kv_r={kv_r}")


def _pages_per_split(kind: str, page: int) -> int:
    return max(1, SPLIT_TOKENS[kind] // page)


def _partials(groups: int, splits: int, Dm: int, device) -> torch.Tensor:
    return torch.empty(groups * splits * ROWS * (Dm + 2), dtype=torch.float32, device=device)


# ------------------------------------------------------------ query / value


def query_rows(q_nope: torch.Tensor, w_k_nope: torch.Tensor, dtype) -> torch.Tensor:
    """R = q_nope W_K^T (the first cascaded product), in ``dtype``.
    q_nope (N, T, H, Dn), w_k_nope (Dm, KV, Dn) -> (N, T, H, Dm)."""
    N, T, H, Dn = q_nope.shape
    Dm, KV, _ = w_k_nope.shape
    qg = q_nope.reshape(N, T, KV, H // KV, Dn)
    r = torch.einsum("ntkgd,mkd->ntkgm", qg, w_k_nope)
    return r.reshape(N, T, H, Dm).to(dtype).contiguous()


def value_rows(p: torch.Tensor, w_v: torch.Tensor) -> torch.Tensor:
    """out = P W_V. p (N, T, H, Dm), w_v (Dm, KV, Dv) -> (N, T, H, Dv)."""
    N, T, H, Dm = p.shape
    KV, Dv = w_v.shape[1], w_v.shape[2]
    pg = p.reshape(N, T, KV, H // KV, Dm)
    return torch.einsum("ntkgm,mkd->ntkgd", pg, w_v).reshape(N, T, H, Dv)


# ------------------------------------------------------------------ decode


def paged_decomposed_decode_plain(r, q_rope, x_pages, kr_pages, block_table, lengths,
                                  scale: float):
    """Plain version of B3 (the JAX package's ``paged_decomposed_decode_ref``):
    gather the logical view, exact softmax in float32, zeros for empty rows.
    r (B, H, Dm); q_rope (B, H, Rr); x_pages (P, page, Dm); kr_pages
    (P, page, kv_r, Rr). Returns P (B, H, Dm) in the arena dtype."""
    B, H, Dm = r.shape
    page, nb = x_pages.shape[1], block_table.shape[1]
    bt = block_table.long()
    x = x_pages[bt].reshape(B, nb * page, Dm).float()
    s = torch.einsum("bhm,bnm->bhn", r.float(), x)
    if q_rope.shape[-1] > 0:
        kv_r, Rr = kr_pages.shape[2], kr_pages.shape[3]
        kr = kr_pages[bt].reshape(B, nb * page, kv_r, Rr).float()
        qg = q_rope.reshape(B, kv_r, H // kv_r, Rr).float()
        s = s + torch.einsum("bkgr,bnkr->bkgn", qg, kr).reshape(B, H, nb * page)
    s = s * scale
    live = torch.arange(nb * page, device=r.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~live[:, None, :], NEG_INF)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.einsum("bhn,bnm->bhm", w, x) / w.sum(-1, keepdim=True).clamp_min(1e-30)
    p = torch.where((lengths > 0)[:, None, None], p, torch.zeros_like(p))
    return p.to(x_pages.dtype)


def paged_decomposed_decode_fwd(r, q_rope, x_pages, kr_pages, block_table, lengths,
                                scale: float):
    """The decode sweep over the X pages: r (B, H, Dm) = q_nope W_K^T and
    q_rope (B, H, Rr) in the arena dtype (Rr may be 0); x_pages
    (P, page, Dm); kr_pages (P, page, kv_r, Rr); block_table (B, nb) int32,
    0 = null page; lengths (B,) int32. Returns P (B, H, Dm)."""
    if x_pages.device.type == "cpu":
        return paged_decomposed_decode_plain(r, q_rope, x_pages, kr_pages, block_table,
                                             lengths, scale)
    B, H, Dm = r.shape
    P, page, Dx = x_pages.shape
    Rr, nb = q_rope.shape[-1], block_table.shape[-1]
    kv_r = _kv_r(q_rope, kr_pages)
    if (Dx != Dm or tuple(q_rope.shape[:2]) != (B, H)
            or (Rr and tuple(kr_pages.shape) != (P, page, kv_r, Rr))
            or tuple(block_table.shape) != (B, nb) or tuple(lengths.shape) != (B,)):
        raise ValueError(
            f"paged_decomposed_decode: shapes r {tuple(r.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, x {tuple(x_pages.shape)}, kr "
            f"{tuple(kr_pages.shape)}, block_table {tuple(block_table.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    _check_cuda("paged_decomposed_decode", r, q_rope, x_pages, kr_pages,
                [block_table, lengths])
    dev = x_pages.device
    out = torch.empty((B, H, Dm), dtype=x_pages.dtype, device=dev)
    route = t1_decode_route(x_pages.dtype, H, Dm, kv_r, Rr)
    if route == "tensor_core":
        splits, keys = t1_decode_plan(B, H, Dm, nb * page, dev, "capacity")
        part, counters = _token_scratch(B, H, Dm, splits, dev)
        r, q_rope = aligned16(r), aligned16(q_rope)
        run(launcher("paged_decomposed_decode", "paged_decomposed_decode_mma"),
            "paged_decomposed_decode", dev, r.data_ptr(), q_rope.data_ptr(),
            x_pages.data_ptr(), kr_pages.data_ptr(), block_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, H,
            kv_r, Rr, Dm, page, nb, splits, keys, float(scale))
    else:
        pps = _pages_per_split("decode", page)
        part = _partials(B * -(-H // ROWS), -(-nb // pps), Dm, dev)
        run(launcher("paged_decomposed_decode"), "paged_decomposed_decode", dev,
            int(x_pages.dtype == torch.bfloat16), r.data_ptr(), q_rope.data_ptr(),
            x_pages.data_ptr(), kr_pages.data_ptr(), block_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part.data_ptr(), B, H, kv_r, Rr, Dm, page,
            nb, pps, float(scale))
    paged_decomposed_decode.launches += 1
    DECODE_ROUTE_LAUNCHES[route] += 1
    return out


def paged_decomposed_decode(q_nope, q_rope, x_pages, kr_pages, block_table, lengths,
                            w_k_nope, w_v, scale: float):
    """Paged T1 decode over an X arena through its block table.
    q_nope (B, 1, H, Dn); q_rope (B, 1, H, Rr), Rr may be 0; kr_pages
    (P, page, kv_r, Rr); w_k_nope (Dm, KV, Dn); w_v (Dm, KV, Dv);
    block_table (B, nb) int32; lengths (B,) int32. Returns (B, 1, H, Dv)."""
    r = query_rows(q_nope, w_k_nope, x_pages.dtype)[:, 0]
    qr = q_rope[:, 0].to(x_pages.dtype).contiguous()
    p = paged_decomposed_decode_fwd(r, qr, x_pages, kr_pages,
                                    block_table, lengths, scale)
    return value_rows(p[:, None], w_v)


paged_decomposed_decode.launches = 0


# ----------------------------------------------------------------- prefill


def paged_decomposed_prefill_plain(r, q_rope, x_pages, kr_pages, block_row, offset: int,
                                   valid: int, scale: float):
    """Plain version of B4: gather the slot's logical view, mask
    ``pos < offset + valid`` and ``pos <= offset + i`` for chunk token i,
    exact softmax in float32. r (C, H, Dm); q_rope (C, H, Rr). Returns P
    (C, H, Dm) in the arena dtype; rows past ``valid`` are padding."""
    C, H, Dm = r.shape
    page, nb = x_pages.shape[1], block_row.shape[0]
    n = nb * page
    br = block_row.long()
    x = x_pages[br].reshape(n, Dm).float()
    s = torch.einsum("chm,nm->chn", r.float(), x)
    if q_rope.shape[-1] > 0:
        kv_r, Rr = kr_pages.shape[2], kr_pages.shape[3]
        kr = kr_pages[br].reshape(n, kv_r, Rr).float()
        qg = q_rope.reshape(C, kv_r, H // kv_r, Rr).float()
        s = s + torch.einsum("ckgr,nkr->ckgn", qg, kr).reshape(C, H, n)
    s = s * scale
    pos = torch.arange(n, device=r.device)
    tok = torch.arange(C, device=r.device)
    ok = (pos[None, :] < offset + valid) & (pos[None, :] <= offset + tok[:, None])
    s = s.masked_fill(~ok[:, None, :], NEG_INF)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.einsum("chn,nm->chm", w, x) / w.sum(-1, keepdim=True).clamp_min(1e-30)
    return p.to(x_pages.dtype)


def paged_decomposed_prefill_fwd(r, q_rope, x_pages, kr_pages, block_row, offset: int,
                                 valid: int, scale: float):
    """The chunk sweep over one slot's X pages [0, offset + valid): r
    (C, H, Dm) and q_rope (C, H, Rr) in the arena dtype; block_row (nb,)
    int32; offset/valid host ints. Returns P (C, H, Dm); rows past ``valid``
    are padding, never read."""
    if x_pages.device.type == "cpu":
        return paged_decomposed_prefill_plain(r, q_rope, x_pages, kr_pages, block_row,
                                              offset, valid, scale)
    C, H, Dm = r.shape
    P, page, Dx = x_pages.shape
    Rr, nb = q_rope.shape[-1], block_row.shape[0]
    kv_r = _kv_r(q_rope, kr_pages)
    if (Dx != Dm or tuple(q_rope.shape[:2]) != (C, H) or block_row.ndim != 1
            or (Rr and tuple(kr_pages.shape) != (P, page, kv_r, Rr))):
        raise ValueError(
            f"paged_decomposed_prefill: shapes r {tuple(r.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, x {tuple(x_pages.shape)}, kr "
            f"{tuple(kr_pages.shape)}, block_row {tuple(block_row.shape)}")
    if not (offset >= 0 and 1 <= valid <= C):
        raise ValueError(f"paged_decomposed_prefill: offset={offset}, valid={valid}, C={C}")
    _check_cuda("paged_decomposed_prefill", r, q_rope, x_pages, kr_pages, [block_row])
    out = torch.empty((C, H, Dm), dtype=x_pages.dtype, device=x_pages.device)
    route = t1_prefill_route(x_pages.dtype, Dm, Rr)
    if route == "tensor_core":
        splits, keys = t1_chunk_plan(C, H, kv_r, offset + valid, x_pages.device)
        r, q_rope = aligned16(r), aligned16(q_rope)
        run(launcher("paged_decomposed_prefill", "paged_decomposed_prefill_mma"),
            "paged_decomposed_prefill", x_pages.device, r.data_ptr(), q_rope.data_ptr(),
            x_pages.data_ptr(), kr_pages.data_ptr(), block_row.data_ptr(), out.data_ptr(),
            C, H, kv_r, Rr, Dm, page, nb, int(offset), int(valid), splits, keys,
            float(scale))
    else:
        pps = _pages_per_split("prefill", page)
        splits = -(-nb // pps)
        part = _partials(-(-H * C // ROWS), splits, Dm, x_pages.device)
        run(launcher("paged_decomposed_prefill"), "paged_decomposed_prefill",
            x_pages.device, int(x_pages.dtype == torch.bfloat16), r.data_ptr(),
            q_rope.data_ptr(), x_pages.data_ptr(), kr_pages.data_ptr(),
            block_row.data_ptr(), out.data_ptr(), part.data_ptr(), C, H, kv_r, Rr, Dm,
            page, nb, pps, int(offset), int(valid), float(scale))
    paged_decomposed_prefill.launches += 1
    ROUTE_LAUNCHES[route] += 1
    return out


def paged_decomposed_prefill(q_nope, q_rope, x_pages, kr_pages, block_row, offset: int,
                             valid: int, w_k_nope, w_v, scale: float):
    """Chunked paged T1 prefill for one slot: the chunk's C queries attend
    the slot's X (+ roped key) pages [0, offset + valid), its own rows
    already written there. q_nope (1, C, H, Dn); q_rope (1, C, H, Rr), Rr
    may be 0; block_row (nb,) int32; offset/valid host ints. Returns
    (1, C, H, Dv); rows past ``valid`` are padding."""
    r = query_rows(q_nope, w_k_nope, x_pages.dtype)[0]
    qr = q_rope[0].to(x_pages.dtype).contiguous()
    p = paged_decomposed_prefill_fwd(r, qr, x_pages, kr_pages,
                                     block_row, offset, valid, scale)
    return value_rows(p[None], w_v)


paged_decomposed_prefill.launches = 0


# ------------------------------------------------------- contiguous decode


def decomposed_decode_plain(r, q_rope, x, k_rope, length: int, scale: float):
    """Plain version of B9: exact softmax in float32 over the first
    ``length`` positions, P accumulated in float32 and cast to x's dtype; a
    row of length 0 returns zeros. r (B, H, Dm); q_rope (B, H, Rr); x
    (B, N, Dm); k_rope (B, N, kv_r, Rr). Returns P (B, H, Dm)."""
    B, H, _ = r.shape
    N = x.shape[1]
    xf = x.float()
    s = torch.einsum("bhm,bnm->bhn", r.float(), xf)
    if q_rope.shape[-1] > 0:
        kv_r, Rr = k_rope.shape[2], k_rope.shape[3]
        qg = q_rope.reshape(B, kv_r, H // kv_r, Rr).float()
        s = s + torch.einsum("bkgr,bnkr->bkgn", qg, k_rope.float()).reshape(B, H, N)
    s = s * scale
    live = torch.arange(N, device=r.device) < int(length)
    s = s.masked_fill(~live[None, None, :], NEG_INF)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.einsum("bhn,bnm->bhm", w, xf) / w.sum(-1, keepdim=True).clamp_min(1e-30)
    return (p if int(length) > 0 else torch.zeros_like(p)).to(x.dtype)


def decomposed_decode_fwd(r, q_rope, x, k_rope, length: int, scale: float):
    """The contiguous decode sweep: r (B, H, Dm) = q_nope W_K^T and q_rope
    (B, H, Rr) in x's dtype (Rr may be 0); x (B, N, Dm); k_rope
    (B, N, kv_r, Rr) with kv_r == 1 (one roped key shared by every head, the
    TPU kernel's layout) or one per kv head; ``length`` a host int, the valid
    tokens of every row. Returns P (B, H, Dm)."""
    if x.device.type == "cpu":
        return decomposed_decode_plain(r, q_rope, x, k_rope, length, scale)
    B, H, Dm = r.shape
    _, N, Dx = x.shape
    Rr = q_rope.shape[-1]
    kv_r = _kv_r(q_rope, k_rope)
    if (Dx != Dm or x.shape[0] != B or tuple(q_rope.shape[:2]) != (B, H)
            or (Rr and tuple(k_rope.shape) != (B, N, kv_r, Rr))
            or not 0 <= int(length) <= N):
        raise ValueError(
            f"decomposed_decode: shapes r {tuple(r.shape)}, q_rope {tuple(q_rope.shape)}, "
            f"x {tuple(x.shape)}, k_rope {tuple(k_rope.shape)}, length {int(length)}")
    _check_cuda("decomposed_decode", r, q_rope, x, k_rope, [])
    out = torch.empty((B, H, Dm), dtype=x.dtype, device=x.device)
    route = t1_decode_route(x.dtype, H, Dm, kv_r, Rr)
    if route == "tensor_core":
        splits, keys = t1_decode_plan(B, H, Dm, int(length), x.device)
        part, counters = _token_scratch(B, H, Dm, splits, x.device)
        r, q_rope = aligned16(r), aligned16(q_rope)
        run(launcher("decomposed_decode", "decomposed_decode_mma"), "decomposed_decode",
            x.device, r.data_ptr(), q_rope.data_ptr(), x.data_ptr(), k_rope.data_ptr(),
            out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, H, kv_r, Rr, Dm, N,
            int(length), splits, keys, float(scale))
    else:
        split = SPLIT_TOKENS["decode"]
        part = _partials(B * -(-H // ROWS), -(-N // split), Dm, x.device)
        run(launcher("decomposed_decode"), "decomposed_decode", x.device,
            int(x.dtype == torch.bfloat16), r.data_ptr(), q_rope.data_ptr(), x.data_ptr(),
            k_rope.data_ptr(), out.data_ptr(), part.data_ptr(), B, H, kv_r, Rr, Dm, N,
            int(length), split, float(scale))
    decomposed_decode.launches += 1
    CONTIG_ROUTE_LAUNCHES[route] += 1
    return out


def decomposed_decode(q_nope, q_rope, x, k_rope, length: int, w_k_nope, w_v,
                      scale: float):
    """Contiguous T1 decode (``decomposed_decode_tpu``): R = q_nope W_K^T,
    the B9 sweep over the X arena, then P W_V. q_nope (B, 1, H, Dn); q_rope
    (B, 1, H, Rr), Rr may be 0; x (B, N, Dm); k_rope (B, N, kv_r, Rr);
    ``length`` a host int; w_k_nope (Dm, KV, Dn); w_v (Dm, KV, Dv). Returns
    (B, 1, H, Dv)."""
    r = query_rows(q_nope, w_k_nope, x.dtype)[:, 0]
    qr = q_rope[:, 0].to(x.dtype).contiguous()
    p = decomposed_decode_fwd(r, qr, x, k_rope, length, scale)
    return value_rows(p[:, None], w_v)


decomposed_decode.launches = 0
