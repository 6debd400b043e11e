"""Paged-attention kernels of the port: wrappers, plain versions, counters.

  ``paged_decode``   B1: replaces ``paged_flash_decode_fwd``
                     (src/repro/kernels/flash_attn/kernel.py:223)
  ``paged_prefill``  B2: replaces ``paged_flash_prefill_fwd``
                     (src/repro/kernels/flash_attn/kernel.py:170)

Each wrapper keeps the JAX kernel's layout. Given CPU tensors it runs its
plain PyTorch version (``*_plain``, which the tests hold against the JAX
kernels); given CUDA tensors it launches the hand-written CUDA kernel in
``csrc/`` on the current stream, or raises. It never falls back. Every launch
adds one to the wrapper's ``launches`` counter.

B1 has two routes, picked by ``decode_route`` from dtype, widths and the
block table's width before the launch and counted apart in
``DECODE_ROUTE_LAUNCHES``:

  ``ring``         bf16 or float32, Dh and Dv multiples of 16 up to 256, at
                   most RING_MAX_PAGES pages a row: one launch, a block per
                   (row, kv head) holding the row's K/V in flight in a ring
                   of asynchronous copies (``csrc/paged_token.cuh``); a unit's
                   keys split over a thread-block cluster only where the
                   units are too few to fill the card (``decode_plan``)
  ``sweep``        any other width: the CUDA-core sweep
                   (``csrc/paged_attn.cuh``) and its merge pass

B2 has two routes, picked by ``prefill_route`` from dtype and widths before
the launch and counted apart in ``ROUTE_LAUNCHES``:

  ``tensor_core``  bf16, Dh and Dv multiples of 8 up to 256: mma.sync
                   (``csrc/paged_chunk.cuh``), one launch, splits merged by
                   the last block on ``single_query.counters``
  ``sweep``        float32 (TF32 would miss the float32 gate) and any other
                   bf16 width: the CUDA-core sweep (``csrc/paged_attn.cuh``)
                   and its merge pass

Masking convention (the JAX package's): physical page 0 is the null page
whose contents are garbage; every position at or past a row's length
contributes nothing; a row of length 0 returns zeros.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build, single_query

NEG_INF = -1e30
CSRC = Path(__file__).parent / "csrc"
SOURCES = {"paged_decode": CSRC / "paged_decode.cu",
           "paged_prefill": CSRC / "paged_prefill.cu"}
ROUTE_LAUNCHES = {"tensor_core": 0, "sweep": 0}      # B2's
DECODE_ROUTE_LAUNCHES = {"ring": 0, "sweep": 0}        # B1's
RING_MAX_PAGES = 4096   # the ring route's block-table entries a row (staged in shared memory)
RING_MIN_KEYS = 128     # ... its least keys of the capacity a cluster rank takes
RING_MAX_CLUSTER = 8    # ... and most ranks a unit (the portable cluster size)
# pass 1 of the sweep splits a row's key range into runs of whole pages of
# about this many tokens, one block each (see csrc/paged_attn.cuh)
SPLIT_TOKENS = 64
CHUNK_ROWS = 16     # the tensor-core route's query rows per block (one m16 tile)
CHUNK_SPLIT_KEYS = 512  # ... its least keys per split (a block's warps take 16-key tiles)
MAX_CHUNK_SPLITS = 32   # ... and most splits (the merge keeps their weights in shared memory)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # is_bf16, q, k, v, block_table, lengths, out, part,
    # B, H, KV, Dh, Dv, page, nb, pages_per_split, scale, stream
    "paged_decode": [_I] + [_P] * 7 + [_I] * 8 + [_F, _P],
    # is_bf16, q, k, v, block_table, lengths, out,
    # B, H, KV, Dh, Dv, page, nb, cluster size, scale, stream
    "paged_decode_ring": [_I] + [_P] * 6 + [_I] * 8 + [_F, _P],
    # is_bf16, q, k, v, block_row, out, part,
    # C, H, KV, Dh, Dv, page, nb, pages_per_split, offset, valid, scale, stream
    "paged_prefill": [_I] + [_P] * 6 + [_I] * 10 + [_F, _P],
    # q, k, v, block_row, out, part, counters,
    # C, H, KV, Dh, Dv, page, nb, offset, valid, splits, split_keys, scale, stream
    "paged_prefill_mma": [_P] * 7 + [_I] * 11 + [_F, _P],
}


def launcher(name: str, entry: str | None = None):
    """The C entry point ``<entry or name>_launch`` of ``name``'s source,
    building its library first."""
    entry = entry or name
    return build.c_function(SOURCES[name], f"{entry}_launch", _ARGTYPES[entry])


def decode_route(dtype: torch.dtype, Dh: int, Dv: int, nb: int) -> str:
    """The route a paged decode (B1) takes on the card: ``ring`` for bf16 or
    float32 with Dh and Dv multiples of 16 up to 256 over at most
    RING_MAX_PAGES pages a row, ``sweep`` otherwise."""
    if (dtype in (torch.bfloat16, torch.float32) and Dh % 16 == 0 and Dv % 16 == 0
            and 16 <= min(Dh, Dv) and max(Dh, Dv) <= single_query.MAX_HEAD_DIM
            and nb <= RING_MAX_PAGES):
        return "ring"
    return "sweep"


def decode_plan(B: int, KV: int, G: int, capacity: int, device: torch.device,
                whole: single_query.Whole = single_query.WHOLE) -> int:
    """The ring route's ranks a unit, planned on the host from the units
    (rows x kv heads x head groups of 4, or 1 at G = 1) and the capacity
    nb * page, since the lengths live on the card: doubled up to
    RING_MAX_CLUSTER while the blocks still fit one to an SM and every rank
    keeps at least RING_MIN_KEYS keys of the capacity. A model shard plans
    as its ``whole`` call."""
    units = B * KV * whole.heads * (1 if G == 1 else -(-G // 4))
    sms = single_query._sm_count(device)
    cs = 1
    while (cs < RING_MAX_CLUSTER and 2 * cs * units <= sms
           and capacity >= 2 * cs * RING_MIN_KEYS):
        cs *= 2
    return cs


def prefill_route(dtype: torch.dtype, Dh: int, Dv: int) -> str:
    """The route a chunked prefill (B2, and B6 with few enough levels)
    takes on the card: ``tensor_core`` for bf16 with Dh and Dv multiples of
    8 up to 256, ``sweep`` otherwise."""
    if (dtype == torch.bfloat16 and Dh % 8 == 0 and Dv % 8 == 0
            and 8 <= min(Dh, Dv) and max(Dh, Dv) <= single_query.MAX_HEAD_DIM):
        return "tensor_core"
    return "sweep"


def chunk_plan(C: int, G: int, KV: int, end: int, Dv: int, device: torch.device,
               whole: single_query.Whole = single_query.WHOLE):
    """The tensor-core route's key splits (``single_query.plan`` over the
    (kv head, 16-row tile) pairs and ``end`` keys: about one wave, at least
    CHUNK_SPLIT_KEYS keys and at most MAX_CHUNK_SPLITS splits), its partials
    buffer and its counters: (splits, split_keys, part, counters). A model
    shard plans as its ``whole`` call."""
    tiles = -(-C * G // CHUNK_ROWS)
    splits, keys = single_query.plan(KV * whole.heads * tiles, end, device, CHUNK_SPLIT_KEYS,
                                     MAX_CHUNK_SPLITS)
    part = torch.empty(KV * tiles * CHUNK_ROWS * splits * (Dv + 2), dtype=torch.float32,
                       device=device)
    return splits, keys, part, single_query.counters(KV * tiles, device)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy when its data does not start on 16 bytes (the
    tensor-core route's 16-byte loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_cuda(name: str, floats: list[torch.Tensor], ints: list[torch.Tensor]):
    dev, dt = floats[0].device, floats[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel takes CUDA "
                         "tensors and the plain version CPU tensors")
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {dt}; the kernel takes bfloat16 or float32")
    for t in floats + ints:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    for t in floats:
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dt}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: block tables and lengths must be int32")


def run(fn, name: str, dev: torch.device, *args) -> None:
    """Call a kernel's C entry point on ``dev``'s current stream; raise on a
    launch error."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def _launch(name: str, dev: torch.device, *args) -> None:
    run(launcher(name), name, dev, *args)


# ------------------------------------------------------------------ decode


def paged_decode_plain(q, k_pages, v_pages, block_table, lengths, scale: float):
    """Plain version of B1 (the JAX package's ``paged_flash_decode_ref``):
    gather the logical view, exact softmax in float32, zeros for empty rows."""
    B, _, H, Dh = q.shape
    page, KV = k_pages.shape[1], k_pages.shape[2]
    nb = block_table.shape[1]
    g = H // KV
    bt = block_table.long()
    kl = k_pages[bt].reshape(B, nb * page, KV, Dh).float()
    vl = v_pages[bt].reshape(B, nb * page, KV, v_pages.shape[-1]).float()
    qg = q[:, 0].reshape(B, KV, g, Dh).float()
    s = torch.einsum("bkgd,bnkd->bkgn", qg, kl) * scale
    live = torch.arange(nb * page, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgn,bnkd->bkgd", w, vl) / w.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.where((lengths > 0)[:, None, None, None], o, torch.zeros_like(o))
    return o.reshape(B, 1, H, -1).to(q.dtype)


def paged_decode(q, k_pages, v_pages, block_table, lengths, scale: float,
                 whole: single_query.Whole = single_query.WHOLE):
    """Paged single-token decode. q (B, 1, H, Dh); k_pages/v_pages
    (P, page, KV, Dh|Dv); block_table (B, nb) int32, 0 = null page;
    lengths (B,) int32 live tokens per row; ``whole`` the call a model
    shard's launch is planned as. Returns (B, 1, H, Dv)."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_table, lengths, scale)
    B, T, H, Dh = q.shape
    P, page, KV, Dk = k_pages.shape
    Dv, nb = v_pages.shape[-1], block_table.shape[-1]
    if (T != 1 or Dk != Dh or H % KV or tuple(v_pages.shape[:3]) != (P, page, KV)
            or tuple(block_table.shape) != (B, nb) or tuple(lengths.shape) != (B,)):
        raise ValueError(
            f"paged_decode: shapes q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
            f"v {tuple(v_pages.shape)}, block_table {tuple(block_table.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    _check_cuda("paged_decode", [q, k_pages, v_pages], [block_table, lengths])
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    route = decode_route(q.dtype, Dh, Dv, nb)
    if route == "ring":
        if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
            raise ValueError("paged_decode: K/V arenas not 16-byte aligned")
        q = aligned16(q)
        cs = decode_plan(B, KV, H // KV, nb * page, q.device, whole)
        run(launcher("paged_decode", "paged_decode_ring"), "paged_decode", q.device,
            int(q.dtype == torch.bfloat16), q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, H, KV, Dh, Dv, page, nb, cs, float(scale))
    else:
        pps = max(1, SPLIT_TOKENS // page)
        splits = -(-nb // pps)
        part = torch.empty(B * H * splits * (Dv + 2), dtype=torch.float32, device=q.device)
        _launch("paged_decode", q.device, int(q.dtype == torch.bfloat16),
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                part.data_ptr(), B, H, KV, Dh, Dv, page, nb, pps, float(scale))
    paged_decode.launches += 1
    DECODE_ROUTE_LAUNCHES[route] += 1
    return out


paged_decode.launches = 0


# ----------------------------------------------------------------- prefill


def paged_prefill_plain(q, k_pages, v_pages, block_row, offset: int, valid: int,
                        scale: float):
    """Plain version of B2: gather the slot's logical view, mask
    ``pos < offset + valid`` and ``pos <= offset + i`` for chunk token i,
    exact softmax in float32."""
    _, C, H, Dh = q.shape
    page, KV = k_pages.shape[1], k_pages.shape[2]
    nb = block_row.shape[0]
    g = H // KV
    n = nb * page
    br = block_row.long()
    kl = k_pages[br].reshape(n, KV, Dh).float()
    vl = v_pages[br].reshape(n, KV, v_pages.shape[-1]).float()
    qg = q[0].reshape(C, KV, g, Dh).float()
    s = torch.einsum("ckgd,nkd->ckgn", qg, kl) * scale
    pos = torch.arange(n, device=q.device)
    tok = torch.arange(C, device=q.device)
    ok = (pos[None, :] < offset + valid) & (pos[None, :] <= offset + tok[:, None])
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("ckgn,nkd->ckgd", w, vl) / w.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(1, C, H, -1).to(q.dtype)


def paged_prefill(q, k_pages, v_pages, block_row, offset: int, valid: int,
                  scale: float, whole: single_query.Whole = single_query.WHOLE):
    """Chunked paged prefill for one slot: the chunk's C queries attend the
    slot's pages [0, offset + valid) under the per-token causal mask.
    q (1, C, H, Dh); block_row (nb,) int32; offset/valid host ints;
    ``whole`` the call a model shard's launch is planned as. Returns
    (1, C, H, Dv); rows past ``valid`` are padding, never read."""
    if q.device.type == "cpu":
        return paged_prefill_plain(q, k_pages, v_pages, block_row, offset, valid, scale)
    one, C, H, Dh = q.shape
    P, page, KV, Dk = k_pages.shape
    Dv, nb = v_pages.shape[-1], block_row.shape[0]
    if (one != 1 or Dk != Dh or H % KV or tuple(v_pages.shape[:3]) != (P, page, KV)
            or block_row.ndim != 1):
        raise ValueError(
            f"paged_prefill: shapes q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
            f"v {tuple(v_pages.shape)}, block_row {tuple(block_row.shape)}")
    if not (offset >= 0 and 1 <= valid <= C and offset + valid <= nb * page):
        raise ValueError(f"paged_prefill: offset={offset}, valid={valid}, C={C}, "
                         f"{nb} pages of {page}")
    _check_cuda("paged_prefill", [q, k_pages, v_pages], [block_row])
    out = torch.empty((1, C, H, Dv), dtype=q.dtype, device=q.device)
    route = prefill_route(q.dtype, Dh, Dv)
    if route == "tensor_core":
        splits, keys, part, counters = chunk_plan(C, H // KV, KV, offset + valid, Dv,
                                                  q.device, whole)
        q = aligned16(q)
        run(launcher("paged_prefill", "paged_prefill_mma"), "paged_prefill", q.device,
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_row.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(),
            C, H, KV, Dh, Dv, page, nb, int(offset), int(valid), splits, keys,
            float(scale))
    else:
        pps = max(1, SPLIT_TOKENS // page)
        splits = -(-nb // pps)
        part = torch.empty(C * H * splits * (Dv + 2), dtype=torch.float32, device=q.device)
        _launch("paged_prefill", q.device, int(q.dtype == torch.bfloat16),
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_row.data_ptr(), out.data_ptr(), part.data_ptr(),
                C, H, KV, Dh, Dv, page, nb, pps, int(offset), int(valid), float(scale))
    paged_prefill.launches += 1
    ROUTE_LAUNCHES[route] += 1
    return out


paged_prefill.launches = 0
