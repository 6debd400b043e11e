"""T2 attention kernels over CPQ code pages: wrappers, plain versions,
counters.

  ``paged_cpq_decode``   B5: replaces ``paged_cpq_decode_fwd``
                         (src/repro/kernels/cpq_dequant_attn/kernel.py:281)
  ``paged_cpq_prefill``  B6: replaces ``paged_cpq_prefill_fwd``
                         (src/repro/kernels/cpq_dequant_attn/kernel.py:213)
  ``cpq_decode``         B10: replaces ``cpq_decode_fwd``
                         (src/repro/kernels/cpq_dequant_attn/kernel.py:338), the
                         static engine's T2 decode over contiguous code arenas

The wrappers take the arenas as the JAX ops do (``cpq_dequant_attn/ops.py``):
``kt``/``vt`` are ``PagedCPQTensor``s with code pages (P, page, KV, D) int8,
level pages (P, page, KV) int32 and per-slot scale/zero tables
(num_slots, L, KV, D) float32, or, for B10, contiguous ``CPQTensor``s with
codes (B, N, KV, D), levels (B, N, KV) and per-row tables (B, L, KV, D). Given CPU tensors a wrapper runs its plain
PyTorch version (``*_plain``, which the tests hold against the JAX kernels);
given CUDA tensors it launches the hand-written CUDA kernel in ``csrc/`` on
the current stream, or raises. It never falls back. Every launch adds one to
the wrapper's ``launches`` counter.

B6 has two routes, picked by ``cpq_prefill_route`` from dtype, widths and
levels before the launch and counted apart in ``ROUTE_LAUNCHES``:
``tensor_core`` (bf16, Dh and Dv multiples of 8 up to 256, up to
``MAX_CHUNK_LEVELS`` levels: mma.sync over tiles dequantized in registers,
``paged_attn/csrc/paged_chunk.cuh``) and ``sweep`` (everything else: the
CUDA-core sweep of ``csrc/cpq_attn.cuh``).

B5 has two routes too, picked by ``cpq_decode_route`` from the widths and
counted apart in ``DECODE_ROUTE_LAUNCHES``: ``single_query`` (Dh and Dv
multiples of 16 up to 256, bf16 or float32: the single-query decode of
``flash_attn/csrc/single_query.cuh`` with its code loader and paged
addressing, splits of ``DECODE_SPLIT_KEYS`` planned from the arena's
capacity and merged by the last block) and ``sweep`` (other widths:
``csrc/cpq_attn.cuh``'s sweep).

Semantics (the TPU kernels'): a stored code ``c8`` means ``c = c8 + 128``;
``c == 0`` is exactly 0, else ``(c - 1) * scale[level] + zero[level]``; a
level outside [0, L) reads scale = zero = 0. The dequantized K and V are
rounded to bf16 and back to float32; a prefill chunk's own raw K/V is not.
B10 rounds only when asked (``round_tiles``): its TPU kernel does not, the
contiguous decode the static engine serves (``cpq_chunked_decode_attention``)
does.
Positions at or past a row's length contribute nothing and a row of length
0 returns zeros. Outputs are computed in float32 and returned in q's dtype.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.cpq import CPQTensor, decode_codes, take_levels
from repro_torch.kernels import build, single_query
from repro_torch.kernels.paged_attn.ops import (NEG_INF, SPLIT_TOKENS, aligned16,
                                                chunk_plan, prefill_route, run)

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"paged_cpq_decode": CSRC / "paged_cpq_decode.cu",
           "paged_cpq_prefill": CSRC / "paged_cpq_prefill.cu",
           "cpq_decode": CSRC / "cpq_decode.cu"}
ROUTE_LAUNCHES = {"tensor_core": 0, "sweep": 0}  # B6's launches by route
DECODE_ROUTE_LAUNCHES = {"single_query": 0, "sweep": 0}  # B5's
MAX_CHUNK_LEVELS = 16  # the tensor-core route keeps the slot's tables in shared memory
# B5's single_query route: keys per split, one pass of a block's 4 warps of
# 32 keys at the served width (faster than 64 or 256 on an H100: PERF.md,
# section 6), and most splits, past which long arenas take longer splits
DECODE_SPLIT_KEYS = 128
DECODE_MAX_SPLITS = 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # is_bf16, q, codes_k, codes_v, level_k, level_v, scale_k, zero_k,
    # scale_v, zero_v, block_table, lengths, out, part,
    # B, H, KV, Dh, Dv, page, nb, L, pages_per_split, scale, stream
    "paged_cpq_decode": [_I] + [_P] * 13 + [_I] * 9 + [_F, _P],
    # is_bf16, q, codes_k, codes_v, level_k, level_v, scale_k, zero_k,
    # scale_v, zero_v, block_table, lengths, out, part, counters,
    # B, H, KV, Dh, Dv, page, nb, L, splits, split_keys, scale, stream
    "paged_cpq_decode_sq": [_I] + [_P] * 14 + [_I] * 10 + [_F, _P],
    # is_bf16, q, codes_k, codes_v, level_k, level_v, scale_k, zero_k,
    # scale_v, zero_v, k_raw, v_raw, block_row, out, part,
    # C, H, KV, Dh, Dv, page, nb, L, pages_per_split, page_splits, offset,
    # valid, scale, stream
    "paged_cpq_prefill": [_I] + [_P] * 14 + [_I] * 12 + [_F, _P],
    # q, codes_k, codes_v, level_k, level_v, scale_k, zero_k, scale_v, zero_v,
    # k_raw, v_raw, block_row, out, part, counters,
    # C, H, KV, Dh, Dv, page, nb, L, offset, valid, splits, split_keys, scale, stream
    "paged_cpq_prefill_mma": [_P] * 15 + [_I] * 12 + [_F, _P],
    # round_tiles, q, codes_k, codes_v, level_k, level_v, scale_k, zero_k,
    # scale_v, zero_v, out, part, counters, B, KV, G, Dh, Dv, N, L, length,
    # splits, split_keys, scale, stream
    "cpq_decode": [_I] + [_P] * 12 + [_I] * 10 + [_F, _P],
}


def launcher(name: str, entry: str | None = None):
    """The C entry point ``<entry or name>_launch`` of ``name``'s source,
    building its library first."""
    entry = entry or name
    return build.c_function(SOURCES[name], f"{entry}_launch", _ARGTYPES[entry])


def cpq_prefill_route(dtype: torch.dtype, Dh: int, Dv: int, levels: int) -> str:
    """The route B6 takes on the card: ``tensor_core`` where B2 would take
    it and the tables have at most ``MAX_CHUNK_LEVELS`` levels, ``sweep``
    otherwise."""
    if levels <= MAX_CHUNK_LEVELS and prefill_route(dtype, Dh, Dv) == "tensor_core":
        return "tensor_core"
    return "sweep"


def cpq_decode_route(Dh: int, Dv: int) -> str:
    """The route B5 takes on the card: ``single_query`` for Dh and Dv
    multiples of 16 (the code loader's 16-byte chunk) up to 256, ``sweep``
    otherwise; either dtype."""
    if (Dh % 16 == 0 and Dv % 16 == 0 and 16 <= min(Dh, Dv)
            and max(Dh, Dv) <= single_query.MAX_HEAD_DIM):
        return "single_query"
    return "sweep"


def decode_plan(capacity: int) -> tuple[int, int]:
    """B5's single_query key splits over ``capacity`` = nb * page keys,
    planned on the host without reading the lengths (they live on the
    card; the blocks of splits past a row's length exit at once): splits of
    DECODE_SPLIT_KEYS keys, longer ones (a multiple of 16) past
    DECODE_MAX_SPLITS of them. Returns (splits, keys per split)."""
    keys = max(DECODE_SPLIT_KEYS, -(-capacity // (16 * DECODE_MAX_SPLITS)) * 16)
    return -(-capacity // keys), keys


def _check_cuda(name: str, q: torch.Tensor, kt, vt, ints: list[torch.Tensor],
                raw: tuple = ()):
    dev, dt = q.device, q.dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel takes CUDA "
                         "tensors and the plain version CPU tensors")
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {dt}; the kernel takes bfloat16 or float32")
    want = [(q, dt), *((t, dt) for t in raw), *((t, torch.int32) for t in ints)]
    for t in (kt, vt):
        want += [(t.codes, torch.int8), (t.level, torch.int32),
                 (t.scale, torch.float32), (t.zero, torch.float32)]
    for t, kind in want:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
        if t.dtype != kind:
            raise TypeError(f"{name}: a {t.dtype} tensor where the kernel takes {kind}")


def _check_arenas(name: str, kt, vt, KV: int, Dh: int):
    P, page, kv, Dk = kt.codes.shape
    L = kt.scale.shape[1]
    Dv = vt.codes.shape[-1]
    if (kv != KV or Dk != Dh or tuple(vt.codes.shape[:3]) != (P, page, KV)
            or tuple(kt.level.shape) != (P, page, KV)
            or tuple(vt.level.shape) != (P, page, KV)
            or tuple(kt.scale.shape[1:]) != (L, KV, Dh)
            or tuple(kt.zero.shape) != tuple(kt.scale.shape)
            or tuple(vt.scale.shape) != (kt.scale.shape[0], L, KV, Dv)
            or tuple(vt.zero.shape) != tuple(vt.scale.shape)):
        raise ValueError(
            f"{name}: arena shapes codes {tuple(kt.codes.shape)}/{tuple(vt.codes.shape)}, "
            f"levels {tuple(kt.level.shape)}/{tuple(vt.level.shape)}, tables "
            f"{tuple(kt.scale.shape)}/{tuple(vt.scale.shape)}")
    return P, page, L, Dv


def _dequant_view(t, table_rows: slice, pages: torch.Tensor) -> torch.Tensor:
    """Logical float32 view of a code arena through (B, nb) ``pages``,
    rounded to bf16 like the kernels' tiles: (B, nb * page, KV, D)."""
    B, nb = pages.shape
    page, KV, D = t.codes.shape[1:]
    codes = t.codes[pages].reshape(B, nb * page, KV, D)
    level = t.level[pages].reshape(B, nb * page, KV)
    return decode_codes(codes, take_levels(t.scale[table_rows], level),
                        take_levels(t.zero[table_rows], level), torch.bfloat16).float()


# ------------------------------------------------------------------ decode


def paged_cpq_decode_plain(q, kt, vt, block_table, lengths, scale: float):
    """Plain version of B5 (the JAX package's ``paged_cpq_decode_ref``):
    dequantize the logical views, exact softmax in float32, zeros for empty
    rows."""
    B, _, H, Dh = q.shape
    KV = kt.codes.shape[2]
    g = H // KV
    bt = block_table.long()
    kl = _dequant_view(kt, slice(None), bt)
    vl = _dequant_view(vt, slice(None), bt)
    qg = q[:, 0].reshape(B, KV, g, Dh).float()
    s = torch.einsum("bkgd,bnkd->bkgn", qg, kl) * scale
    live = torch.arange(kl.shape[1], device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgn,bnkd->bkgd", w, vl) / w.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.where((lengths > 0)[:, None, None, None], o, torch.zeros_like(o))
    return o.reshape(B, 1, H, -1).to(q.dtype)


def paged_cpq_decode(q, kt, vt, block_table, lengths, scale: float):
    """Paged T2 decode. q (B, 1, H, Dh); kt/vt ``PagedCPQTensor`` arenas whose
    tables are indexed by row (num_slots == B); block_table (B, nb) int32,
    0 = null page; lengths (B,) int32. Returns (B, 1, H, Dv)."""
    if q.device.type == "cpu":
        return paged_cpq_decode_plain(q, kt, vt, block_table, lengths, scale)
    B, T, H, Dh = q.shape
    KV, nb = kt.codes.shape[2], block_table.shape[-1]
    P, page, L, Dv = _check_arenas("paged_cpq_decode", kt, vt, KV, Dh)
    if (T != 1 or H % KV or kt.scale.shape[0] != B
            or tuple(block_table.shape) != (B, nb) or tuple(lengths.shape) != (B,)):
        raise ValueError(
            f"paged_cpq_decode: shapes q {tuple(q.shape)}, tables "
            f"{tuple(kt.scale.shape)}, block_table {tuple(block_table.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    _check_cuda("paged_cpq_decode", q, kt, vt, [block_table, lengths])
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    arenas = (kt.codes.data_ptr(), vt.codes.data_ptr(), kt.level.data_ptr(),
              vt.level.data_ptr(), kt.scale.data_ptr(), kt.zero.data_ptr(),
              vt.scale.data_ptr(), vt.zero.data_ptr(), block_table.data_ptr(),
              lengths.data_ptr(), out.data_ptr())
    route = cpq_decode_route(Dh, Dv)
    if route == "single_query":
        splits, keys = decode_plan(nb * page)
        part = torch.empty(B * H * splits * (Dv + 2), dtype=torch.float32, device=q.device)
        run(launcher("paged_cpq_decode", "paged_cpq_decode_sq"), "paged_cpq_decode",
            q.device, int(q.dtype == torch.bfloat16), q.data_ptr(), *arenas,
            part.data_ptr(), single_query.counters(B * H, q.device).data_ptr(),
            B, H, KV, Dh, Dv, page, nb, L, splits, keys, float(scale))
    else:
        pps = max(1, SPLIT_TOKENS // page)
        splits = -(-nb // pps)
        part = torch.empty(B * H * splits * (Dv + 2), dtype=torch.float32, device=q.device)
        run(launcher("paged_cpq_decode"), "paged_cpq_decode", q.device,
            int(q.dtype == torch.bfloat16), q.data_ptr(), *arenas, part.data_ptr(),
            B, H, KV, Dh, Dv, page, nb, L, pps, float(scale))
    paged_cpq_decode.launches += 1
    DECODE_ROUTE_LAUNCHES[route] += 1
    return out


paged_cpq_decode.launches = 0


# ----------------------------------------------------------------- prefill


def paged_cpq_prefill_plain(q, kt, vt, k_raw, v_raw, slot: int, block_row,
                            offset: int, valid: int, scale: float):
    """Plain version of B6: the slot's dequantized pages, positions
    < ``offset``, then the chunk's raw K/V with ``col < valid`` and
    ``col <= i`` for chunk token i; exact softmax in float32."""
    _, C, H, Dh = q.shape
    KV = kt.codes.shape[2]
    g = H // KV
    rows = slice(slot, slot + 1)
    br = block_row.long()[None]
    k_all = torch.cat([_dequant_view(kt, rows, br)[0], k_raw[0].float()])
    v_all = torch.cat([_dequant_view(vt, rows, br)[0], v_raw[0].float()])
    n = k_all.shape[0] - C
    qg = q[0].reshape(C, KV, g, Dh).float()
    s = torch.einsum("ckgd,nkd->ckgn", qg, k_all) * scale
    tok = torch.arange(C, device=q.device)[:, None]
    col = torch.arange(n + C, device=q.device)[None, :] - n
    ok = torch.where(col < 0, col + n < offset, (col < valid) & (col <= tok))
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("ckgn,nkd->ckgd", w, v_all) / w.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(1, C, H, -1).to(q.dtype)


def paged_cpq_prefill(q, kt, vt, k_raw, v_raw, slot: int, block_row,
                      offset: int, valid: int, scale: float):
    """Chunked paged T2 prefill for one slot. q (1, C, H, Dh) roped chunk
    queries; kt/vt ``PagedCPQTensor`` arenas; k_raw/v_raw (1, C, KV, Dh|Dv)
    the chunk's raw roped K/V in q's dtype; slot, offset, valid host ints;
    block_row (nb,) int32. Returns (1, C, H, Dv); rows past ``valid`` are
    padding, never read."""
    if q.device.type == "cpu":
        return paged_cpq_prefill_plain(q, kt, vt, k_raw, v_raw, slot, block_row,
                                       offset, valid, scale)
    one, C, H, Dh = q.shape
    KV, nb = kt.codes.shape[2], block_row.shape[0]
    P, page, L, Dv = _check_arenas("paged_cpq_prefill", kt, vt, KV, Dh)
    if (one != 1 or H % KV or block_row.ndim != 1
            or tuple(k_raw.shape) != (1, C, KV, Dh) or tuple(v_raw.shape) != (1, C, KV, Dv)
            or not 0 <= slot < kt.scale.shape[0]):
        raise ValueError(
            f"paged_cpq_prefill: shapes q {tuple(q.shape)}, k_raw {tuple(k_raw.shape)}, "
            f"v_raw {tuple(v_raw.shape)}, block_row {tuple(block_row.shape)}, slot {slot}")
    if not (offset >= 0 and 1 <= valid <= C and offset <= nb * page):
        raise ValueError(f"paged_cpq_prefill: offset={offset}, valid={valid}, C={C}, "
                         f"{nb} pages of {page}")
    k_raw, v_raw = k_raw.contiguous(), v_raw.contiguous()
    _check_cuda("paged_cpq_prefill", q, kt, vt, [block_row], (k_raw, v_raw))
    out = torch.empty((1, C, H, Dv), dtype=q.dtype, device=q.device)
    tables = (kt.scale[slot], kt.zero[slot], vt.scale[slot], vt.zero[slot])
    route = cpq_prefill_route(q.dtype, Dh, Dv, L)
    if route == "tensor_core":
        splits, keys, part, counters = chunk_plan(C, H // KV, KV, offset + valid, Dv,
                                                  q.device)
        q, k_raw, v_raw = aligned16(q), aligned16(k_raw), aligned16(v_raw)
        run(launcher("paged_cpq_prefill", "paged_cpq_prefill_mma"), "paged_cpq_prefill",
            q.device, q.data_ptr(), kt.codes.data_ptr(), vt.codes.data_ptr(),
            kt.level.data_ptr(), vt.level.data_ptr(), *(t.data_ptr() for t in tables),
            k_raw.data_ptr(), v_raw.data_ptr(), block_row.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), C, H, KV, Dh, Dv, page, nb, L,
            int(offset), int(valid), splits, keys, float(scale))
    else:
        pps = max(1, SPLIT_TOKENS // page)
        page_splits = -(-min(-(-offset // page), nb) // pps)
        splits = page_splits + 1                       # + the raw chunk tail
        part = torch.empty(C * H * splits * (Dv + 2), dtype=torch.float32, device=q.device)
        run(launcher("paged_cpq_prefill"), "paged_cpq_prefill", q.device,
            int(q.dtype == torch.bfloat16), q.data_ptr(),
            kt.codes.data_ptr(), vt.codes.data_ptr(), kt.level.data_ptr(),
            vt.level.data_ptr(), *(t.data_ptr() for t in tables), k_raw.data_ptr(),
            v_raw.data_ptr(), block_row.data_ptr(), out.data_ptr(), part.data_ptr(),
            C, H, KV, Dh, Dv, page, nb, L, pps, page_splits, int(offset), int(valid),
            float(scale))
    paged_cpq_prefill.launches += 1
    ROUTE_LAUNCHES[route] += 1
    return out


paged_cpq_prefill.launches = 0


# ------------------------------------------------------- contiguous decode


def cpq_decode_plain(q, codes_k, codes_v, scale_k, zero_k, scale_v, zero_v, level_k,
                     level_v, length: int, scale: float, round_tiles: bool = False):
    """Plain version of B10 (the JAX package's ``cpq_decode_ref``, with the
    bf16 rounding of ``cpq_chunked_decode_attention`` when ``round_tiles``):
    dequantize, exact softmax in float32 over the first ``length``
    positions; a length of 0 returns zeros. q (B, KV, G, Dh). Returns
    (B, KV, G, Dv) float32."""
    N = codes_k.shape[1]

    def dequant(codes, s_tab, z_tab, level):
        out = decode_codes(codes, take_levels(s_tab, level), take_levels(z_tab, level),
                           torch.bfloat16 if round_tiles else torch.float32)
        return out.float()

    k = dequant(codes_k, scale_k, zero_k, level_k)
    v = dequant(codes_v, scale_v, zero_v, level_v)
    s = torch.einsum("bkgd,bnkd->bkgn", q.float(), k) * scale
    live = torch.arange(N, device=q.device) < int(length)
    s = s.masked_fill(~live, NEG_INF)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgn,bnkd->bkgd", w, v) / w.sum(-1, keepdim=True).clamp_min(1e-30)
    return o if int(length) > 0 else torch.zeros_like(o)


def cpq_decode_fwd(q, codes_k, codes_v, scale_k, zero_k, scale_v, zero_v, level_k,
                   level_v, length: int, scale: float, round_tiles: bool = False):
    """The contiguous T2 decode, with the TPU kernel's arguments: q
    (B, KV, G, Dh) (taken to float32); codes_* (B, N, KV, D*) int8; scale_*
    and zero_* (B, L, KV, D*) float32; level_* (B, N, KV) int32; ``length``
    a host int, the valid tokens of every row. Returns (B, KV, G, Dv)
    float32."""
    args = (q, codes_k, codes_v, scale_k, zero_k, scale_v, zero_v, level_k, level_v,
            length, scale, round_tiles)
    if q.device.type == "cpu":
        return cpq_decode_plain(*args)
    B, KV, G, Dh = q.shape
    _, N, _, Dv = codes_v.shape
    L = scale_k.shape[1]
    if (tuple(codes_k.shape) != (B, N, KV, Dh) or tuple(codes_v.shape[:3]) != (B, N, KV)
            or tuple(level_k.shape) != (B, N, KV) or tuple(level_v.shape) != (B, N, KV)
            or tuple(scale_k.shape) != (B, L, KV, Dh) or zero_k.shape != scale_k.shape
            or tuple(scale_v.shape) != (B, L, KV, Dv) or zero_v.shape != scale_v.shape
            or not 0 <= int(length) <= N):
        raise ValueError(
            f"cpq_decode: shapes q {tuple(q.shape)}, codes {tuple(codes_k.shape)}/"
            f"{tuple(codes_v.shape)}, levels {tuple(level_k.shape)}/{tuple(level_v.shape)}, "
            f"tables {tuple(scale_k.shape)}/{tuple(scale_v.shape)}, length {int(length)}")
    qf = q.float().contiguous()
    kt, vt = (CPQTensor(codes=c, scale=sc, zero=z, level=lv, num_levels=None, prune_thr=None)
              for c, sc, z, lv in ((codes_k, scale_k, zero_k, level_k),
                                   (codes_v, scale_v, zero_v, level_v)))
    _check_cuda("cpq_decode", qf, kt, vt, [])
    if Dh % 16 or Dv % 16 or max(Dh, Dv) > single_query.MAX_HEAD_DIM:
        raise ValueError(f"cpq_decode: Dh={Dh}, Dv={Dv}; the kernel takes multiples of 16 "
                         f"up to {single_query.MAX_HEAD_DIM}")
    splits, keys = single_query.plan(B * KV * -(-G // 4), int(length), q.device)
    out = torch.empty((B, KV, G, Dv), dtype=torch.float32, device=q.device)
    part = torch.empty(B * KV * G * splits * (Dv + 2), dtype=torch.float32, device=q.device)
    run(launcher("cpq_decode"), "cpq_decode", q.device, int(round_tiles), qf.data_ptr(),
        codes_k.data_ptr(), codes_v.data_ptr(), level_k.data_ptr(), level_v.data_ptr(),
        scale_k.data_ptr(), zero_k.data_ptr(), scale_v.data_ptr(), zero_v.data_ptr(),
        out.data_ptr(), part.data_ptr(), single_query.counters(B * KV * G, q.device).data_ptr(),
        B, KV, G, Dh, Dv, N, L, int(length), splits, keys, float(scale))
    cpq_decode.launches += 1
    return out


def cpq_decode(q, kt, vt, length: int, scale: float, round_tiles: bool = True):
    """Contiguous T2 decode over a ``CPQKVCache``'s tensors (``cpq_decode_tpu``):
    q (B, 1, H, Dh) roped; kt/vt ``CPQTensor``s; ``length`` a host int.
    ``round_tiles`` (on by default) gives the function the static engine
    serves, ``cpq_chunked_decode_attention``. Returns (B, 1, H, Dv) in q's
    dtype."""
    B, _, H, Dh = q.shape
    KV = kt.codes.shape[2]
    out = cpq_decode_fwd(q[:, 0].reshape(B, KV, H // KV, Dh), kt.codes, vt.codes, kt.scale,
                         kt.zero, vt.scale, vt.zero, kt.level, vt.level, length, scale,
                         round_tiles)
    return out.reshape(B, 1, H, -1).to(q.dtype)


cpq_decode.launches = 0
