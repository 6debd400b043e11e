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

Masking convention (the JAX package's): physical page 0 is the null page
whose contents are garbage; every position at or past a row's length
contributes nothing; a row of length 0 returns zeros.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
CSRC = Path(__file__).parent / "csrc"
SOURCES = {"paged_decode": CSRC / "paged_decode.cu",
           "paged_prefill": CSRC / "paged_prefill.cu"}
# pass 1 of the kernels splits a row's key range into runs of whole pages of
# about this many tokens, one block each (see csrc/paged_attn.cuh)
SPLIT_TOKENS = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # is_bf16, q, k, v, block_table, lengths, out, part,
    # B, H, KV, Dh, Dv, page, nb, pages_per_split, scale, stream
    "paged_decode": [_I] + [_P] * 7 + [_I] * 8 + [_F, _P],
    # is_bf16, q, k, v, block_row, out, part,
    # C, H, KV, Dh, Dv, page, nb, pages_per_split, offset, valid, scale, stream
    "paged_prefill": [_I] + [_P] * 6 + [_I] * 10 + [_F, _P],
}


def launcher(name: str):
    """The C entry point ``<name>_launch``, building its library first."""
    return build.c_function(SOURCES[name], f"{name}_launch", _ARGTYPES[name])


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


def paged_decode(q, k_pages, v_pages, block_table, lengths, scale: float):
    """Paged single-token decode. q (B, 1, H, Dh); k_pages/v_pages
    (P, page, KV, Dh|Dv); block_table (B, nb) int32, 0 = null page;
    lengths (B,) int32 live tokens per row. Returns (B, 1, H, Dv)."""
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
    pps = max(1, SPLIT_TOKENS // page)
    splits = -(-nb // pps)
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    part = torch.empty(B * H * splits * (Dv + 2), dtype=torch.float32, device=q.device)
    _launch("paged_decode", q.device, int(q.dtype == torch.bfloat16),
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), B, H, KV, Dh, Dv, page, nb, pps, float(scale))
    paged_decode.launches += 1
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
                  scale: float):
    """Chunked paged prefill for one slot: the chunk's C queries attend the
    slot's pages [0, offset + valid) under the per-token causal mask.
    q (1, C, H, Dh); block_row (nb,) int32; offset/valid host ints. Returns
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
    if not (offset >= 0 and 1 <= valid <= C):
        raise ValueError(f"paged_prefill: offset={offset}, valid={valid}, C={C}")
    _check_cuda("paged_prefill", [q, k_pages, v_pages], [block_row])
    pps = max(1, SPLIT_TOKENS // page)
    splits = -(-nb // pps)
    out = torch.empty((1, C, H, Dv), dtype=q.dtype, device=q.device)
    part = torch.empty(C * H * splits * (Dv + 2), dtype=torch.float32, device=q.device)
    _launch("paged_prefill", q.device, int(q.dtype == torch.bfloat16),
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_row.data_ptr(), out.data_ptr(), part.data_ptr(),
            C, H, KV, Dh, Dv, page, nb, pps, int(offset), int(valid), float(scale))
    paged_prefill.launches += 1
    return out


paged_prefill.launches = 0
