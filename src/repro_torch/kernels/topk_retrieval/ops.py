"""T3 proxy-scoring kernel of the port: wrappers, plain versions, counters.

  ``proxy_scores``        B7: replaces ``proxy_scores_fwd``
                          (src/repro/kernels/topk_retrieval/kernel.py:39), its
                          contiguous contract: codes (B, N, KV, Dp), one length,
                          the query factors given
  ``paged_proxy_scores``  B7 over the arena's proxy code pages through the
                          block table, with per-row lengths, the query factors
                          formed in the kernel: the served call

and the JAX package's ops around it (``topk_retrieval/ops.py``):
``proxy_scores_q`` (``proxy_scores_tpu``: the factors formed in the kernel
over contiguous codes) and ``retrieval_decode`` (``retrieval_decode_tpu``:
kernel sweep, then top-k and the exact re-score, without calibration as
there, or with it: the static engine's T3 decode).

Every wrapper issues one launch of one CUDA kernel, ``csrc/proxy_scores.cu``
(``proxy_scores_launch`` with the factors given, ``proxy_scores_fused_launch``
forming them from q and the slot's proxy tables). Given CPU tensors a
wrapper runs its plain PyTorch version (``*_plain``, which the tests hold
against the JAX kernel); given CUDA tensors it launches the kernel on the
current stream, or raises. It never falls back. Every launch adds one to the
wrapper's ``launches`` counter (``proxy_scores_q``'s to ``proxy_scores``'s,
the contiguous form's).

Semantics (the TPU kernel's): a stored code ``c8`` means ``c8 + 128``; the
score of key n is ``qs . (c8 + 128) + qz`` in float32 for n below the row's
length and -1e30 from there on. The fused form computes ``qs = float(q) *
scale`` as ``query_factors`` does (bit-identical) and ``qz = float(q) .
zero`` in another order of summation than its einsum.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import retrieval_attention as ret_lib
from repro_torch.core.attention import length_mask
from repro_torch.kernels import build
from repro_torch.kernels.paged_attn.ops import NEG_INF, run

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"proxy_scores": CSRC / "proxy_scores.cu"}
SOURCES["paged_proxy_scores"] = SOURCES["proxy_scores"]  # one kernel, two contracts

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_ARGTYPES = {
    # qs, qz, codes, block_table, lengths, len_stride, len, out,
    # B, KV, G, Dp, page, nb, N, stream
    "proxy_scores": [_P] * 5 + [_I] * 2 + [_P] + [_I] * 7 + [_P],
    # q_bf16, q, q_sb, q_sh, has_mul, q_mul, scale, zero, codes, block_table,
    # lengths, len_stride, len, out, B, KV, G, Dp, page, nb, N, stream
    "proxy_scores_fused": [_I, _P, _L, _L, _I, _F] + [_P] * 5 + [_I] * 2 + [_P]
                          + [_I] * 7 + [_P],
}
MAX_DP = 256                 # proxy channels: 16, 32, 64, 128 or 256


def launcher(name: str = "proxy_scores", entry: str = "proxy_scores"):
    """The C entry point ``<entry>_launch`` of ``name``'s source, building its
    library first."""
    return build.c_function(SOURCES[name], f"{entry}_launch", _ARGTYPES[entry])


def query_factors(q: torch.Tensor, proxy_scale: torch.Tensor, proxy_zero: torch.Tensor):
    """The per-head query factors of the sweep (``proxy_scores_tpu``):
    q (B, H, Dp) pre-scaled query, proxy_scale/zero (B, KV, Dp) -> qs
    (B, KV, G, Dp) = q * scale and qz (B, KV, G, 1) = q . zero, float32."""
    B, H, Dp = q.shape
    KV = proxy_scale.shape[1]
    qf = q.float().reshape(B, KV, H // KV, Dp)
    qs = qf * proxy_scale[:, :, None, :]
    qz = torch.einsum("bkgd,bkd->bkg", qf, proxy_zero)[..., None]
    return qs.contiguous(), qz.contiguous()


def _check_cuda(name: str, floats, codes, block_table, lengths):
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel takes CUDA "
                         "tensors and the plain version CPU tensors")
    for t, kind in [(f, torch.float32) for f in floats] + [
            (codes, torch.int8), (block_table, torch.int32), (lengths, torch.int32)]:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
        if t.dtype != kind:
            raise TypeError(f"{name}: a {t.dtype} tensor where the kernel takes {kind}")
    Dp = codes.shape[-1]
    if Dp not in (16, 32, 64, 128, 256):
        raise ValueError(f"{name}: Dp={Dp}; the kernel takes Dp 16, 32, 64, 128 or "
                         f"{MAX_DP}")
    if codes.data_ptr() % 16:
        raise ValueError(f"{name}: code pages not 16-byte aligned")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A float tensor whose data starts on 16 bytes (a copy if it does not)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lengths(length) -> tuple:
    """(lengths tensor or None, its stride, a host length): an int or a ()
    tensor on the host is passed by value (no copy, no sync); a tensor on
    the card, or one of a length a row, by pointer (checked by the caller)."""
    if isinstance(length, torch.Tensor) and (length.device.type != "cpu"
                                             or length.numel() != 1):
        t = length.reshape(-1)
        if t.numel() == 1 and t.dtype != torch.int32:
            t = t.to(torch.int32)
        return t, int(t.numel() != 1), 0
    return None, 0, int(length)


def _launch_fused(name: str, q, q_scale, proxy_scale, proxy_zero, pages, block_table,
                  length, n: int) -> torch.Tensor:
    """One launch of the kernel forming the factors: q (B, H, Dp) rows at any
    stride, code pages (P, page, KV, Dp) through ``block_table`` with
    lengths (B,) (None: the contiguous (B, N, KV, Dp) codes, one page of N a
    row, and one length). Returns (B, KV, G, n) float32."""
    B, H, Dp = q.shape
    P, page, KV, pdp = pages.shape
    nb = block_table.shape[-1] if block_table is not None else 1
    if block_table is None:
        page = n
    if (pdp != Dp or H % KV or tuple(proxy_scale.shape) != (B, KV, Dp)
            or tuple(proxy_zero.shape) != (B, KV, Dp)
            or (block_table is not None and tuple(block_table.shape) != (B, nb))
            or (block_table is None and (P, page) != (B, pages.shape[1]))
            or not 0 <= n <= nb * page):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, scale {tuple(proxy_scale.shape)}, zero "
            f"{tuple(proxy_zero.shape)}, codes {tuple(pages.shape)}, block_table "
            f"{None if block_table is None else tuple(block_table.shape)}, n={n}")
    # the paged form's lengths (B,) always by pointer
    lens, stride, host_len = (length, 1, 0) if block_table is not None else _lengths(length)
    if lens is not None and lens.numel() not in (1, B):
        raise ValueError(f"{name}: lengths {tuple(length.shape)} for {B} rows")
    _check_cuda(name, [proxy_scale, proxy_zero], pages, block_table, lens)
    if q.device != pages.device:
        raise ValueError(f"{name}: tensors on {q.device} and {pages.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):  # other types: multiplied here
        q = (q * q_scale if q_scale is not None else q).float()
        q_scale = None
    quad = 4 * q.element_size()  # the kernel reads q four elements at a time
    if (q.stride(-1) != 1 or q.data_ptr() % quad or (q.stride(0) * q.element_size()) % quad
            or (q.stride(1) * q.element_size()) % quad):
        q = q.clone(memory_format=torch.contiguous_format)
    G = H // KV
    out = torch.empty((B, KV, G, n), dtype=torch.float32, device=pages.device)
    sc, ze = _aligned(proxy_scale), _aligned(proxy_zero)
    run(launcher(name, "proxy_scores_fused"), name, pages.device,
        int(q.dtype == torch.bfloat16), q.data_ptr(), q.stride(0), q.stride(1),
        int(q_scale is not None), float(q_scale or 0.0), sc.data_ptr(), ze.data_ptr(),
        pages.data_ptr(),
        None if block_table is None else block_table.data_ptr(),
        None if lens is None else lens.data_ptr(), stride, host_len, out.data_ptr(),
        B, KV, G, Dp, page, nb, int(n))
    return out


# --------------------------------------------------------- contiguous (B7)


def proxy_scores_plain(qs, qz, codes, length):
    """Plain version of B7 (the JAX package's ``proxy_scores_ref``): qs
    (B, KV, G, Dp), qz (B, KV, G, 1), codes (B, N, KV, Dp) int8, length an
    int, a () tensor or (B,) -> (B, KV, G, N) float32."""
    c = codes.float() + 128.0
    s = torch.einsum("bkgd,bnkd->bkgn", qs.float(), c) + qz.float()
    live = length_mask(length, codes.shape[1], qs.device)   # (B|1, N)
    return torch.where(live[:, None, None, :], s, NEG_INF)


def proxy_scores(qs, qz, codes, length):
    """B7's own contract: masked proxy scores over contiguous codes with one
    length for every row. qs (B, KV, G, Dp) float32, qz (B, KV, G, 1)
    float32, codes (B, N, KV, Dp) int8, length an int or a () tensor (on
    the host it is passed by value: no copy, no sync). Returns (B, KV, G, N)
    float32."""
    if qs.device.type == "cpu":
        return proxy_scores_plain(qs, qz, codes, length)
    B, N, KV, Dp = codes.shape
    G = qs.shape[2]
    if tuple(qs.shape) != (B, KV, G, Dp) or tuple(qz.shape) != (B, KV, G, 1):
        raise ValueError(f"proxy_scores: shapes qs {tuple(qs.shape)}, qz "
                         f"{tuple(qz.shape)}, codes {tuple(codes.shape)}")
    lens, stride, host_len = _lengths(length)
    if lens is not None and lens.numel() not in (1, B):
        raise ValueError(f"proxy_scores: length {tuple(length.shape)} for {B} rows")
    _check_cuda("proxy_scores", [qs, qz], codes, None, lens)
    out = torch.empty((B, KV, G, N), dtype=torch.float32, device=codes.device)
    qs = _aligned(qs)
    run(launcher(), "proxy_scores", codes.device, qs.data_ptr(), qz.data_ptr(),
        codes.data_ptr(), None, None if lens is None else lens.data_ptr(), stride,
        host_len, out.data_ptr(), B, KV, G, Dp, N, 1, N)
    proxy_scores.launches += 1
    return out


proxy_scores.launches = 0


def proxy_scores_q(q, proxy_scale, proxy_zero, codes, length):
    """``proxy_scores_tpu``: q (B, H, Dp) pre-scaled query (the attention
    scale included), proxy_scale/zero (B, KV, Dp), codes (B, N, KV, Dp) int8.
    Returns (B, H, N) float32. On the card one launch forms the factors and
    scores (counted under ``proxy_scores``, the contiguous form)."""
    if q.device.type == "cpu":
        qs, qz = query_factors(q, proxy_scale, proxy_zero)
        s = proxy_scores(qs, qz, codes, length)
    else:
        s = _launch_fused("proxy_scores", q, None, proxy_scale, proxy_zero, codes, None,
                          length, codes.shape[1])
        proxy_scores.launches += 1
    return s.reshape(q.shape[0], q.shape[1], codes.shape[1])


# ------------------------------------------------------------ paged (B7)


def paged_proxy_scores_plain(q, proxy_scale, proxy_zero, proxy_pages, block_table,
                             lengths, n: int):
    """Plain version of the served call: the logical code view gathered
    through the block table, then B7's plain version with per-row lengths."""
    B, H, _ = q.shape
    bt = block_table.long()
    codes = proxy_pages[bt].reshape(B, -1, *proxy_pages.shape[2:])[:, :n]
    qs, qz = query_factors(q, proxy_scale, proxy_zero)
    return proxy_scores_plain(qs, qz, codes, lengths).reshape(B, H, n)


def paged_proxy_scores(q, proxy_scale, proxy_zero, proxy_pages, block_table, lengths,
                       n: int, q_scale: float | None = None):
    """Proxy scores of every row's first ``n`` logical positions, read from
    the arena's code pages through the block table. q (B, H, Dp) pre-scaled
    query (rows at any stride; with ``q_scale``, ``q * q_scale`` in q's type
    is the pre-scaled query, as the served call's eager multiply gives it);
    proxy_scale/zero (B, KV, Dp) slot tables; proxy_pages (P, page, KV, Dp)
    int8; block_table (B, nb) int32, 0 = null page; lengths (B,) int32.
    Returns (B, H, n) float32, -1e30 at or past a row's length. On the card
    one launch forms the query factors and scores."""
    if q.device.type == "cpu":
        return paged_proxy_scores_plain(q if q_scale is None else q * q_scale, proxy_scale,
                                        proxy_zero, proxy_pages, block_table, lengths, n)
    if tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"paged_proxy_scores: lengths {tuple(lengths.shape)} for "
                         f"{q.shape[0]} rows")
    out = _launch_fused("paged_proxy_scores", q, q_scale, proxy_scale, proxy_zero,
                        proxy_pages, block_table, lengths, n)
    paged_proxy_scores.launches += 1
    return out.reshape(q.shape[0], q.shape[1], n)


paged_proxy_scores.launches = 0


# ------------------------------------------------------ contiguous decode


def retrieval_decode(q, cache, cfg, scale: float, calibrate: bool = False):
    """``retrieval_decode_tpu``: the kernel's proxy sweep, then top-k and the
    exact re-score over the picked keys, with no calibration unless asked
    (the static engine's T3 decode calibrates, as ``retrieval_attention``
    does). q (B, 1, H, Dh) roped; cache a ``RetrievalCache``. Returns
    (B, 1, H, Dh)."""
    dp = cfg.proxy_dim or q.shape[-1]
    sp = proxy_scores_q(q[:, 0, :, :dp] * scale, cache.proxy_scale, cache.proxy_zero,
                        cache.proxy, cache.length)[:, None]
    idx = ret_lib.select_topk(sp, cache.length, cfg)
    k_sel, v_sel = ret_lib.gather_kv(cache.k, cache.v, idx)
    return ret_lib.attend_selected(q, k_sel, v_sel, idx, sp, cache.length, scale,
                                   calibrate=calibrate)
