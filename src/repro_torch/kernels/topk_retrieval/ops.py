"""T3 proxy-scoring kernel of the port: wrappers, plain versions, counters.

  ``proxy_scores``        B7: replaces ``proxy_scores_fwd``
                          (src/repro/kernels/topk_retrieval/kernel.py:39), its
                          contiguous contract: codes (B, N, KV, Dp), one length
  ``paged_proxy_scores``  B7 over the arena's proxy code pages through the
                          block table, with per-row lengths: the served call

and the JAX package's ops around it (``topk_retrieval/ops.py``):
``proxy_scores_q`` (``proxy_scores_tpu``: builds the query factors) and
``retrieval_decode`` (``retrieval_decode_tpu``: kernel sweep, then top-k and
the exact re-score, without calibration as there, or with it: the static
engine's T3 decode).

Both kernel wrappers launch one CUDA kernel, ``csrc/proxy_scores.cu``. Given
CPU tensors a wrapper runs its plain PyTorch version (``*_plain``, which the
tests hold against the JAX kernel); given CUDA tensors it launches the
kernel on the current stream, or raises. It never falls back. Every launch
adds one to the wrapper's ``launches`` counter.

Semantics (the TPU kernel's): a stored code ``c8`` means ``c8 + 128``; the
score of key n is ``qs . (c8 + 128) + qz`` in float32 for n below the row's
length and -1e30 from there on.
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

_P, _I = ctypes.c_void_p, ctypes.c_int
# qs, qz, codes, block_table, lengths, out, B, KV, G, Dp, page, nb, N, stream
_ARGTYPES = [_P] * 6 + [_I] * 7 + [_P]
MAX_DP = 256                 # proxy channels: a multiple of 16 up to this


def launcher(name: str = "proxy_scores"):
    """The C entry point ``proxy_scores_launch``, building its library first."""
    return build.c_function(SOURCES[name], "proxy_scores_launch", _ARGTYPES)


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


def _check_cuda(name: str, qs, qz, codes, block_table, lengths):
    dev = qs.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel takes CUDA "
                         "tensors and the plain version CPU tensors")
    for t, kind in ((qs, torch.float32), (qz, torch.float32), (codes, torch.int8),
                    (block_table, torch.int32), (lengths, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
        if t.dtype != kind:
            raise TypeError(f"{name}: a {t.dtype} tensor where the kernel takes {kind}")
    B, KV, G, Dp = qs.shape
    if Dp % 16 or not 16 <= Dp <= MAX_DP:
        raise ValueError(f"{name}: Dp={Dp}; the kernel takes Dp a multiple of 16 up "
                         f"to {MAX_DP}")
    if codes.data_ptr() % 16:
        raise ValueError(f"{name}: code pages not 16-byte aligned")


def _launch(name: str, qs, qz, pages, block_table, lengths, n: int) -> torch.Tensor:
    """One launch of the kernel over code pages (P, page, KV, Dp)."""
    B, KV, G, Dp = qs.shape
    P, page, pkv, pdp = pages.shape
    nb = block_table.shape[-1]
    if ((pkv, pdp) != (KV, Dp) or tuple(qz.shape) != (B, KV, G, 1)
            or tuple(block_table.shape) != (B, nb) or tuple(lengths.shape) != (B,)
            or not 0 <= n <= nb * page):
        raise ValueError(
            f"{name}: shapes qs {tuple(qs.shape)}, qz {tuple(qz.shape)}, codes "
            f"{tuple(pages.shape)}, block_table {tuple(block_table.shape)}, lengths "
            f"{tuple(lengths.shape)}, n={n}")
    _check_cuda(name, qs, qz, pages, block_table, lengths)
    out = torch.empty((B, KV, G, n), dtype=torch.float32, device=qs.device)
    run(launcher(name), name, qs.device, qs.data_ptr(), qz.data_ptr(), pages.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, KV, G, Dp, page,
        nb, int(n))
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
    float32, codes (B, N, KV, Dp) int8, length an int or a () tensor.
    Returns (B, KV, G, N) float32."""
    if qs.device.type == "cpu":
        return proxy_scores_plain(qs, qz, codes, length)
    B, N = codes.shape[:2]
    dev = qs.device
    lengths = torch.as_tensor(length, device=dev).to(torch.int32).reshape(1).expand(B)
    table = torch.arange(B, dtype=torch.int32, device=dev)[:, None]  # one page of N per row
    out = _launch("proxy_scores", qs, qz, codes, table, lengths.contiguous(), N)
    proxy_scores.launches += 1
    return out


proxy_scores.launches = 0


def proxy_scores_q(q, proxy_scale, proxy_zero, codes, length):
    """``proxy_scores_tpu``: q (B, H, Dp) pre-scaled query (the attention
    scale included), proxy_scale/zero (B, KV, Dp), codes (B, N, KV, Dp) int8.
    Returns (B, H, N) float32."""
    qs, qz = query_factors(q, proxy_scale, proxy_zero)
    s = proxy_scores(qs, qz, codes, length)
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
                       n: int):
    """Proxy scores of every row's first ``n`` logical positions, read from
    the arena's code pages through the block table. q (B, H, Dp) pre-scaled
    query; proxy_scale/zero (B, KV, Dp) slot tables; proxy_pages
    (P, page, KV, Dp) int8; block_table (B, nb) int32, 0 = null page;
    lengths (B,) int32. Returns (B, H, n) float32, -1e30 at or past a row's
    length."""
    if q.device.type == "cpu":
        return paged_proxy_scores_plain(q, proxy_scale, proxy_zero, proxy_pages,
                                        block_table, lengths, n)
    qs, qz = query_factors(q, proxy_scale, proxy_zero)
    out = _launch("paged_proxy_scores", qs, qz, proxy_pages, block_table, lengths, n)
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
