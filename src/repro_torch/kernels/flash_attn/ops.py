"""Contiguous flash-attention kernel of the port: wrapper, plain version,
counters.

  ``flash_attention``   B8: replaces ``flash_attention_fwd``
                        (src/repro/kernels/flash_attn/kernel.py:276)

It serves every contiguous prefill (the static ``ServeEngine`` and one-shot
admission, every mode: causal over the prompt) and the static engine's
dense decode (one query token, non-causal, over the written prefix of the
arena). Given CPU tensors it runs its plain version,
``flash_attention_plain``: ``core/flash_ref.attention_auto``, the dense
oracle up to 1024 tokens and the flash forward beyond, which is what the
JAX package's layers call there. Given CUDA tensors it launches one of three
hand-written CUDA kernels on the current stream, or raises; it never falls
back. The route is picked by shape and dtype, explicitly:

  ``prompt``      T > 1, bfloat16: the tensor-core forward
                  ``csrc/flash_prompt.cu`` (mma.sync, no split)
  ``prompt_f32``  T > 1, float32: the CUDA-core sweep
                  ``csrc/flash_attention.cu`` (float32 FMAs; TF32 tensor
                  cores would miss the float32 gate)
  ``decode``      T == 1, either dtype: the single-query decode
                  ``csrc/flash_decode.cu``

Every launch adds one to ``flash_attention.launches`` and to its route's
entry in ``ROUTE_LAUNCHES``.

Semantics (the TPU kernel's): GQA with query head h reading kv head
h // (H // KV), scores in float32 times ``scale``, causal meaning query
token i sees keys j <= i, output in q's dtype. The prompt route rounds the
softmax weights to bf16 for the value product, as the plain version rounds
them to v's dtype; the other routes keep them float32, which differs by
bf16 rounding only.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.flash_ref import attention_auto
from repro_torch.kernels import build, single_query
from repro_torch.kernels.paged_attn.ops import run

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"flash_attention": CSRC / "flash_attention.cu",
           "flash_prompt": CSRC / "flash_prompt.cu",
           "flash_decode": CSRC / "flash_decode.cu"}
ROUTE_LAUNCHES = {"prompt": 0, "prompt_f32": 0, "decode": 0}
# the float32 prompt's sweep cuts each row's key range into splits of this
# many keys, one block per (split, kv head, 16 query rows), merged by a
# second pass
SPLIT_TOKENS = 256
MAX_HEAD_DIM = single_query.MAX_HEAD_DIM  # prompt and decode: Dh, Dv multiples of 16

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_ARGTYPES = {
    # q, k, v, out, part, B, T, S, H, KV, Dh, Dv, q_sb, q_stok, s_stride,
    # split_tokens, causal, scale, stream
    "flash_attention": [_P] * 5 + [_I] * 7 + [_L, _L] + [_I] * 3 + [_F, _P],
    # q, k, v, out, B, T, S, H, KV, Dh, Dv, q_sb, q_stok, s_stride, causal, scale, stream
    "flash_prompt": [_P] * 4 + [_I] * 7 + [_L, _L] + [_I] * 2 + [_F, _P],
    # is_bf16, q, k, v, out, part, counters, B, H, KV, Dh, Dv, q_sb, s_stride, len,
    # splits, split_keys, scale, stream
    "flash_decode": [_I] + [_P] * 6 + [_I] * 5 + [_L] + [_I] * 4 + [_F, _P],
}


def launcher(name: str = "flash_attention"):
    """The C entry point ``<name>_launch`` of one of B8's sources, building
    its library first."""
    return build.c_function(SOURCES[name], f"{name}_launch", _ARGTYPES[name])


def flash_attention_plain(q, k, v, scale: float, causal: bool = True):
    """Plain version of B8: ``attention_auto`` (the JAX layers' call)."""
    return attention_auto(q, k, v, scale, causal=causal)


def _check_cuda(q, k, v) -> None:
    dev, dt = q.device, q.dtype
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {dev}; the kernel takes CUDA "
                         "tensors and the plain version CPU tensors")
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: dtype {dt}; the kernel takes bfloat16 or float32")
    for t in (k, v):
        if t.device != dev:
            raise ValueError(f"flash_attention: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"flash_attention: mixed dtypes {t.dtype} and {dt}")


def _token_stride(t: torch.Tensor, name: str) -> int:
    """Elements between two rows of t (B, S, KV, D), in tokens: the rows
    may be the prefix of a longer arena, but each row's (S, KV, D) block
    must be dense."""
    _, _, KV, D = t.shape
    if t.stride(3) != 1 or t.stride(2) != D or t.stride(1) != KV * D or t.stride(0) % (KV * D):
        raise ValueError(f"{name}: the kernel takes (B, S, KV, D) rows that are dense "
                         f"within each row; strides {t.stride()}")
    return t.stride(0) // (KV * D)


def flash_attention(q, k, v, scale: float, causal: bool = True):
    """Contiguous GQA attention. q (B, T, H, Dh); k (B, S, KV, Dh) and v
    (B, S, KV, Dv), each row dense (rows may be the written prefix of a
    longer arena); ``causal``: query token i sees keys j <= i. Returns
    (B, T, H, Dv) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal)
    B, T, H, Dh = q.shape
    _, S, KV, Dk = k.shape
    Dv = v.shape[-1]
    if (Dk != Dh or H % KV or tuple(k.shape[:3]) != (B, S, KV)
            or tuple(v.shape[:3]) != (B, S, KV) or (causal and T > S)):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, causal={causal}")
    _check_cuda(q, k, v)
    stride = _token_stride(k, "flash_attention")
    if _token_stride(v, "flash_attention") != stride or q.stride()[2:] != (Dh, 1):
        raise ValueError("flash_attention: k and v rows must share one stride and q's "
                         "heads be dense")
    bf16 = q.dtype == torch.bfloat16
    route = "decode" if T == 1 else "prompt" if bf16 else "prompt_f32"
    if route != "prompt_f32" and (Dh % 16 or Dv % 16 or max(Dh, Dv) > MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: Dh={Dh}, Dv={Dv}; the {route} kernel takes "
                         f"multiples of 16 up to {MAX_HEAD_DIM}")
    out = torch.empty((B, T, H, Dv), dtype=q.dtype, device=q.device)
    if route == "prompt":
        run(launcher("flash_prompt"), "flash_attention", q.device, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, H, KV, Dh, Dv,
            q.stride(0), q.stride(1), stride, int(causal), float(scale))
    elif route == "decode":
        length = 1 if causal else S      # causal: the one query token sees key 0
        G = H // KV
        splits, keys = single_query.plan(B * KV * -(-G // 8), length, q.device)
        part = torch.empty(B * H * splits * (Dv + 2), dtype=torch.float32, device=q.device)
        run(launcher("flash_decode"), "flash_attention", q.device, int(bf16), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(),
            single_query.counters(B * H, q.device).data_ptr(), B, H, KV, Dh, Dv,
            q.stride(0), stride, length, splits, keys, float(scale))
    else:
        splits = -(-stride // SPLIT_TOKENS)
        part = torch.empty(B * H * T * splits * (Dv + 2), dtype=torch.float32,
                           device=q.device)
        run(launcher("flash_attention"), "flash_attention", q.device, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(), B, T, S, H, KV, Dh,
            Dv, q.stride(0), q.stride(1), stride, SPLIT_TOKENS, int(causal), float(scale))
    flash_attention.launches += 1
    ROUTE_LAUNCHES[route] += 1
    return out


flash_attention.launches = 0
