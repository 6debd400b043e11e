"""Int8 gradient compression for slow links (the JAX package's
``optim/compression.py``): symmetric per-tensor codes, their decode, and
``compressed_psum``, an all-reduce of the codes with error feedback
(EF-SGD): the residual quantization error is carried in a float32 buffer a
shard, so compression adds no bias over steps.

Where the reference's ``compressed_psum`` runs under ``shard_map`` with
``pmax``/``psum``, the port's takes a list of per-shard tensors, one a
device of the mesh axis, as ``distributed/collectives.py`` does: the
shards' amax and int32 code sums are combined by peer copies in shard
order (exact: int8 codes summed in int32), and the result is copied back
to every shard's device."""
from __future__ import annotations

import torch


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (codes, scale)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max() / 127.0, 1e-12)
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def decompress_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.float() * scale


def compressed_psum(xs: list, errs: list) -> tuple[list, list]:
    """Error-feedback compressed mean over the shards of an axis.

    xs: each shard's float32 gradient, on its device; errs: each shard's
    error-feedback buffer (same shape). Returns (each shard's mean estimate,
    each shard's new buffer), on the shards' devices. One shared scale (the
    max of the shards' amax) so every shard decodes the same sum."""
    if len(xs) != len(errs):
        raise ValueError(f"{len(xs)} shards given {len(errs)} error buffers")
    xf = [x.float() + e for x, e in zip(xs, errs)]
    lead = xf[0].device
    gmax = xf[0].abs().max()
    for x in xf[1:]:  # pmax, in shard order
        gmax = torch.maximum(gmax, x.abs().max().to(lead))
    scale = torch.clamp_min(gmax / 127.0, 1e-12)
    codes, new_err = [], []
    for x in xf:
        s = scale.to(x.device)
        c = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
        codes.append(c)
        new_err.append(x - c.float() * s)
    total = codes[0].to(torch.int32)
    for c in codes[1:]:  # psum of the int32 codes, in shard order
        total = total + c.to(lead).to(torch.int32)
    mean = total.float() * scale / float(len(xs))
    return [mean.to(x.device) for x in xf], new_err
