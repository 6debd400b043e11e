"""Counter-based random numbers of the port: what the JAX package's samplers
take from ``jax.random`` (``PRNGKey``, ``fold_in``, ``split``, ``uniform``,
``gumbel``, ``categorical``), rebuilt bit for bit in torch ops so that a
seeded request draws the same tokens as in the reference engine.

The generator is Threefry-2x32 (20 rounds) with the partitionable counter
layout (``jax_threefry_partitionable=True``, the default from JAX 0.5 on): a
draw of shape ``S`` hashes the 64-bit flat index ``n`` of every element as the
counter pair ``(n >> 32, n & 0xffffffff)`` and keeps ``bits1 ^ bits2``. A key is
a pair of 32-bit words, held here as the last axis (size 2) of an int64
tensor whose values stay in ``[0, 2**32)``: every sum is masked back to 32
bits, so the int64 lanes behave as uint32 on the CPU and on CUDA alike.

Every function runs on the device of its input tensors; nothing crosses to
the host. Keys broadcast: a batch of keys ``(..., 2)`` with a draw shape
``S`` gives ``(..., *S)``, each key hashing its own counters ``0 .. prod(S)-1``
(the ``vmap`` of the per-key JAX function).
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
FLOAT32_TINY = 1.1754943508222875e-38   # float32 finfo.tiny


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter pairs ``(x1, x2)`` under the
    key ``(k1, k2)``; int64 tensors holding 32-bit words, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & MASK32
    b = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def PRNGKey(seed, device=None) -> torch.Tensor:
    """Key(s) of a 32-bit integer seed: ``(0, seed & 0xffffffff)``, as
    ``jax.random.PRNGKey`` builds them without 64-bit mode (the high word
    is the seed shifted right by 32, which is 0). ``seed`` is a Python int
    or an integer tensor; returns (..., 2) int64."""
    s = torch.as_tensor(seed, device=device).to(torch.int64) & MASK32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``
    under ``key``. key (..., 2); data an int or an integer tensor
    broadcasting with the key's batch shape."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK32
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def _counters(shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    n = torch.arange(math.prod(shape), device=device, dtype=torch.int64).reshape(shape)
    return n >> 32, n & MASK32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` under the partitionable layout: key (2,) ->
    (num, 2), key ``i`` being the hash of the counter pair ``(0, i)``."""
    hi, lo = _counters((num,), key.device)
    a, b = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element: key (..., 2) -> (..., *shape) int64."""
    shape = tuple(shape)
    hi, lo = _counters(shape, key.device)
    lead = key.shape[:-1]
    view = lead + (1,) * len(shape)
    a, b = threefry2x32(key[..., 0].reshape(view), key[..., 1].reshape(view), hi, lo)
    return a ^ b


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval), ``jax.random.uniform``'s
    construction: the top 23 bits become the mantissa of a float in [1, 2),
    shifted down by 1, scaled and clamped below at ``minval``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 standard Gumbel noise, ``jax.random.gumbel``'s default (low
    dynamic range) mode: ``-log(-log(u))``, u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, FLOAT32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (the Gumbel-max
    trick): key (..., 2) draws the noise for its own row of ``logits``
    (..., V), or a single key (2,) draws it for the whole (..., V) block at
    once. Returns the int64 argmax of ``logits + gumbel``."""
    if key.dim() == 1:
        g = gumbel(key, logits.shape)
    else:
        g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits.float(), dim=-1)
