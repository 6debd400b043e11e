"""GPipe-style pipeline over a mesh axis (the JAX package's
``distributed/pipeline.py``): the forward of a stack of blocks split into
S stages, stage s holding its slice of the stacked block weights on its
device.

Schedule: M microbatches, S stages, T = M + S - 1 ticks; at tick t stage
s works on microbatch t - s and hands its output to stage s + 1 (a peer
copy where the reference's ``ppermute`` hops). The bubble fraction is
(S - 1) / T (``bubble_fraction``). One controller issues the stages of a
tick one after another; on separate devices their kernels overlap.
"""
from __future__ import annotations

import torch


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _slice_tree(tree, lo: int, hi: int, device):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, lo, hi, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice_tree(v, lo, hi, device) for v in tree)
    return tree[lo:hi].to(device)


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index_tree(v, i) for v in tree)
    return tree[i]


def _num_blocks(tree) -> int:
    if isinstance(tree, dict):
        return _num_blocks(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _num_blocks(tree[0])
    return tree.shape[0]


def gpipe_forward(mesh, axis: str, block_fn):
    """Build a pipelined forward over ``axis``. ``block_fn(params_block, x)
    -> x`` applies ONE block; each stage applies it over its own slice of
    the stacked block parameters, in order.

    Returns fn(stacked_params, x_mb): ``stacked_params`` a tensor or a
    dict/list tree of tensors whose leading dim is num_blocks (split evenly
    over the stages), ``x_mb`` (M, mb, ...) microbatches. Output: (M, mb,
    ...) after ALL blocks, on x_mb's device."""
    devices = mesh.axis_devices(axis)
    S = len(devices)

    def fn(stacked_params, x_mb):
        nb = _num_blocks(stacked_params)
        if nb % S:
            raise ValueError(f"{nb} blocks do not split over {S} stages")
        per = nb // S
        stages = [_slice_tree(stacked_params, s * per, (s + 1) * per, d)
                  for s, d in enumerate(devices)]

        def stage_apply(s, h):
            for i in range(per):
                h = block_fn(_index_tree(stages[s], i), h)
            return h

        M = x_mb.shape[0]
        outs = [None] * M
        carry = [None] * S  # carry[s]: what stage s takes at this tick
        for t in range(M + S - 1):
            nxt = [None] * S
            for s in range(S):
                mb = t - s
                if not 0 <= mb < M:
                    continue
                h = stage_apply(s, x_mb[mb].to(devices[s]) if s == 0 else carry[s])
                if s == S - 1:
                    outs[mb] = h.to(x_mb.device)
                else:
                    nxt[s + 1] = h.to(devices[s + 1])
            carry = nxt
        return torch.stack(outs)

    return fn
