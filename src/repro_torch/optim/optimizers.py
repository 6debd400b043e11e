"""Optimizers of the port (the JAX package's ``optim/optimizers.py``), over
the port's parameter trees.

* ``adamw``     -- float32 moments.
* ``adafactor`` -- a factored second moment for leaves of two dimensions or
  more (over their last two) and a bf16 first moment.

The reference keeps each block-pattern position's layers stacked in one
(num_blocks, ...) leaf, and its optimizers see those stacked leaves: a
norm scale is (num_blocks, d) there, so Adafactor factors it (its column
moment is shared by the layers), and Adafactor's update clip takes the RMS
over the whole stacked leaf. So the optimizers here work in the
reference's layout: the gradients and parameters are stacked per leaf
(``params.stack_blocks``), every state leaf is a reference leaf, and the
updates return split into the port's per-layer tensors. The states are
``AdamWState`` and ``AdafactorState`` of trees in the reference's layout,
so a checkpoint writes them as they are. The global norm sums the
reference's leaves in its order.

``state_like`` and ``state_specs`` (abstract states and sharding specs)
wait for multi-device training (ROADMAP A21b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.params import ref_leaves, ref_unflatten, stack_blocks, tree_map, unstack_blocks


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # (grads, state, params, step) -> (updates in the port's layout, state)
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: torch.tensor(lr, dtype=torch.float32))


def _global_norm(leaves: list) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack([torch.sum(torch.square(x.float()))
                                             for x in leaves])))


def clip_by_global_norm(grads, max_norm: float):
    """Every leaf as float32, scaled so that the global norm is at most
    ``max_norm``. Returns (the scaled tree, the norm before)."""
    gn = _global_norm(ref_leaves(grads))
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gn


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def _stacked(tree) -> tuple[dict, list]:
    """The port's tree in the reference's layout, and its leaves."""
    ref = stack_blocks(tree)
    return ref, ref_leaves(ref)


def _step_t(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32) + 1.0


# ------------------------------------------------------------------- adamw


class AdamWState(NamedTuple):
    m: Any
    v: Any


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, max_grad_norm=1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        ref = stack_blocks(params)
        return AdamWState(tree_map(z, ref), tree_map(z, ref))

    def update(grads, state, params, step):
        ref, gl = _stacked(grads)
        gl = ref_leaves(clip_by_global_norm(gl, max_grad_norm)[0])
        t = _step_t(step)
        lr_t = lr_fn(step)
        us, ms, vs = [], [], []
        for g, m, v, p in zip(gl, ref_leaves(state.m), ref_leaves(state.v),
                              _stacked(params)[1]):
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            mhat = m2 / (1 - b1 ** t)
            vhat = v2 / (1 - b2 ** t)
            us.append(-lr_t * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()))
            ms.append(m2)
            vs.append(v2)
        return (unstack_blocks(ref_unflatten(ref, us)),
                AdamWState(ref_unflatten(state.m, ms), ref_unflatten(state.v, vs)))

    return Optimizer(init, update)


# ---------------------------------------------------------------- adafactor


class AdafactorState(NamedTuple):
    m: Any        # bf16 first moment
    v_row: Any    # float32 factored second moment (rows): leaves of 2+ dims
    v_col: Any    # float32 factored second moment (columns)
    v_full: Any   # float32 full second moment: leaves of 0 or 1 dims


def adafactor(lr, b1=0.9, decay=0.99, eps=1e-30, weight_decay=0.0, max_grad_norm=1.0,
              clip_threshold=1.0) -> Optimizer:
    """Adafactor with a bf16 momentum and a row/column-factored second
    moment for leaves (of the reference's layout) with two dimensions or
    more, factored over the last two."""
    lr_fn = _lr_fn(lr)

    def _shapes(p):
        if p.ndim >= 2:
            return p.shape[:-1], p.shape[:-2] + p.shape[-1:], None
        return None, None, p.shape

    def init(params):
        ref = stack_blocks(params)

        def moment(i, p):
            if i == 0:
                return torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
            shape = _shapes(p)[i - 1]  # an unused moment is one zero
            return torch.zeros(shape if shape else (1,), dtype=torch.float32, device=p.device)

        return AdafactorState(*(tree_map(lambda p, i=i: moment(i, p), ref) for i in range(4)))

    def update(grads, state, params, step):
        ref, gl = _stacked(grads)
        gl = ref_leaves(clip_by_global_norm(gl, max_grad_norm)[0])
        t = _step_t(step)
        beta2t = torch.clamp(1.0 - t ** -0.8, max=decay)
        lr_t = lr_fn(step)
        out = []
        for g, m, vr, vc, vf, p in zip(gl, *(ref_leaves(f) for f in state),
                                       _stacked(params)[1]):
            g2 = g * g + eps
            if p.ndim >= 2:
                vr = beta2t * vr + (1 - beta2t) * g2.mean(-1)
                vc = beta2t * vc + (1 - beta2t) * g2.mean(-2)
                r = vr / torch.clamp_min(vr.mean(-1, keepdim=True), eps)
                vhat = r[..., None] * vc[..., None, :]
            else:
                vf = beta2t * vf + (1 - beta2t) * g2
                vhat = vf
            u = g / torch.sqrt(vhat + eps)
            rms = torch.sqrt(torch.mean(u * u))  # over the whole stacked leaf
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            m2 = (b1 * m.float() + (1 - b1) * u).to(torch.bfloat16)
            out.append((-lr_t * (m2.float() + weight_decay * p.float()), m2, vr, vc, vf))
        cols = list(zip(*out))
        return (unstack_blocks(ref_unflatten(ref, cols[0])),
                AdafactorState(*(ref_unflatten(f, c) for f, c in zip(state, cols[1:]))))

    return Optimizer(init, update)
