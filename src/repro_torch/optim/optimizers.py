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

``state_like`` gives the state on the ``meta`` device (shapes only) and
``state_specs`` its PartitionSpecs from the parameters' (the reference's
layout): every state leaf inherits its parameter's spec, so FSDP shards
the optimizer state with the parameters (ZeRO-3). ``update_sharded`` is
``update`` over ``ShardedArray`` trees (``train/sharded.py``): each block
is updated on its own device, and what reduces over a sharded dimension
(the global norm; Adafactor's row and column means and its update clip's
RMS over the whole stacked leaf) is a sum of per-block partials combined
in block order. Those reductions, in ``update`` too, accumulate in float64
and round once to float32, so their float32 values do not depend on how a
leaf is split into blocks (but at a tie of the rounding): on the same
gradients ``update_sharded`` gives ``update``'s result bit for bit, where
the ill-conditioned first steps (AdamW's g / (|g| + eps), Adafactor's
sign-like first moment) would otherwise turn a last-bit difference of the
clip scale into a visible one. It returns the new parameters (not the
updates) and the state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.distributed.sharding import PartitionSpec as P, ShardedArray
from repro_torch.params import ref_leaves, ref_unflatten, stack_blocks, tree_map, unstack_blocks


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # (grads, state, params, step) -> (updates in the port's layout, state)
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    # params (either layout, any device) -> the state on the meta device
    state_like: Optional[Callable[[Any], Any]] = None
    # (param specs, abstract params), both in the reference's layout -> state specs
    state_specs: Optional[Callable[[Any, Any], Any]] = None
    # (grads, state, params, step) over ShardedArray trees in the reference's
    # layout -> (params, state)
    update_sharded: Optional[Callable[[Any, Any, Any, Any], tuple[Any, Any]]] = None


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: torch.tensor(lr, dtype=torch.float32))


def _sum64(x: torch.Tensor, *dim, keepdim: bool = False) -> torch.Tensor:
    """A sum of float32 values accumulated in float64 (over ``dim``, or all)."""
    return torch.sum(x, dim=dim or None, keepdim=keepdim, dtype=torch.float64)


def _mean32(total: torch.Tensor, n: int) -> torch.Tensor:
    """A float64 sum over ``n`` values, the mean rounded once to float32."""
    return (total / n).float()


def _global_norm(leaves: list) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack([_sum64(torch.square(x.float()))
                                             for x in leaves]))).float()


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


def _as_ref(tree):
    """A parameter tree in the reference's layout (stacked as it is when its
    blocks are already (num_blocks, ...) leaves)."""
    blocks = tree["blocks"]
    return stack_blocks(tree) if blocks and isinstance(blocks[0], list) else tree


def _meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def _lead(leaves: list) -> torch.device:
    """Where cross-block sums are combined: the home of the first block."""
    return next(iter(leaves[0].homes().values())).device


def _sum_partials(parts: list, device) -> torch.Tensor:
    """Per-block float64 partial sums added in order on ``device``."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _sharded_clip(grads: list, max_norm: float):
    """The global norm of ShardedArray leaves (each logical element once:
    a block's partial sum of squares, blocks in grid order, leaves in the
    reference's order) and the clip scale, on the lead device."""
    dev = _lead(grads)
    parts = [_sum64(torch.square(t.float())) for g in grads for t in g.homes().values()]
    gn = torch.sqrt(_sum_partials(parts, dev)).float()
    return torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0), gn


# ------------------------------------------------------------------- adamw


class AdamWState(NamedTuple):
    m: Any
    v: Any


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, max_grad_norm=1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        ref = _as_ref(params)
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

    def state_like(params):
        return init(_meta(params))

    def state_specs(param_specs, abstract_params):
        return AdamWState(param_specs, param_specs)

    def update_sharded(grads, state, params, step):
        gl, pl = ref_leaves(grads), ref_leaves(params)
        scale = float(_sharded_clip(gl, max_grad_norm)[0])
        t = _step_t(step)
        c1, c2 = float(1 - b1 ** t), float(1 - b2 ** t)
        lr_f = float(torch.as_tensor(lr_fn(step), dtype=torch.float32))
        # every block of every leaf, grouped by its home device: one
        # _foreach launch a device an operation
        groups: dict = {}
        for li, (g, m, v, p) in enumerate(zip(gl, ref_leaves(state.m), ref_leaves(state.v), pl)):
            for idx in g.blocks:
                dev = g.home(idx).device
                groups.setdefault(dev, []).append((li, idx, g.home(idx), m.home(idx),
                                                   v.home(idx), p.home(idx)))
        new = {}
        for dev, rows in groups.items():
            _, _, g, m, v, p = (list(c) for c in zip(*rows))
            g = torch._foreach_mul(g, scale)
            m2 = torch._foreach_add(torch._foreach_mul(m, b1), torch._foreach_mul(g, 1 - b1))
            gg = torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g)
            v2 = torch._foreach_add(torch._foreach_mul(v, b2), gg)
            den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v2, c2)), eps)
            u = torch._foreach_div(torch._foreach_div(m2, c1), den)
            pf = [x.float() for x in p]
            torch._foreach_add_(u, torch._foreach_mul(pf, weight_decay))
            u = torch._foreach_mul(u, -lr_f)
            p2 = [(a + b).to(x.dtype) for a, b, x in zip(pf, u, p)]
            for (li, idx, *_), pn, mn, vn in zip(rows, p2, m2, v2):
                new[li, idx] = (pn, mn, vn)

        def rebuild(i, leaves):
            return [ShardedArray.from_homes(a.shape, a.dtype, a.spec, a.mesh,
                                            {idx: new[li, idx][i] for idx in a.blocks})
                    for li, a in enumerate(leaves)]

        return (ref_unflatten(params, rebuild(0, pl)),
                AdamWState(ref_unflatten(state.m, rebuild(1, ref_leaves(state.m))),
                           ref_unflatten(state.v, rebuild(2, ref_leaves(state.v)))))

    return Optimizer(init, update, state_like, state_specs, update_sharded)


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
        ref = _as_ref(params)

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
                vr = beta2t * vr + (1 - beta2t) * _mean32(_sum64(g2, -1), g2.shape[-1])
                vc = beta2t * vc + (1 - beta2t) * _mean32(_sum64(g2, -2), g2.shape[-2])
                r = vr / torch.clamp_min(_mean32(_sum64(vr, -1, keepdim=True), vr.shape[-1]),
                                         eps)
                vhat = r[..., None] * vc[..., None, :]
            else:
                vf = beta2t * vf + (1 - beta2t) * g2
                vhat = vf
            u = g / torch.sqrt(vhat + eps)
            # over the whole stacked leaf
            rms = torch.sqrt(_sum64(u * u) / u.numel()).float()
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            m2 = (b1 * m.float() + (1 - b1) * u).to(torch.bfloat16)
            out.append((-lr_t * (m2.float() + weight_decay * p.float()), m2, vr, vc, vf))
        cols = list(zip(*out))
        return (unstack_blocks(ref_unflatten(ref, cols[0])),
                AdafactorState(*(ref_unflatten(f, c) for f, c in zip(state, cols[1:]))))

    def state_like(params):
        return init(_meta(params))

    def state_specs(param_specs, abstract_params):
        def per(spec, p):
            s = tuple(spec) + (None,) * (p.ndim - len(spec))
            if p.ndim >= 2:
                return (P(*s), P(*s[:-1]), P(*s[:-2], s[-1]), P(None))
            return (P(*s), P(None), P(None), P(*s))

        out = [per(s, p) for s, p in zip(ref_leaves(param_specs), ref_leaves(abstract_params))]
        return AdafactorState(*(ref_unflatten(param_specs, [o[i] for o in out])
                                for i in range(4)))

    def update_sharded(grads, state, params, step):
        gl = ref_leaves(grads)
        scale = float(_sharded_clip(gl, max_grad_norm)[0])
        t = _step_t(step)
        beta2t = torch.clamp(1.0 - t ** -0.8, max=decay)
        lr_t = lr_fn(step)
        dev0 = _lead(gl)
        new = [[] for _ in range(5)]
        for g, m, vr, vc, vf, p in zip(gl, *(ref_leaves(f) for f in state), ref_leaves(params)):
            g = {idx: x * scale for idx, x in g.homes().items()}
            g2 = {idx: x * x + eps for idx, x in g.items()}
            if len(p.shape) >= 2:
                n_r, n_c = p.shape[-1], p.shape[-2]
                # row and column sums of g2, each a sum of the blocks' partial
                # sums along the split dimension, in block order
                rows, cols = {}, {}
                for idx, x in g2.items():
                    rows.setdefault(idx[:-1], []).append(_sum64(x, -1))
                    cols.setdefault(idx[:-2] + idx[-1:], []).append(_sum64(x, -2))
                vr = ShardedArray.from_homes(vr.shape, vr.dtype, vr.spec, vr.mesh, {
                    ri: beta2t * v + (1 - beta2t) * _mean32(_sum_partials(rows[ri], v.device),
                                                            n_r)
                    for ri, v in vr.homes().items()})
                vc = ShardedArray.from_homes(vc.shape, vc.dtype, vc.spec, vc.mesh, {
                    ci: beta2t * v + (1 - beta2t) * _mean32(_sum_partials(cols[ci], v.device),
                                                            n_c)
                    for ci, v in vc.homes().items()})
                # vr's mean over its last dimension (the parameter's rows)
                dens = {}
                for ri, v in vr.homes().items():
                    dens.setdefault(ri[:-1], []).append(_sum64(v, -1, keepdim=True))
                r = {ri: v / torch.clamp_min(_mean32(_sum_partials(dens[ri[:-1]], v.device),
                                                     n_c), eps)
                     for ri, v in vr.homes().items()}
                vhat = {idx: r[idx[:-1]].to(x.device)[..., None]
                        * vc.home(idx[:-2] + idx[-1:]).to(x.device)[..., None, :]
                        for idx, x in g.items()}
            else:
                vf = ShardedArray.from_homes(vf.shape, vf.dtype, vf.spec, vf.mesh, {
                    idx: beta2t * v + (1 - beta2t) * g2[idx] for idx, v in vf.homes().items()})
                vhat = vf.homes()
            u = {idx: x / torch.sqrt(vhat[idx] + eps) for idx, x in g.items()}
            # the update clip: the RMS over the whole stacked leaf
            ss = _sum_partials([_sum64(x * x) for x in u.values()], dev0)
            rms = torch.sqrt(ss / math.prod(p.shape)).float()
            div = torch.clamp_min(rms / clip_threshold, 1.0)
            m2, pn = {}, {}
            for idx, x in u.items():
                x = x / div.to(x.device)
                mm = (b1 * m.home(idx).float() + (1 - b1) * x).to(torch.bfloat16)
                pp = p.home(idx)
                du = -lr_t * (mm.float() + weight_decay * pp.float())
                m2[idx], pn[idx] = mm, (pp.float() + du).to(pp.dtype)
            for i, (a, homes) in enumerate(((p, pn), (m, m2))):
                new[i].append(ShardedArray.from_homes(a.shape, a.dtype, a.spec, a.mesh, homes))
            new[2].append(vr)
            new[3].append(vc)
            new[4].append(vf)
        return (ref_unflatten(params, new[0]),
                AdafactorState(*(ref_unflatten(f, c) for f, c in zip(state, new[1:]))))

    return Optimizer(init, update, state_like, state_specs, update_sharded)
