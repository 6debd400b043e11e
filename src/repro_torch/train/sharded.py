"""The training step over a device mesh (the port's counterpart of the
pjit step of the JAX package's ``launch/train.py:79-99``), with one
controller and a grid of devices (``distributed.sharding.Mesh``; a device
may repeat, and its positions then share it, as XLA's emulated host
devices share the CPU).

Storage. Every parameter, its gradient and every optimizer-state leaf is a
``ShardedArray`` in the reference's (stacked) layout, split by its fitted
spec (``models.model.param_specs`` and the optimizer's ``state_specs``
under ``distributed.rules.param_rules``: the d_model axis FSDP-sharded over
``data`` (and ``pod``), the parallel axis over ``model``). ``shard_tree``
and ``gather_tree`` move between a whole tree and its blocks.

The step is ZeRO-3 / FSDP. Each data replica (over ``pod`` x ``data``, as
far as a microbatch's rows split: ``distributed.rules.batch_axes``) gathers
the parameters onto its device (replicas that share a device share the
gathered copy) and runs the port's ``grads_of`` (``train/step.py``) on its
rows of each microbatch. Each block of the gradient is summed on its home
device (the first device holding it): the replicas' float32 slices of it,
in replica order, each weighted by its share of the microbatch's labelled
tokens, so the sum is the gradient of the whole microbatch's mean loss.
The optimizer then updates each block on its own device
(``Optimizer.update_sharded``). The result equals the unsharded step's
(``make_train_step``) but for the order of reductions, and over the same
split of the rows (R x k microbatches) bit for bit but for the optimizer's
cross-block sums.

Memory at the step's peak, besides a device's own blocks of the parameters
and the state: a replica's device holds the whole model gathered and the
whole gradient of its rows, both in the parameters' dtypes (the gather is
of the whole model at once), and every device the float32 sums of the
gradient blocks it is home to. ``launch/dryrun.py`` records both.

Two limits of this slice, both in ROADMAP A21c:
  * the ``model`` axis shards storage only: a replica computes the whole
    model on its device (the tensor-parallel compute XLA's partitioner
    derives from the reference's ``constrain`` calls is not ported);
  * a stack with MoE layers does not split its batch: its routing (token
    groups, expert capacity) and aux loss are functions of the whole
    microbatch, which the reference's partitioner keeps global, so one
    replica computes it whole (as for a batch of 1 on 16 data shards).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.distributed.rules import act_rules, batch_axes, param_rules
from repro_torch.distributed.sharding import (Mesh, ShardedArray, block_layout,
                                              fit_spec_to_shape, gather_array, shard_array,
                                              sharding_context, spec_parts)
from repro_torch.models import model as M
from repro_torch.optim.optimizers import Optimizer
from repro_torch.params import ref_leaves, ref_unflatten, stack_blocks, tree_map, unstack_blocks
from repro_torch.train.step import TrainStepCfg, make_grads_of


def multi_pod(mesh: Mesh) -> bool:
    return "pod" in mesh.axis_names


def fit_tree(specs, abstract, mesh: Mesh):
    """Each spec fitted to its leaf's shape (axes that do not divide it
    dropped), so that no block is ever of size 0."""
    return ref_unflatten(specs, [fit_spec_to_shape(s, tuple(a.shape), mesh)
                                 for s, a in zip(ref_leaves(specs), ref_leaves(abstract))])


def train_specs(cfg: ModelConfig, opt: Optimizer, mesh: Mesh):
    """(fitted parameter specs, fitted optimizer-state specs), both in the
    reference's layout, under ``param_rules``."""
    abstract = M.abstract_params(cfg, stacked=True)
    pspecs = fit_tree(M.param_specs(cfg, param_rules(multi_pod(mesh)), mesh.shape,
                                    stacked=True), abstract, mesh)
    ospecs = fit_tree(opt.state_specs(pspecs, abstract), opt.state_like(abstract), mesh)
    return pspecs, ospecs


def shard_tree(tree, specs, mesh: Mesh):
    """A tree in the reference's layout as ShardedArrays by ``specs``."""
    return ref_unflatten(specs, [shard_array(x, s, mesh)
                                 for x, s in zip(ref_leaves(tree), ref_leaves(specs))])


def gather_tree(tree, device):
    """A tree of ShardedArrays whole on ``device`` (the reference's layout)."""
    return tree_map(lambda a: gather_array(a, device), tree)


def gather_params(tree, device):
    """Sharded parameters whole on ``device``, in the port's layout."""
    return unstack_blocks(gather_tree(tree, device))


def position_bytes(tree, pos: tuple) -> int:
    """The bytes of a sharded tree's blocks at grid position ``pos``."""
    return sum(a.at(pos).numel() * a.at(pos).element_size() for a in ref_leaves(tree))


def has_moe(cfg: ModelConfig) -> bool:
    return any(mlp == "moe" for _, mlp in cfg.layer_kinds)


def replica_axes(cfg: ModelConfig, rows: int, mesh: Mesh) -> tuple:
    """The mesh axes a microbatch of ``rows`` rows is split over: the batch
    axes as far as they divide it, none for a MoE stack."""
    if has_moe(cfg):
        return ()
    return batch_axes(multi_pod(mesh), rows, mesh.shape)


def replica_devices(mesh: Mesh, axes: tuple) -> list:
    """One device a data replica, in replica order (the axes' coordinates
    mixed-radix, the first the major one, as a batch spec splits rows): the
    device at the replica's coordinates and 0 on every other axis."""
    out = []
    for coords in np.ndindex(*(mesh.shape[a] for a in axes)):
        pos = [0] * len(mesh.axis_names)
        for a, c in zip(axes, coords):
            pos[mesh.axis_names.index(a)] = c
        out.append(mesh.devices[tuple(pos)])
    return out


def _labelled(batch: dict) -> int:
    """Labelled next-token targets of a batch (the loss's denominator)."""
    return int((batch["labels"][:, 1:] >= 0).sum())


class _Layers:
    """A stacked leaf of the reference's layout not yet stacked: its
    per-layer tensors (a leaf to ``ref_leaves``)."""

    __slots__ = ("layers",)

    def __init__(self, layers: list):
        self.layers = layers


def _layer_leaves(tree) -> list:
    """The port's tree as the leaves of the reference's layout, in its
    order, each stacked leaf left as its layers (``_Layers``), so that the
    step stacks one leaf at a time."""
    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([lay[k] for lay in layers]) for k in layers[0]}
        return _Layers(layers)

    return ref_leaves({**tree, "blocks": [stack(b) for b in tree["blocks"]]})


def grad_plan(specs, abstract, mesh: Mesh) -> list:
    """For each leaf of the reference's layout: [(block index, its home
    device, its slices)], the blocks in grid order."""
    out = []
    for s, a in zip(ref_leaves(specs), ref_leaves(abstract)):
        parts = spec_parts(s, a.ndim, mesh)
        size = [n // p for n, p in zip(a.shape, parts)]
        out.append([(idx, devs[0], tuple(slice(i * b, (i + 1) * b) for i, b in zip(idx, size)))
                    for idx, devs in block_layout(s, a.ndim, mesh).items()])
    return out


def make_mesh_train_step(cfg: ModelConfig, opt: Optimizer, tcfg: TrainStepCfg, mesh: Mesh):
    """step(params, opt_state, step_idx, batch) -> (params, opt_state,
    metrics) over ``mesh``: ``params`` and ``opt_state`` are trees of
    ShardedArrays (``init_sharded``), ``batch`` the whole batch (any
    device); the metrics sit on the first replica's device.

    The gradient is summed block by block on each block's home device:
    over the microbatches and, within one, the replicas in order, each
    replica's float32 slice scaled by its share of the microbatch's
    labelled tokens, then divided by the microbatches. With equal shares
    of 1/R (R a power of two) that is the unsharded step's sum over R x k
    microbatches bit for bit, since scaling by a power of two is exact.
    The gradient holds each block at its home only."""
    if opt.update_sharded is None:
        raise ValueError("this optimizer has no sharded update")
    pspecs, _ = train_specs(cfg, opt, mesh)
    abstract = M.abstract_params(cfg, stacked=True)
    plan = grad_plan(pspecs, abstract, mesh)
    grads_of = make_grads_of(cfg, tcfg)
    arules = act_rules(multi_pod(mesh))

    def step(params, opt_state, step_idx, batch):
        k = tcfg.microbatches
        rows = next(iter(batch.values())).shape[0]
        if rows % k:
            raise ValueError(f"a batch of {rows} rows in {k} microbatches")
        devs = replica_devices(mesh, replica_axes(cfg, rows // k, mesh))
        R, lead = len(devs), devs[0]
        n = rows // k // R
        acc = [{} for _ in plan]
        loss = metrics = None
        with sharding_context(mesh, arules):
            gathered = {}
            for d in devs:
                if str(d) not in gathered:
                    gathered[str(d)] = gather_params(params, d)
            for i in range(k):
                shards = [{name: x[(i * R + r) * n:(i * R + r + 1) * n].to(d)
                           for name, x in batch.items()} for r, d in enumerate(devs)]
                counts = [_labelled(s) for s in shards]
                total = sum(counts)
                weights = [c / total if total else 1.0 / R for c in counts]
                for d, w, s in zip(devs, weights, shards):  # replica order
                    l_r, m_r, g_r = grads_of(gathered[str(d)], s)
                    for a, leaf, blocks in zip(acc, _layer_leaves(g_r), plan):
                        # one leaf stacked at a time: its blocks, scaled
                        whole = torch.stack(leaf.layers) if isinstance(leaf, _Layers) else leaf
                        pieces = torch._foreach_mul([whole[sl].float() for _, _, sl in blocks],
                                                    w)
                        pieces = [x.to(home) for x, (_, home, _) in zip(pieces, blocks)]
                        if a:
                            torch._foreach_add_([a[idx] for idx, _, _ in blocks], pieces)
                        else:
                            a.update((idx, x) for (idx, _, _), x in zip(blocks, pieces))
                        del whole, pieces
                    del g_r
                    l_r = l_r.to(lead) * w
                    loss = l_r if loss is None else loss + l_r
                    if k == 1:
                        m_r = {key: v.to(lead) * w for key, v in m_r.items()}
                        metrics = m_r if metrics is None else {
                            key: metrics[key] + v for key, v in m_r.items()}
            del gathered
            if k > 1:
                for a in acc:
                    for t in a.values():
                        t.div_(k)
                loss = loss / k
                metrics = {"nll": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                           device=lead)}
            grads = ref_unflatten(pspecs, [
                ShardedArray(x.shape, torch.float32, s, mesh,
                             {idx: {str(home): a[idx]} for idx, home, _ in blocks})
                for x, s, a, blocks in zip(ref_leaves(abstract), ref_leaves(pspecs), acc, plan)])
            params, opt_state = opt.update_sharded(grads, opt_state, params, step_idx)
        return params, opt_state, dict(metrics, loss=loss)

    return step


def init_sharded(cfg: ModelConfig, opt: Optimizer, params, mesh: Mesh, state=None):
    """(sharded parameters, sharded optimizer state) from whole parameters
    in the port's layout and a whole optimizer state (``opt.init``'s by
    default), each split by its specs."""
    pspecs, ospecs = train_specs(cfg, opt, mesh)
    state = opt.init(params) if state is None else state
    return shard_tree(stack_blocks(params), pspecs, mesh), shard_tree(state, ospecs, mesh)
