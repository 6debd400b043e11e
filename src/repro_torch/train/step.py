"""Training step of the port (the JAX package's ``train/step.py``): loss ->
gradients -> optimizer update, with microbatch gradient accumulation in
float32 and remat. ``make_train_step`` returns a function of (params,
opt_state, step_idx, batch) -> (params, opt_state, metrics) that builds new
trees and leaves its arguments as they were, as the reference's pure step
does; ``batch`` is a dict of tensors on the parameters' device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.params import ref_leaves, ref_unflatten, tree_map


@dataclasses.dataclass(frozen=True)
class TrainStepCfg:
    microbatches: int = 1
    remat: bool = True
    aux_weight: float = 0.01


def make_grads_of(cfg: ModelConfig, tcfg: TrainStepCfg):
    """grads_of(params, batch) -> (loss, metrics, gradients in the
    parameters' dtypes) of one batch."""
    def grads_of(params, batch):
        leaves = [t.detach().requires_grad_(True) for t in ref_leaves(params)]
        loss, metrics = loss_fn(cfg, ref_unflatten(params, leaves), batch,
                                remat=tcfg.remat, aux_weight=tcfg.aux_weight)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                ref_unflatten(params, grads))

    return grads_of


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, tcfg: TrainStepCfg):
    grads_of = make_grads_of(cfg, tcfg)

    def train_step(params, opt_state, step_idx, batch):
        k = tcfg.microbatches
        if k == 1:
            loss, metrics, grads = grads_of(params, batch)
            grads = tree_map(lambda g: g.float(), grads)
        else:
            grads, loss = None, 0.0
            for i in range(k):
                mbatch = {name: x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
                          for name, x in batch.items()}
                l_i, _, g_i = grads_of(params, mbatch)
                grads = (tree_map(lambda g: g.float(), g_i) if grads is None
                         else tree_map(lambda a, g: a + g.float(), grads, g_i))
                loss = loss + l_i
            grads = tree_map(lambda g: g / k, grads)
            loss = loss / k
            metrics = {"nll": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                       device=loss.device)}
        updates, opt_state = optimizer.update(grads, opt_state, params, step_idx)
        params = apply_updates(params, updates)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step
