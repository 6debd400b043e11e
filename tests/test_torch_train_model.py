"""The port's ``forward_train``, ``loss_fn`` and their gradients against the
JAX package's, for the eleven smoke configurations of
``test_models_smoke.py``, on the same seeded numpy batch and the same
weights (``from_jax``; cross-attention gates at 0.5). Float32. The JAX side
runs at ``remat=False`` (one jitted ``value_and_grad``); the port's
gradients come through its remat path (``torch.utils.checkpoint``), its
logits without. Stated tolerances: logits, the loss and the aux loss
within 1e-4 of the largest magnitude of the reference's output (at least
1), absolute; gradients leaf by leaf in the reference's stacked layout
(``params.stack_blocks``), each within ``grad_tol(arch)`` of the leaf's
own largest reference magnitude; the same for the change of the
parameters in the port's ``make_train_step`` under a plain SGD probe
against the reference's gradients applied the same way. ``grad_tol`` is
1e-5, where the stacks' worst leaf was at 2.3e-6; 1e-4 for
jamba-1.5-large-398b, whose eight-layer Mamba/MoE stack sets its worst
leaf near 4.2e-5 (a single Mamba layer agrees to 5e-7; the error is in
the forward already, 6e-6 at ``lm_head``); and 5e-4 for xlstm-125m, whose
sLSTM's random recurrent weights amplify float32 rounding (ROADMAP C) to
1.3e-4. No leaf's tolerance passes 1e-4 of the tree's largest magnitude
(at least 1), absolute (``tree_cap``)."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.models import model as TM
from repro_torch.params import ref_leaves, ref_unflatten
from torch_train_cases import (SMOKE_ARCHS, as_jax, as_torch, assert_leaves_close,
                               assert_steps_close, batch_np, jax_leaves, jax_params, pair,
                               port_leaves, sgd_pair, to_torch, tree_cap)

TOL = 1e-4
GRAD_TOL = {"jamba-1.5-large-398b": 1e-4, "xlstm-125m": 5e-4}


def grad_tol(arch: str) -> float:
    return GRAD_TOL.get(arch, 1e-5)


def assert_grads_close(got: list, want: list, arch: str, what: str) -> None:
    assert_leaves_close(got, want, grad_tol(arch), what, cap=tree_cap(want, TOL))


@functools.lru_cache(maxsize=None)
def reference(arch: str, S: int = 24, B: int = 2, **kw):
    """(jax cfg, port cfg, JAX params, batch, JAX logits, aux, loss, nll,
    gradients)."""
    jcfg, tcfg = pair(arch, **kw)
    params = jax_params(jcfg)
    batch = batch_np(jcfg, seed=0, B=B, S=S)
    jb = as_jax(batch)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb, remat=False), has_aux=True))(params)
    logits, aux = jax.jit(lambda p: JM.forward_train(jcfg, p, jb, remat=False))(params)
    return jcfg, tcfg, params, batch, logits, aux, loss, metrics["nll"], grads


def port_grads(tcfg, params, batch, remat: bool):
    leaves = [t.requires_grad_(True) for t in ref_leaves(params)]
    loss, metrics = TM.loss_fn(tcfg, params, as_torch(batch), remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
    return loss, metrics, ref_unflatten(params, grads)


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got.detach().double().numpy(), want, rtol=0,
                               atol=TOL * scale, err_msg=what)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_forward_train_and_loss_match_jax(arch):
    _, tcfg, params, batch, logits, aux, loss, nll, _ = reference(arch)
    tp = to_torch(params)
    with torch.no_grad():
        t_logits, t_aux = TM.forward_train(tcfg, tp, as_torch(batch), remat=False)
        t_loss, t_metrics = TM.loss_fn(tcfg, tp, as_torch(batch), remat=False)
    assert t_logits.dtype == torch.float32 and t_logits.shape == logits.shape
    _close(t_logits, logits, "logits")
    _close(t_aux, aux, "aux")
    _close(t_loss, loss, "loss")
    _close(t_metrics["nll"], nll, "nll")
    if tcfg.moe is not None:
        assert float(t_aux) > 0  # the aux loss is summed over the MoE layers


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_gradients_match_jax(arch):
    _, tcfg, params, batch, _, _, loss, _, grads = reference(arch)
    t_loss, _, t_grads = port_grads(tcfg, to_torch(params), batch, remat=True)
    _close(t_loss, loss, "loss")
    assert_grads_close(port_leaves(t_grads), jax_leaves(grads), arch, f"{arch} grads")


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_train_step_matches_jax_gradients(arch):
    """The port's ``make_train_step`` (remat on) under a plain SGD probe
    (``-lr * g``, so the step's float32 gradients reach the parameters as
    they are) against the reference's gradients applied the same way:
    each leaf's change within ``grad_tol`` of its own largest change, the
    loss within 1e-4."""
    from repro_torch.train.step import TrainStepCfg, make_train_step

    lr = 0.5
    _, tcfg, params, batch, _, _, loss, _, grads = reference(arch)
    _, sgd = sgd_pair(lr)
    new, _, metrics = make_train_step(tcfg, sgd, TrainStepCfg(remat=True))(
        to_torch(params), (), 0, as_torch(batch))
    _close(metrics["loss"], loss, "loss")
    want = jax.tree.map(lambda p, g: np.asarray(
        (np.asarray(p, np.float32) + np.float32(-lr) * np.asarray(g, np.float32)
         ).astype(np.asarray(p).dtype), np.float64), params, grads)
    want = jax.tree.leaves(want)
    assert_steps_close(port_leaves(new), want, jax_leaves(params), grad_tol(arch),
                       f"{arch} step", cap=tree_cap(want, TOL))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "jamba-1.5-large-398b",
                                  "deepseek-moe-16b", "xlstm-125m"])
def test_remat_matches_no_remat(arch):
    """The checkpointed forward (per block, and per layer where the block
    pattern has several) recomputes exactly what it dropped: the same
    loss and gradients, here on the CPU to 1e-6 of each leaf's largest."""
    _, tcfg, params, batch, *_ = reference(arch)
    l1, _, g1 = port_grads(tcfg, to_torch(params), batch, remat=True)
    l0, _, g0 = port_grads(tcfg, to_torch(params), batch, remat=False)
    assert float(l1.detach()) == pytest.approx(float(l0.detach()), abs=1e-6)
    assert_leaves_close(port_leaves(g1), port_leaves(g0), 1e-6, f"{arch} remat")


def test_moe_aux_has_a_gradient():
    """Autograd flows through the capacity dispatch and the router: the aux
    loss alone gives the router a gradient, and it is ``jax.grad``'s of
    the reference's aux loss (every leaf, within 1e-5 of the leaf's
    largest)."""
    jcfg, tcfg, params, batch, *_ = reference("deepseek-moe-16b")
    jb = as_jax(batch)
    want = jax.jit(jax.grad(lambda p: JM.forward_train(jcfg, p, jb, remat=False)[1]))(params)
    tp = to_torch(params)
    leaves = [t.requires_grad_(True) for t in ref_leaves(tp)]
    _, aux = TM.forward_train(tcfg, tp, as_torch(batch), remat=False)
    got = torch.autograd.grad(aux, leaves, allow_unused=True)
    got = ref_unflatten(tp, [torch.zeros_like(t) if g is None else g
                             for g, t in zip(got, leaves)])
    router = got["blocks"][0][0]["mlp"]["router"]
    assert float(router.abs().max()) > 0
    assert_grads_close(port_leaves(got), jax_leaves(want), "deepseek-moe-16b", "aux grads")


def test_forward_train_past_the_flash_threshold():
    """qwen1.5-0.5b smoke at one block over 1040 positions: both packages'
    attention takes flash attention there (past 1024) and its custom
    backward."""
    _, tcfg, params, batch, logits, _, loss, _, grads = reference(
        "qwen1.5-0.5b", S=1040, B=1)
    tp = to_torch(params)
    with torch.no_grad():
        t_logits, _ = TM.forward_train(tcfg, tp, as_torch(batch), remat=False)
    _close(t_logits, logits, "logits")
    t_loss, _, t_grads = port_grads(tcfg, to_torch(params), batch, remat=True)
    _close(t_loss, loss, "loss")
    assert_grads_close(port_leaves(t_grads), jax_leaves(grads), "qwen1.5-0.5b",
                       "grads past 1024")
