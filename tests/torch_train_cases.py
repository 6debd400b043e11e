"""Shared inputs of the port's training tests (``test_torch_train*.py``):
one config in both packages, seeded numpy batches in the reference's
format, JAX weights with the cross-attention gates set nonzero (the
reference draws them at zero, where the layer adds nothing), and the
conversions between the two packages' trees."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS, ASSIGNED, smoke_config
from repro.models import model as JM
import repro_torch.configs as tc
from repro_torch.params import from_jax, ref_leaves, stack_blocks

# test_models_smoke.py's eleven configurations
SMOKE_ARCHS = sorted(ASSIGNED) + ["opt-6.7b"]
GATE = 0.5


def pair(arch: str, **kw):
    """The smoke config of ``arch`` at float32 in both packages."""
    jcfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32", **kw)
    tcfg = dataclasses.replace(tc.smoke_config(tc.ARCHS[arch]), dtype="float32", **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def batch_np(cfg, seed: int, B: int = 2, S: int = 24, pad: bool = True) -> dict:
    """A training batch in the reference's format: tokens (or an audio
    model's frames), labels (with ``pad``, a padded tail (-1) in row 0), and
    patches for a text+patches model."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {}
    if cfg.input_kind == "audio_frames":
        out["frames"] = (0.3 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
    else:
        out["tokens"] = labels.copy()
    if pad:
        labels[0, -3:] = -1
    out["labels"] = labels
    if cfg.input_kind == "text+patches":
        out["patches"] = rng.standard_normal(
            (B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return out


def jax_params(cfg, seed: int = 0):
    """JAX weights from ``seed``, every cross-attention gate at ``GATE``."""
    def gates(t):
        if isinstance(t, dict):
            return {k: (jnp.full_like(v, GATE) if k == "gate" else gates(v))
                    for k, v in t.items()}
        if isinstance(t, list):
            return [gates(v) for v in t]
        return t

    return gates(JM.init_params(cfg, jax.random.PRNGKey(seed)))


def numpy_params(cfg, seed: int):
    """Weights shaped like the JAX parameters, drawn with numpy (N(0, 0.1)
    in each leaf's dtype, gates at ``GATE``): for tests where the values'
    distribution does not matter, without JAX's per-shape compiles."""
    rng = np.random.default_rng(seed)
    abstract = JM.abstract_params(cfg)
    leaves, treedef = jax.tree.flatten(abstract)
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(abstract)[0]]
    out = [jnp.full(a.shape, GATE, a.dtype) if "'gate'" in path else
           jnp.asarray((0.1 * rng.standard_normal(a.shape)).astype(np.float32), a.dtype)
           for a, path in zip(leaves, paths)]
    return jax.tree.unflatten(treedef, out)


def to_torch(params):
    """A JAX parameter tree as the port's, on the CPU."""
    return from_jax(jax.tree.map(np.asarray, params), device="cpu")


def as_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_leaves(tree) -> list:
    """The leaves of a port tree in the reference's layout and order, as
    float64 numpy arrays."""
    return [t.detach().double().numpy() for t in ref_leaves(stack_blocks(tree))]


def jax_leaves(tree) -> list:
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


FLOOR = 1e-12  # the least scale of a leaf: one whose reference is all zero must be zero


def leaf_scale(w: np.ndarray) -> float:
    """A leaf's largest magnitude, at least FLOOR."""
    return max(FLOOR, float(np.max(np.abs(w))) if w.size else 0.0)


def tree_cap(want: list, rel: float) -> float:
    """``rel`` times the largest magnitude of a whole tree (at least 1): an
    absolute bound that no leaf's tolerance may pass."""
    return rel * max(1.0, max(float(np.max(np.abs(w))) if w.size else 0.0 for w in want))


def assert_leaves_close(got: list, want: list, rel: float, what: str,
                        cap: float = np.inf) -> None:
    """Every leaf within ``rel`` times its own largest reference magnitude
    (``leaf_scale``), absolute, and within ``cap``."""
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=min(cap, rel * leaf_scale(w)),
                                   err_msg=f"{what} leaf {i}")


def assert_steps_close(got: list, want: list, old: list, rel: float, what: str,
                       cap: float = np.inf) -> None:
    """Two steps from the same parameters ``old``: every leaf's change
    (``got - old``) within ``rel`` times the largest change of the
    reference's leaf (``want - old``) plus one float32 rounding step of the
    leaf's largest parameter (each side rounds its new parameters to
    float32), and within ``cap``. A step that changes nothing fails."""
    assert len(got) == len(want) == len(old), (what, len(got), len(want), len(old))
    for i, (g, w, o) in enumerate(zip(got, want, old)):
        assert g.shape == w.shape == o.shape, (what, i, g.shape, w.shape, o.shape)
        ulp = 2.0 ** -23 * float(np.max(np.abs(w))) if w.size else 0.0
        np.testing.assert_allclose(g - o, w - o, rtol=0,
                                   atol=min(cap, rel * leaf_scale(w - o) + ulp),
                                   err_msg=f"{what} leaf {i}")


def sgd_pair(lr: float):
    """A plain SGD probe (``-lr * g``) as the ``Optimizer`` of each package:
    a train step's float32 gradients reach the parameters as they are.
    (AdamW's first step divides each gradient by its own magnitude, so an
    element whose gradient is near its eps, 1e-8, turns a last-ulp
    difference into a visible one.)"""
    from repro.optim import Optimizer as JOptimizer
    from repro_torch.optim import Optimizer
    from repro_torch.params import tree_map

    j = JOptimizer(init=lambda p: (), state_like=None, state_specs=None,
                   update=lambda g, s, p, step: (jax.tree.map(lambda x: -lr * x, g), s))
    t = Optimizer(init=lambda p: (),
                  update=lambda g, s, p, step: (tree_map(lambda x: -lr * x, g), s))
    return j, t
