"""Parameter trees of the PyTorch port: ``model_defs`` of the attention,
cross-attention, MLA, Mamba and xLSTM stacks with dense, MoE or no MLPs and
token, audio-frame or text+patch inputs, seeded initialisation on an
explicit ``torch.Generator``, ``from_jax``, which carries a JAX parameter
tree (as numpy leaves) across, and its inverse ``stack_blocks`` with
``ref_leaves``, which give a tree's leaves in the reference's layout and
order (the optimizers, the checkpoints and the tests compare there).

The tree mirrors the JAX package's ``model_defs`` (``models/model.py:41``)
with one change: the JAX tree stacks each block-pattern position's layers
along a leading ``num_blocks`` axis for ``lax.scan``, while the port keeps a
list of per-layer dicts there, since its forward pass is a Python loop::

    {"embed": {"tok", ["mm_proj"], ["lm_head"]},
     "prefix": [layer, ...],
     "blocks": [[layer_0, ..., layer_{num_blocks-1}] per pattern position],
     "final_norm": {"scale"}}

Norm scales and biases are float32 whatever the model dtype, as in the JAX
package (``layers.py:22-25``, ``attention_layer.py:50-55``), and so are the
recurrent mixers' gate weights, biases and SSM parameters (``mamba.py:30``,
``xlstm.py:38``, ``:233``) and the cross-attention's scalar ``gate``
(``attention_layer.py:56-57``), which starts at zero: a cross-attention layer
adds nothing until its gate is set.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.distributed.sharding import PartitionSpec


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    another. Without a GPU and without an explicit device this raises: an
    entry point never drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# ------------------------------------------------------------------- defs


@dataclass(frozen=True)
class ParamSpec:
    """One parameter: its shape, dtype, one logical sharding axis (or None)
    a dimension, as the reference's ``ParamDef`` names them (``"embed"``,
    ``"heads"``, ``"mlp"``, ...; ``distributed/rules.py`` maps them onto
    mesh axes), and its initializer."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    axes: tuple
    init: str = "fan_in"  # fan_in | normal | zeros | ones | s4d
    scale: float = 1.0

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"{self.shape} given the logical axes {self.axes}")


def norm_defs(cfg: ModelConfig, dim: int | None = None):
    d = dim or cfg.d_model
    out = {"scale": ParamSpec((d,), torch.float32, (None,), "ones")}
    if cfg.norm == "layernorm":
        out["bias"] = ParamSpec((d,), torch.float32, (None,), "zeros")
    return out


def attn_defs(cfg: ModelConfig, cross: bool = False):
    """Self-attention weights, or with ``cross`` those of a gated
    cross-attention layer: the same projections and a scalar float32
    ``gate`` at zero, whose tanh scales the layer's output."""
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    p = {"wq": ParamSpec((d, H * Dh), dt, ("embed", "heads")),
         "wk": ParamSpec((d, KV * Dh), dt, ("embed", "kv_heads")),
         "wv": ParamSpec((d, KV * Dh), dt, ("embed", "kv_heads")),
         "wo": ParamSpec((H * Dh, d), dt, ("heads", "embed"))}
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((H * Dh,), torch.float32, (None,), "zeros")
        p["bk"] = ParamSpec((KV * Dh,), torch.float32, (None,), "zeros")
        p["bv"] = ParamSpec((KV * Dh,), torch.float32, (None,), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((Dh,), torch.float32, (None,), "ones")
        p["k_norm"] = ParamSpec((Dh,), torch.float32, (None,), "ones")
    if cross:
        p["gate"] = ParamSpec((), torch.float32, (), "zeros")
    return p


def mlp_defs(cfg: ModelConfig):
    d, ff, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {"w_gate": ParamSpec((d, ff), dt, ("embed", "mlp")),
                "w_up": ParamSpec((d, ff), dt, ("embed", "mlp")),
                "w_down": ParamSpec((ff, d), dt, ("mlp", "embed"))}
    return {"w_in": ParamSpec((d, ff), dt, ("embed", "mlp")),
            "b_in": ParamSpec((ff,), torch.float32, (None,), "zeros"),
            "w_out": ParamSpec((ff, d), dt, ("mlp", "embed")),
            "b_out": ParamSpec((d,), torch.float32, (None,), "zeros")}


def layer_defs(cfg: ModelConfig, kind: tuple[str, str]):
    from repro_torch.models import mamba, mla, moe, xlstm  # they import ParamSpec

    mixers = {"attn": attn_defs, "xattn": lambda c: attn_defs(c, cross=True),
              "mla": mla.mla_defs, "mamba": mamba.mamba_defs, "mlstm": xlstm.mlstm_defs,
              "slstm": xlstm.slstm_defs}
    mixer, mlp = kind
    if mixer not in mixers or mlp not in ("dense", "moe", "none"):
        raise ValueError(f"unknown layer kind {kind}: mixers {sorted(mixers)}, MLPs "
                         "'dense', 'moe' or 'none'")
    d = {"norm1": norm_defs(cfg), "mixer": mixers[mixer](cfg)}
    if mlp != "none":
        d["norm2"] = norm_defs(cfg)
        d["mlp"] = moe.moe_defs(cfg) if mlp == "moe" else mlp_defs(cfg)
    return d


def embed_defs(cfg: ModelConfig):
    """The token table (audio models keep one too: decode feeds codes), the
    patch adapter ``mm_proj`` of a text+patches model (its patches arrive
    at d_model) and an untied LM head."""
    if cfg.input_kind not in ("tokens", "audio_frames", "text+patches"):
        raise ValueError(f"unknown input_kind={cfg.input_kind!r}")
    dt = cfg.param_dtype
    out = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), dt, ("vocab", "embed"), "normal",
                            0.02)}
    if cfg.input_kind == "text+patches":
        out["mm_proj"] = ParamSpec((cfg.d_model, cfg.d_model), dt, ("embed", "mlp"))
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), dt, ("embed", "vocab"))
    return out


def model_defs(cfg: ModelConfig):
    return {
        "embed": embed_defs(cfg),
        "prefix": [layer_defs(cfg, k) for k in cfg.prefix_pattern],
        "blocks": [[layer_defs(cfg, k) for _ in range(cfg.num_blocks)]
                   for k in cfg.block_pattern],
        "final_norm": norm_defs(cfg),
    }


def stack_defs(defs):
    """A ``model_defs`` tree in the reference's layout: each block-pattern
    position's per-layer specs stacked into one (num_blocks, ...) spec whose
    leading logical axis is ``"layers"`` (the reference's ``stack_defs``)."""
    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([lay[k] for lay in layers]) for k in layers[0]}
        s = layers[0]
        return ParamSpec((len(layers),) + s.shape, s.dtype, ("layers",) + s.axes, s.init,
                         s.scale)

    return {**defs, "blocks": [stack(b) for b in defs["blocks"]]}


def spec_tree(defs, rules: dict, mesh_shape: dict | None = None):
    """Logical axes -> PartitionSpecs (the reference's ``spec_tree``):
    ``rules`` maps a logical name to a mesh axis, a tuple of mesh axes or
    None; a mesh axis is used once a spec. With ``mesh_shape``, the axes
    that do not divide their dimension are dropped (4 sLSTM heads over a
    16-way model axis)."""
    def one(d: ParamSpec) -> PartitionSpec:
        mesh_axes, seen = [], set()
        for dim, ax in zip(d.shape, d.axes):
            m = rules.get(ax) if ax is not None else None
            ms = () if m is None else ((m,) if isinstance(m, str) else tuple(m))
            ms = tuple(a for a in ms if a not in seen)
            if mesh_shape is not None:
                kept, prod = [], 1
                for a in ms:
                    k = mesh_shape.get(a, 1)
                    if dim % (prod * k) == 0:
                        kept.append(a)
                        prod *= k
                ms = tuple(kept)
            seen.update(ms)
            mesh_axes.append(ms if len(ms) > 1 else (ms[0] if ms else None))
        return PartitionSpec(*mesh_axes)

    return tree_map(one, defs)


def count_params(defs) -> int:
    """Parameters of a ``model_defs`` tree, counted from its ``ParamSpec``
    shapes (nothing is allocated)."""
    return sum(math.prod(s.shape) for s in ref_leaves(defs))


# ------------------------------------------------------------------ trees


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists,
    tuples and NamedTuples of tensors; a ``PartitionSpec`` is a leaf)."""
    t = trees[0]
    if isinstance(t, PartitionSpec):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    if isinstance(t, tuple):
        vals = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
    return None if t is None else fn(*trees)


def ref_leaves(tree) -> list:
    """The leaves of a tree in ``jax.tree.flatten``'s order: dict keys
    sorted, lists and tuples (state NamedTuples by field) in order, None a
    node with no leaf, a ``PartitionSpec`` a leaf."""
    if isinstance(tree, PartitionSpec):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in ref_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in ref_leaves(v)]
    return [] if tree is None else [tree]


def ref_unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are ``leaves``, in
    ``ref_leaves``' order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, PartitionSpec):
            return next(it)
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        if isinstance(t, tuple):
            vals = [build(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
        return None if t is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


# ------------------------------------------------------------------- init


def init_params(cfg: ModelConfig, seed: int, device=None):
    """Random weights from ``seed`` (normal, scaled by fan-in; norms at one,
    biases at zero, Mamba's ``A_log`` at log(1..d_state) along its last axis,
    as ``ParamDef.materialize`` draws them). The numbers
    differ from the JAX package's: carry JAX weights with ``from_jax``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def make(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        if s.init == "s4d":  # S4D-real: A = -(1..d_state) per channel, kept as log
            a = torch.log(torch.arange(1, s.shape[-1] + 1, dtype=torch.float32, device=device))
            return a.expand(s.shape).to(s.dtype).contiguous()
        # fan-in is dim 0, as ParamDef's: an expert tensor (E, d, F) takes E
        std = s.scale if s.init == "normal" else s.scale / math.sqrt(max(s.shape[0], 1))
        w = torch.randn(s.shape, generator=gen, dtype=torch.float32, device=device)
        return (w * std).to(s.dtype)

    return tree_map(make, model_defs(cfg))


def _leaf_to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    shape = a.shape  # ascontiguousarray makes a 0-d leaf (a gate) 1-d
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # numpy carries JAX bf16 as ml_dtypes
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(a.copy()).reshape(shape)


def from_jax(tree, device=None):
    """The JAX parameter tree (``jax.tree.map(np.asarray, params)``) as the
    port's tree: same leaves, same dtypes, and each stacked ``blocks`` leaf
    split along its leading ``num_blocks`` axis into per-layer tensors (an
    expert leaf (num_blocks, E, d, F) into (E, d, F) each, a cross-attention
    ``gate`` (num_blocks,) into 0-d tensors; nested trees such as MoE's
    ``shared`` experts keep their shape)."""
    device = resolve_device(device)
    tree = unstack_blocks(tree_map(lambda a: _leaf_to_torch(a).to(device), tree))
    return {k: tree[k] for k in ("embed", "prefix", "blocks", "final_norm")}


def unstack_blocks(tree):
    """A tree in the reference's layout (each ``blocks`` leaf stacked along
    a leading ``num_blocks`` axis) as the port's: every block leaf split
    into per-layer views."""
    def unstack(stacked):
        n = {len(t) for t in ref_leaves(stacked)}
        if len(n) != 1:
            raise ValueError(f"stacked block leaves disagree on num_blocks: {n}")
        return [tree_map(lambda t, i=i: t[i], stacked) for i in range(n.pop())]

    return {**tree, "blocks": [unstack(b) for b in tree["blocks"]]}


def stack_blocks(tree):
    """The inverse of ``unstack_blocks``: the port's tree (parameters, or a
    tree shaped like them, such as their gradients) in the reference's
    layout, each block-pattern position's per-layer leaves stacked into one
    (num_blocks, ...) tensor (a copy)."""
    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([lay[k] for lay in layers]) for k in layers[0]}
        return torch.stack(layers)

    return {**tree, "blocks": [stack(b) for b in tree["blocks"]]}


def to_device(tree, device):
    """Move every leaf of a parameter tree to ``device`` (no copy for
    leaves already there)."""
    return tree_map(lambda t: t.to(device), tree)
