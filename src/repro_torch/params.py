"""Parameter trees of the PyTorch port: ``model_defs`` of the attention, MLA,
Mamba and xLSTM stacks with dense, MoE or no MLPs,
seeded initialisation on an explicit ``torch.Generator``, and ``from_jax``,
which carries a JAX parameter tree (as numpy leaves) across.

The tree mirrors the JAX package's ``model_defs`` (``models/model.py:41``)
with one change: the JAX tree stacks each block-pattern position's layers
along a leading ``num_blocks`` axis for ``lax.scan``, while the port keeps a
list of per-layer dicts there, since its forward pass is a Python loop::

    {"embed": {"tok", ["lm_head"]},
     "prefix": [layer, ...],
     "blocks": [[layer_0, ..., layer_{num_blocks-1}] per pattern position],
     "final_norm": {"scale"}}

Norm scales and biases are float32 whatever the model dtype, as in the JAX
package (``layers.py:22-25``, ``attention_layer.py:50-55``), and so are the
recurrent mixers' gate weights, biases and SSM parameters (``mamba.py:30``,
``xlstm.py:38``, ``:233``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import ModelConfig


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
    shape: tuple[int, ...]
    dtype: torch.dtype
    init: str = "fan_in"  # fan_in | normal | zeros | ones | s4d
    scale: float = 1.0


def _unported(kind) -> NotImplementedError:
    return NotImplementedError(
        f"layer kind {kind} is not ported yet (ROADMAP A19: the xattn mixer); the "
        "port runs 'attn', 'mla', 'mamba', 'mlstm' and 'slstm' mixers with 'dense', "
        "'moe' or no MLP")


def norm_defs(cfg: ModelConfig, dim: int | None = None):
    d = dim or cfg.d_model
    out = {"scale": ParamSpec((d,), torch.float32, "ones")}
    if cfg.norm == "layernorm":
        out["bias"] = ParamSpec((d,), torch.float32, "zeros")
    return out


def attn_defs(cfg: ModelConfig):
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    p = {"wq": ParamSpec((d, H * Dh), dt), "wk": ParamSpec((d, KV * Dh), dt),
         "wv": ParamSpec((d, KV * Dh), dt), "wo": ParamSpec((H * Dh, d), dt)}
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((H * Dh,), torch.float32, "zeros")
        p["bk"] = ParamSpec((KV * Dh,), torch.float32, "zeros")
        p["bv"] = ParamSpec((KV * Dh,), torch.float32, "zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((Dh,), torch.float32, "ones")
        p["k_norm"] = ParamSpec((Dh,), torch.float32, "ones")
    return p


def mlp_defs(cfg: ModelConfig):
    d, ff, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {"w_gate": ParamSpec((d, ff), dt), "w_up": ParamSpec((d, ff), dt),
                "w_down": ParamSpec((ff, d), dt)}
    return {"w_in": ParamSpec((d, ff), dt),
            "b_in": ParamSpec((ff,), torch.float32, "zeros"),
            "w_out": ParamSpec((ff, d), dt),
            "b_out": ParamSpec((d,), torch.float32, "zeros")}


def layer_defs(cfg: ModelConfig, kind: tuple[str, str]):
    from repro_torch.models import mamba, mla, moe, xlstm  # they import ParamSpec

    mixers = {"attn": attn_defs, "mla": mla.mla_defs, "mamba": mamba.mamba_defs,
              "mlstm": xlstm.mlstm_defs, "slstm": xlstm.slstm_defs}
    mixer, mlp = kind
    if mixer not in mixers or mlp not in ("dense", "moe", "none"):
        raise _unported(kind)
    d = {"norm1": norm_defs(cfg), "mixer": mixers[mixer](cfg)}
    if mlp != "none":
        d["norm2"] = norm_defs(cfg)
        d["mlp"] = moe.moe_defs(cfg) if mlp == "moe" else mlp_defs(cfg)
    return d


def embed_defs(cfg: ModelConfig):
    if cfg.input_kind != "tokens":
        raise NotImplementedError(
            f"input_kind={cfg.input_kind!r} is not ported yet (ROADMAP A19)")
    dt = cfg.param_dtype
    out = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), dt, "normal", 0.02)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), dt)
    return out


def model_defs(cfg: ModelConfig):
    return {
        "embed": embed_defs(cfg),
        "prefix": [layer_defs(cfg, k) for k in cfg.prefix_pattern],
        "blocks": [[layer_defs(cfg, k) for _ in range(cfg.num_blocks)]
                   for k in cfg.block_pattern],
        "final_norm": norm_defs(cfg),
    }


# ------------------------------------------------------------------- init


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


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

    return _tree_map(make, model_defs(cfg))


def _leaf_to_torch(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":  # numpy carries JAX bf16 as ml_dtypes
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_jax(tree, device=None):
    """The JAX parameter tree (``jax.tree.map(np.asarray, params)``) as the
    port's tree: same leaves, same dtypes, and each stacked ``blocks`` leaf
    split along its leading ``num_blocks`` axis into per-layer tensors (an
    expert leaf (num_blocks, E, d, F) into (E, d, F) each; nested trees such
    as MoE's ``shared`` experts keep their shape)."""
    device = resolve_device(device)
    conv = lambda t: _tree_map(lambda a: _leaf_to_torch(a).to(device), t)  # noqa: E731

    def unstack(stacked):
        n = {len(t) for t in _leaves(stacked)}
        if len(n) != 1:
            raise ValueError(f"stacked block leaves disagree on num_blocks: {n}")
        return [_tree_map(lambda t, i=i: t[i], stacked) for i in range(n.pop())]

    return {
        "embed": conv(tree["embed"]),
        "prefix": conv(tree["prefix"]),
        "blocks": [unstack(conv(b)) for b in tree["blocks"]],
        "final_norm": conv(tree["final_norm"]),
    }


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def to_device(tree, device):
    """Move every leaf of a parameter tree to ``device`` (no copy for
    leaves already there)."""
    return _tree_map(lambda t: t.to(device), tree)
