"""Stand-ins and PartitionSpecs for every model input, per (arch x shape x
mesh) (the JAX package's ``launch/input_specs.py``): tensors on the
``meta`` device in place of ``ShapeDtypeStruct``s, so nothing is
allocated. The dry-run (``launch/dryrun.py``) traces against these.
"""
from __future__ import annotations

import torch

from repro_torch.configs import AttentionRuntime, ModelConfig, ShapeCfg
from repro_torch.distributed.cache_specs import cache_pspecs
from repro_torch.distributed.rules import batch_axes
from repro_torch.distributed.sharding import PartitionSpec as P, fit_spec_to_shape
from repro_torch.models import model as M
from repro_torch.params import ref_leaves, ref_unflatten


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _fit(specs, abstract, mesh):
    """Drop spec axes that do not divide the concrete dims (4 heads / 16)."""
    return ref_unflatten(specs, [fit_spec_to_shape(s, tuple(a.shape), mesh)
                                 for s, a in zip(ref_leaves(specs), ref_leaves(abstract))])


def _batch_ax(shape: ShapeCfg, mesh) -> tuple:
    return batch_axes("pod" in mesh.axis_names, shape.global_batch, mesh.shape)


def _seq_ax(shape: ShapeCfg, mesh, b_ax: tuple) -> tuple:
    """Token-arena sharding for decode caches: the axes the batch left free
    (a long-context batch of 1 shards the sequence instead)."""
    if shape.kind != "decode":
        return ()
    return tuple(a for a in ("data",) if a not in b_ax)


def train_inputs(cfg: ModelConfig, shape: ShapeCfg, mesh):
    """-> (meta batch, PartitionSpec tree) for the train batch."""
    B, S = shape.global_batch, shape.seq_len
    b = _batch_ax(shape, mesh)
    bspec = P(b if len(b) > 1 else (b[0] if b else None))
    batch = {"labels": _meta((B, S), torch.int32)}
    specs = {"labels": bspec}
    if cfg.input_kind == "audio_frames":
        batch["frames"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        specs["frames"] = P(bspec[0], None, None)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
        specs["tokens"] = bspec
    if cfg.input_kind == "text+patches":
        batch["patches"] = _meta((B, cfg.num_patch_tokens, cfg.d_model), torch.bfloat16)
        specs["patches"] = P(bspec[0], None, None)
    return batch, specs


def prefill_inputs(cfg: ModelConfig, rt: AttentionRuntime, shape: ShapeCfg, mesh):
    """-> (meta batch, batch specs, meta caches, cache specs)."""
    B, S = shape.global_batch, shape.seq_len
    batch, specs = train_inputs(cfg, shape, mesh)
    del batch["labels"], specs["labels"]
    b = _batch_ax(shape, mesh)
    s = _seq_ax(shape, mesh, b)
    caches = M.init_caches(cfg, rt, B, S, "meta")
    cspecs = _fit(cache_pspecs(cfg, rt, b if b else None, s if s else None), caches, mesh)
    return batch, specs, caches, cspecs


def decode_inputs(cfg: ModelConfig, rt: AttentionRuntime, shape: ShapeCfg, mesh):
    """-> (meta tokens, tokens spec, position, meta caches, cache specs).

    decode_* shapes run ``decode_step``: one new token against a cache of
    seq_len tokens."""
    B, N = shape.global_batch, shape.seq_len
    b = _batch_ax(shape, mesh)
    s = _seq_ax(shape, mesh, b)
    tokens = _meta((B, 1), torch.int32)
    tspec = P(b if len(b) > 1 else (b[0] if b else None), None)
    pos = _meta((), torch.int32)
    caches = M.init_caches(cfg, rt, B, N, "meta")
    cspecs = _fit(cache_pspecs(cfg, rt, b if b else None, s if s else None), caches, mesh)
    return tokens, tspec, pos, caches, cspecs
