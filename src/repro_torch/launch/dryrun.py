"""Dry-run of the port on the production meshes, on the ``meta`` device:
every (arch x shape) cell is traced with shapes only (nothing allocated,
no compile), and its record gives what a device of the mesh holds and
computes (the JAX package's ``launch/dryrun.py``, which lowers and compiles
through XLA instead; its HLO analysis is XLA's and has no counterpart).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Each record: the per-device bytes of the parameters, the optimizer state
(train cells), the batch and the caches (prefill and decode cells), from
the fitted specs; the FLOPs of one data replica's step, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the port's own step on
meta tensors (train: ``grads_of`` over each microbatch's share of the
rows, forward and backward; prefill: ``prefill``; decode: ``decode_step``
at the cache's last position; both through the plain attention path,
``AttentionRuntime(paged_kernels=False)``, since the kernels take CUDA
tensors and their plain versions do the same arithmetic); the mesh, the optimizer and the
microbatches. The ``model`` axis shards storage only in the port
(``train/sharded.py``; its tensor-parallel compute is ROADMAP A21c), so a
replica's FLOPs are its whole model's on its rows. A train record also
gives what a step holds at its peak besides a device's blocks: the whole
model a replica gathers, the whole gradient of its rows, and the float32
sums of the gradient blocks a device is home to. One JSON per cell under
``experiments/dryrun_torch/`` by default, never under the reference's
``experiments/dryrun/``. A cell that cannot be traced fails the run and is
listed at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED, SHAPES, cell_supported, get_config
from repro_torch.distributed.rules import param_rules
from repro_torch.distributed.sharding import spec_parts
from repro_torch.launch import input_specs as ispec
from repro_torch.launch.mesh import make_production_mesh, mesh_shape_dict
from repro_torch.models import model as M
from repro_torch.optim import adafactor, adamw, cosine_schedule
from repro_torch.params import count_params, model_defs, ref_leaves, tree_map
from repro_torch.train.sharded import fit_tree, replica_axes
from repro_torch.train.step import TrainStepCfg, make_grads_of

ROOT = Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "experiments" / "dryrun_torch"
REFERENCE_DIR = ROOT / "experiments" / "dryrun"  # the reference's records: never written
COMPUTE = ("one data replica's whole step on its rows: the model axis shards storage "
           "only (tensor-parallel compute: ROADMAP A21c). At a train step's peak a "
           "replica's device also holds the whole model gathered and the whole gradient "
           "of its rows (gather_bytes_per_replica, grad_bytes_per_replica), and a device "
           "the float32 sums of the gradient blocks it is home to "
           "(grad_sum_bytes_per_device, at most); activations not counted")


def pick_optimizer(cfg):
    """Adafactor for models whose float32 Adam moments would not fit 16 GB
    a chip (the reference's rule, over 5e10 parameters)."""
    n = count_params(model_defs(cfg))
    return ("adafactor", adafactor(cosine_schedule(1e-4, 100, 10000))) if n > 5e10 \
        else ("adamw", adamw(cosine_schedule(3e-4, 100, 10000)))


def suggest_microbatches(cfg, shape, mesh) -> int:
    """Keep the per-device scan-carry activation footprint under ~2 GB (the
    reference's rule)."""
    ms = mesh_shape_dict(mesh)
    dp = ms.get("data", 1) * ms.get("pod", 1)
    b_loc = max(shape.global_batch // dp, 1)
    carry = b_loc * shape.seq_len * cfg.d_model * 2 * max(cfg.num_blocks, 1)
    k = 1
    while carry / k > 2.0e9 and k < b_loc:
        k *= 2
    while shape.global_batch % (k * dp) and k > 1:
        k //= 2
    return k


def _rows(batch: dict, n: int) -> dict:
    """The first ``n`` rows of a meta batch (a replica's share)."""
    return {k: v[:n] for k, v in batch.items()}


def spec_bytes(specs, abstract, mesh) -> int:
    """The bytes a grid position holds of a tree whose leaves ``abstract``
    are split by ``specs``: each leaf's elements over the product of its
    spec's mesh-axis sizes."""
    return sum(a.numel() // math.prod(spec_parts(s, a.ndim, mesh)) * a.element_size()
               for s, a in zip(ref_leaves(specs), ref_leaves(abstract)))


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def trace_cell(arch: str, shape_name: str, multi_pod: bool, mode: str | None = None,
               count_flops: bool = True) -> dict:
    """One cell's record (see the module's docstring); without ``count_flops``
    the bytes alone (no trace of the step)."""
    cfg = get_config(arch)
    if mode and mode != "dense":
        cfg = cfg.with_attention(mode)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod, devices="meta")
    pspecs = fit_tree(M.param_specs(cfg, param_rules(multi_pod), mesh.shape, stacked=True),
                      M.abstract_params(cfg, stacked=True), mesh)
    abstract = M.abstract_params(cfg, stacked=True)
    params = M.abstract_params(cfg)
    rec = {"arch": arch, "shape": shape_name, "mode": mode or cfg.attention.mode,
           "mesh": "pod2x16x16" if multi_pod else "16x16",
           "devices": int(math.prod(mesh.devices.shape)), "kind": shape.kind,
           "param_bytes_per_device": spec_bytes(pspecs, abstract, mesh), "compute": COMPUTE}
    if shape.kind == "train":
        opt_name, opt = pick_optimizer(cfg)
        mb = suggest_microbatches(cfg, shape, mesh)
        batch, bspecs = ispec.train_inputs(cfg, shape, mesh)
        ostate = opt.state_like(abstract)
        ospecs = fit_tree(opt.state_specs(pspecs, abstract), ostate, mesh)
        axes = replica_axes(cfg, shape.global_batch // mb, mesh)
        rows = shape.global_batch // mb // math.prod(mesh.shape[a] for a in axes)
        grads_of = make_grads_of(cfg, TrainStepCfg(microbatches=mb))
        flops = (mb * _count(lambda: grads_of(params, _rows(batch, rows)))
                 if count_flops else None)
        whole = sum(a.numel() * a.element_size() for a in ref_leaves(abstract))
        f32 = tree_map(lambda a: torch.empty(a.shape, dtype=torch.float32, device="meta"),
                       abstract)
        rec.update(optimizer=opt_name, microbatches=mb,
                   state_bytes_per_device=spec_bytes(ospecs, ostate, mesh),
                   batch_bytes_per_device=spec_bytes(bspecs, batch, mesh),
                   gather_bytes_per_replica=whole, grad_bytes_per_replica=whole,
                   grad_sum_bytes_per_device=spec_bytes(pspecs, f32, mesh))
    elif shape.kind == "prefill":
        rt = dataclasses.replace(cfg.attention, paged_kernels=False)
        batch, bspecs, caches, cspecs = ispec.prefill_inputs(cfg, rt, shape, mesh)
        axes = replica_axes(cfg, shape.global_batch, mesh)
        rows = shape.global_batch // math.prod(mesh.shape[a] for a in axes)
        mine = M.init_caches(cfg, rt, rows, shape.seq_len, "meta")
        with torch.no_grad():
            flops = _count(lambda: M.prefill(cfg, rt, params, _rows(batch, rows), mine)) \
                if count_flops else None
        rec.update(batch_bytes_per_device=spec_bytes(bspecs, batch, mesh),
                   cache_bytes_per_device=spec_bytes(cspecs, caches, mesh))
    else:
        rt = dataclasses.replace(cfg.attention, paged_kernels=False)
        tokens, tspec, _, caches, cspecs = ispec.decode_inputs(cfg, rt, shape, mesh)
        axes = replica_axes(cfg, shape.global_batch, mesh)
        rows = shape.global_batch // math.prod(mesh.shape[a] for a in axes)
        mine = M.init_caches(cfg, rt, rows, shape.seq_len, "meta")
        with torch.no_grad():
            flops = (_count(lambda: M.decode_step(cfg, rt, params, tokens[:rows],
                                                  shape.seq_len - 1, mine))
                     if count_flops else None)
        rec.update(batch_bytes_per_device=spec_bytes({"tokens": tspec}, {"tokens": tokens},
                                                     mesh),
                   cache_bytes_per_device=spec_bytes(cspecs, caches, mesh))
    rec.update(replica_axes=list(axes), replica_rows=rows, flops_per_device=flops)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, mode: str | None = None,
             out_dir: Path = OUT_DIR, save: bool = True) -> dict:
    if Path(out_dir).resolve() == REFERENCE_DIR.resolve():
        raise ValueError(f"{out_dir} holds the reference's dry-run records; write elsewhere")
    cfg = get_config(arch)
    if mode and mode != "dense":
        cfg = cfg.with_attention(mode)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}__{mode or cfg.attention.mode}"
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "skipped": True, "why": why,
               "mesh": "pod2x16x16" if multi_pod else "16x16"}
        print(f"[dryrun] SKIP {tag}: {why}")
    else:
        t0 = time.time()
        rec = dict(trace_cell(arch, shape_name, multi_pod, mode), skipped=False)
        rec["trace_s"] = round(time.time() - t0, 2)
        print(f"[dryrun] OK   {tag}: trace={rec['trace_s']:.1f}s "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"params/dev={rec['param_bytes_per_device']:.3e}B")
    if save:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    return rec


def cells(all_cells: bool, arch: str | None, shape: str | None, mode: str | None) -> list:
    """(arch, shape, mode) to run: with ``all_cells`` every assigned arch on
    every shape, a full-attention arch's long_500k in T3 (retrieval), as
    the reference's rule puts it."""
    if not all_cells:
        if not (arch and shape):
            raise ValueError("--arch and --shape, or --all")
        return [(arch, shape, mode)]
    out = []
    for a in ASSIGNED:
        for s in SHAPES:
            m = mode
            if s == "long_500k" and not get_config(a).sub_quadratic and m is None:
                m = "retrieval"  # the paper's T3 makes the long-context cell runnable
            out.append((a, s, m))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mode", default=None,
                    choices=[None, "dense", "decomposed", "cpq", "retrieval", "decomposed_cpq"])
    ap.add_argument("--all", action="store_true", help="every assigned (arch x shape) cell")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    out = Path(args.out)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures, recs = [], []
    for arch, shape_name, mode in cells(args.all, args.arch, args.shape, args.mode):
        for mp in meshes:
            try:
                recs.append(run_cell(arch, shape_name, mp, mode, out))
            except Exception as e:  # every failing cell is listed, none skipped
                failures.append((arch, shape_name, mp, f"{type(e).__name__}: {str(e)[:200]}"))
                print(f"[dryrun] FAIL {arch}/{shape_name}/mp={mp}: {e}")
    if failures:
        raise SystemExit(f"{len(failures)} dryrun failures: {failures}")
    return recs


if __name__ == "__main__":
    main()
