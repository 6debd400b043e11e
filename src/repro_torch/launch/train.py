"""Training driver of the port (the JAX package's ``launch/train.py``).

On the GPU (the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 12 --batch 4 --seq 2048 --remat
On the CPU, at a reduced config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \
      --steps 50 --batch 8 --seq 128 --device cpu

Random weights from ``--seed`` (``params.init_params``: not the reference's
numbers), ``SyntheticLMData`` batches from the same seed, AdamW or Adafactor
on ``cosine_schedule``. Fault tolerance as in the reference: it resumes
from the newest complete checkpoint in ``--ckpt-dir`` (the parameters in
the reference's stacked layout beside the optimizer state, so either
package restores it), saves asynchronously every ``--ckpt-every`` steps
and once at the end, replays the batch sequence exactly (the data is a pure
function of the step) and appends its ``[train]`` records to
``<ckpt-dir>/metrics.jsonl``.

``--mesh single|multi`` trains over ``make_production_mesh`` ((16, 16)
data x model, or (2, 16, 16) pod x data x model) through
``train/sharded.py``: parameters and optimizer state split by their fitted
specs (FSDP over data, and pod, storage over model), the step ZeRO-3 over
the data replicas. A device given with ``--device`` stands for every
position of the grid (the CPU tests and one card run the 256 or 512
shards so); without it the visible CUDA devices are used, each once, and
too few are refused with the count. Checkpoints are saved gathered, in the
reference's layout, so a mesh run resumes an unsharded run's checkpoint
and the reverse.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import CheckpointManager, split_train_state, train_state
from repro_torch.configs import ShapeCfg, get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.optim import adafactor, adamw, cosine_schedule
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.params import init_params, resolve_device
from repro_torch.train.sharded import (gather_params, gather_tree, init_sharded,
                                       make_mesh_train_step)
from repro_torch.train.step import TrainStepCfg, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", choices=["adamw", "adafactor"], default="adamw")
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", action="store_true", default=False)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain path there)")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh != "none":
        mesh = make_production_mesh(args.mesh == "multi", args.device)
        device = mesh.devices.reshape(-1)[0]
    else:
        device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    shape = ShapeCfg("train", args.seq, args.batch, "train")
    lr = cosine_schedule(args.lr, args.warmup, args.steps)
    opt = adamw(lr) if args.optimizer == "adamw" else adafactor(lr)
    tcfg = TrainStepCfg(microbatches=args.microbatches, remat=args.remat)
    data = SyntheticLMData(cfg, shape, DataConfig(seed=args.seed))
    params = init_params(cfg, args.seed, device)
    opt_state = opt.init(params)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        params, opt_state = split_train_state(
            ckpt.restore(start, train_state(params, opt_state)))
        print(f"[train] resumed from step {start}")
    if mesh is None:
        step_fn = make_train_step(cfg, opt, tcfg)
        whole = lambda p, s: (p, s)  # noqa: E731
    else:
        params, opt_state = init_sharded(cfg, opt, params, mesh, state=opt_state)
        step_fn = make_mesh_train_step(cfg, opt, tcfg, mesh)
        print(f"[train] mesh: {' '.join(f'{a}={n}' for a, n in mesh.shape.items())} over "
              f"{len(set(str(d) for d in mesh.devices.reshape(-1)))} device(s)")

        def whole(p, s):  # the gathered trees, for a checkpoint
            return gather_params(p, device), gather_tree(s, device)

    log_path = Path(args.ckpt_dir) / "metrics.jsonl" if args.ckpt_dir else None
    it = data.iter_from(start)
    metrics = None
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
            params, opt_state, metrics = step_fn(params, opt_state, step, batch)
            if (step + 1) % args.log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                rec = {"step": step + 1, **m, "elapsed_s": round(time.time() - t0, 2)}
                print(f"[train] {rec}")
                if log_path:
                    with open(log_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save_async(step + 1, train_state(*whole(params, opt_state)))
        if ckpt:
            ckpt.save(args.steps, train_state(*whole(params, opt_state)))
    finally:
        it.close()
        if ckpt:
            ckpt.close()
    if metrics is None:
        print(f"[train] done: nothing to run (resumed at step {start} of {args.steps})")
        return None
    final_loss = float(metrics["loss"])
    print(f"[train] done: {args.steps} steps, final loss {final_loss:.4f}")
    return final_loss


if __name__ == "__main__":
    main()
