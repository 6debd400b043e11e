"""Serving auto-tuner CLI of the port (the JAX package's ``launch/tune.py``):
evolutionary Pareto search over ``ServingCfg``.

  PYTHONPATH=src python -m repro_torch.launch.tune --budget 24 --seed 0 --smoke

Runs the seeded μ+λ search (``repro_torch.tuning``) against the port's
``ContinuousServeEngine`` on a fixed seeded mixed-SLO-class trace (the
smoke model; on the GPU unless ``--device`` names another device, ``cpu``
for the plain path), prints the non-dominated frontier, and materializes
it into named presets (``latency`` / ``throughput`` / ``energy`` /
``default``) at ``--out`` (default: the port's packaged
``src/repro_torch/serving_presets.json`` that ``ServingCfg.from_preset``
and ``python -m repro_torch.launch.serve --preset`` load). The energy axis
is priced on the H100's device record (``tuning/energy.py``); the
document's ``trace`` provenance names that record, the device the engine
ran on and, on a GPU, the card's name and power limit.

``--smoke`` additionally asserts the acceptance contract: the frontier is
non-dominated with >= 2 distinct points, every named preset is no worse
than the hand-tuned default on its own objective axis, and a second
same-seed search (evaluations memoized from the first — the loop logic
re-runs, the engine does not) reproduces the identical frontier.

``--checkpoint PATH`` saves the evaluated points + RNG state after every
evaluation; re-running with the same arguments resumes bit-identically.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time


def _card(device) -> str:
    """The card's name and power limit as nvidia-smi reports them (the
    provenance of the energy axis); the device type off the GPU."""
    if device.type != "cuda":
        return device.type
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        import torch

        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def _fmt_genome(genome: dict) -> str:
    return " ".join(f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in genome.items())


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="evolutionary Pareto auto-tuner for the serving config")
    ap.add_argument("--budget", type=int, default=24,
                    help="total engine evaluations (default 24)")
    ap.add_argument("--seed", type=int, default=0,
                    help="search seed: proposals AND the trace derive from "
                         "it; same seed => identical frontier")
    ap.add_argument("--smoke", action="store_true",
                    help="assert the acceptance contract (non-dominated "
                         "frontier, >= 2 distinct points, presets no worse "
                         "than the hand-tuned default on their own axis, "
                         "same-seed reproducibility)")
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    help="architecture searched (always smoke-sized: the "
                         "tuner measures SCHEDULING, and the energy axis "
                         "prices it at paper scale)")
    ap.add_argument("--requests", type=int, default=12,
                    help="trace length in requests (default 12)")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="trace mean arrival rate, requests per tick")
    ap.add_argument("--trace", default="slo", choices=["slo", "mixed"],
                    help="workload: 'slo' = mixed interactive/batch classes "
                         "(per-class tail objectives), 'mixed' = plain "
                         "Poisson heavy-tailed")
    ap.add_argument("--mu", type=int, default=6,
                    help="parent population size (default 6)")
    ap.add_argument("--lam", type=int, default=6,
                    help="offspring per generation (default 6)")
    ap.add_argument("--mutate-p", type=float, default=0.35)
    ap.add_argument("--crossover-p", type=float, default=0.5)
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="JSON checkpoint of evaluated points + RNG state, "
                         "written after every evaluation; an existing file "
                         "is resumed bit-identically")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="presets JSON output (default: the port's packaged "
                         "src/repro_torch/serving_presets.json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain path there)")
    args = ap.parse_args(argv)
    if args.budget < 1:
        ap.error("--budget must be >= 1")

    from repro_torch.configs import ARCHS, ServingCfg, smoke_config
    from repro_torch.params import init_params, resolve_device
    from repro_torch.tuning import (ParetoSearch, ServingObjective, TraceSpec,
                                    materialize, pareto_front, write_presets)

    device = resolve_device(args.device)
    t0 = time.time()
    cfg = smoke_config(ARCHS[args.arch])
    params = init_params(cfg, 0, device)
    trace = TraceSpec(kind=args.trace, seed=args.seed,
                      n_requests=args.requests, rate=args.rate)
    objective = ServingObjective(cfg, params, trace, device=device)
    space = objective.space

    evals = {"n": 0}

    def evaluate(genome):
        objectives, metrics = objective(genome)
        evals["n"] += 1
        print(f"[tune] eval {evals['n']:>3}  "
              f"obj=({objectives[0]:.3f}, {objectives[1]:.2f}, "
              f"{objectives[2]:.3f})  {_fmt_genome(genome)}")
        return objectives, metrics

    search = ParetoSearch(space, evaluate, seed=args.seed, mu=args.mu,
                          lam=args.lam, mutate_p=args.mutate_p,
                          crossover_p=args.crossover_p,
                          checkpoint=args.checkpoint)
    resumed = len(search.records)
    if resumed:
        print(f"[tune] resumed {resumed} evaluated points from "
              f"{args.checkpoint}")
    front = search.run(args.budget)
    base = search.baseline()

    print(f"[tune] frontier ({len(front)} points; "
          f"hypervolume={search.frontier_hypervolume():.4f}; "
          f"{len(search.records)} evals, {evals['n']} engine runs):")
    for r in front:
        print(f"[tune]   tok/step={-r.objectives[0]:.3f} "
              f"ttft_p95={r.objectives[1]:.2f} "
              f"mJ/tok={r.objectives[2]:.3f}  {_fmt_genome(r.genome)}")
    print(f"[tune] baseline (hand-tuned default): "
          f"tok/step={-base.objectives[0]:.3f} "
          f"ttft_p95={base.objectives[1]:.2f} "
          f"mJ/tok={base.objectives[2]:.3f}")

    doc = materialize(search, trace={
        "kind": trace.kind, "seed": trace.seed,
        "n_requests": trace.n_requests, "rate": trace.rate,
        "arch": args.arch, "smoke_model": True,
        "max_len": space.max_len,
        "device_model": objective.device_model.name,
        "device_model_power_w": objective.device_model.power_w,
        "device": device.type, "card": _card(device)})
    out_path = args.out or ServingCfg.preset_path()
    write_presets(out_path, doc)
    for name in sorted(doc["presets"]):
        p = doc["presets"][name]
        print(f"[tune] preset {name:<10} "
              f"tok/step={-p['objectives']['throughput']:.3f} "
              f"ttft_p95={p['objectives']['latency']:.2f} "
              f"mJ/tok={p['objectives']['energy']:.3f}")
    print(f"[tune] wrote {len(doc['presets'])} presets "
          f"({len(front)}-point frontier) to {out_path} "
          f"in {time.time() - t0:.1f}s")

    if args.smoke:
        objs = [r.objectives for r in front]
        assert len(pareto_front(objs)) == len(objs), (
            "frontier contains dominated points")
        assert len(set(objs)) >= 2, (
            f"frontier has {len(set(objs))} distinct objective vectors "
            "(need >= 2: the trace exposes no knob tradeoff)")
        assert len(doc["presets"]) >= 3, "fewer than 3 named presets"
        for axis, name in enumerate(("throughput", "latency", "energy")):
            got = doc["presets"][name]["objectives"][name]
            ref = base.objectives[axis]
            assert got <= ref + 1e-12, (
                f"preset {name} ({got}) worse than the hand-tuned default "
                f"({ref}) on its own objective")
        # same-seed reproducibility: re-run the ENTIRE search loop (fresh
        # RNG, fresh population state) with evaluations memoized from the
        # first pass — engine results are deterministic for a genome, so
        # this verifies the loop replays the identical proposal sequence
        memo = {space.genome_key(r.genome): (r.objectives, r.metrics)
                for r in search.records}

        def replay(genome):
            return memo[space.genome_key(genome)]

        search2 = ParetoSearch(space, replay, seed=args.seed, mu=args.mu,
                               lam=args.lam, mutate_p=args.mutate_p,
                               crossover_p=args.crossover_p)
        front2 = search2.run(args.budget)
        assert [space.genome_key(r.genome) for r in search2.records] == \
            [space.genome_key(r.genome) for r in search.records], (
            "same-seed search proposed a different evaluation sequence")
        assert [r.objectives for r in front2] == [r.objectives
                                                  for r in front], (
            "same-seed search produced a different frontier")
        print(f"[tune] smoke PASS: non-dominated frontier "
              f"({len(set(objs))} distinct points), "
              f"{len(doc['presets'])} presets each >= default on its axis, "
              "same-seed frontier reproduced exactly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
