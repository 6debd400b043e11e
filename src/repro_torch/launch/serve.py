"""Serving driver of the port (the JAX package's ``launch/serve.py``):
batched generation with mode-selectable caches.

On the GPU (the default device), at the published widths:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --continuous --preset latency --batch 8 --prompt 64 --new 32
On the CPU, at a reduced config:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large --smoke \
      --mode decomposed --batch 4 --prompt 64 --new 16 --device cpu

Random weights from ``--seed`` (``params.init_params``: not the reference's
numbers), a ``SyntheticLMData`` batch from the same seed. The static
``ServeEngine`` serves token, ``text+patches`` and ``audio_frames``
configurations; ``--continuous`` serves token prompts on
``ContinuousServeEngine`` (or on a ``ReplicaRouter`` with ``--replicas``),
with ``--preset`` the tuned knobs of the port's presets file
(``src/repro_torch/serving_presets.json``). Prints the decode cache bytes
a token next to throughput. ``--mesh dp,mp`` serves the continuous engine
over a device mesh: every paged arena split over ``mp`` model shards
(``serving/sharded.py``), on distinct visible GPUs, or with ``--device
cpu`` on shards that all share the CPU (the reference's launcher emulates
host devices there):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke \
      --continuous --mesh 1,2 --batch 2 --prompt 24 --new 6 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ServingCfg, ShapeCfg, get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.params import init_params, resolve_device
from repro_torch.serving import ContinuousServeEngine, GenerationConfig, ServeEngine
from repro_torch.serving.paged_cache import pages_needed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", default=None,
                    choices=[None, "dense", "decomposed", "cpq", "retrieval", "decomposed_cpq"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine over paged arenas "
                         "(token prompts only)")
    ap.add_argument("--preset", default=None, metavar="NAME",
                    help="serving preset from the port's auto-tuner's "
                         "materialized Pareto frontier (latency | throughput "
                         "| energy | default; src/repro_torch/"
                         "serving_presets.json). Supplies the tuned knobs "
                         "(policy, page_size, prefill_chunk, num_slots, "
                         "watermarks, speculation); arena capacity is "
                         "re-derived for --prompt/--new. Requires "
                         "--continuous; conflicts with explicit --policy/"
                         "--prefill-chunk/--speculate. Presets are ranked "
                         "on the tuner's tick clock (tokens per engine "
                         "step), not on wall time")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="chunked paged prefill: prompts stream into arena "
                         "pages in chunks of this many tokens, interleaved "
                         "with decode (page-aligned; 0 = one-shot admission)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decoding: draft up to K tokens per row "
                         "by prompt lookup and verify them in one chunked "
                         "paged attend (serving/speculative.py; greedy output "
                         "is identical on/off; requires --continuous and a "
                         "chunked dense/decomposed engine; 0 = off)")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "priority", "slo"],
                    help="scheduler policy (serving/policies.py): fifo = "
                         "arrival order (default), priority = strict "
                         "SloClass levels + aging, slo = TTFT-slack EDF "
                         "admission with T2->dense de-escalation "
                         "(requires --continuous)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind a "
                         "ReplicaRouter (serving/router.py), sharing one "
                         "device weight tree (requires --continuous)")
    ap.add_argument("--placement", default="rr",
                    choices=["rr", "load", "slo"],
                    help="router placement policy: rr = round-robin, load = "
                         "least outstanding tokens, slo = latency-bound "
                         "classes to the freest arena, deadline-free batch "
                         "balanced by outstanding tokens (only with "
                         "--replicas > 1)")
    ap.add_argument("--probe-interval", type=int, default=4,
                    help="router health-probe period in ticks (0 disables "
                         "periodic probing; step() faults still count; "
                         "serving/health.py; with --replicas > 1)")
    ap.add_argument("--auto-drain", action="store_true",
                    help="drain a replica that fails consecutive health "
                         "probes (or crashes in step()) and re-admit it "
                         "after a backoff recovery probe succeeds; its "
                         "in-flight work migrates by recompute replay "
                         "(requires --replicas > 1)")
    ap.add_argument("--deadline-scale", type=float, default=0.0,
                    help="derive per-request tick deadlines from the SLO "
                         "class targets (deadline = scale * (ttft_target + "
                         "max_tokens * itl_target)); blown budgets finish "
                         "with reason 'timeout'; 0 = off (requires "
                         "--continuous)")
    ap.add_argument("--inject-faults", type=int, default=None, metavar="SEED",
                    help="wrap every replica in a deterministic seed-driven "
                         "fault plan (crash / stall / exhaust windows; "
                         "serving/faults.py) to exercise the auto-drain and "
                         "recovery machinery (requires --replicas > 1; "
                         "implies --auto-drain)")
    ap.add_argument("--mesh", default=None, metavar="dp,mp",
                    help="serve over a device mesh: dp-way engine replication"
                         " x mp-way model sharding of the paged arenas "
                         "(kv-head axis; requires --continuous). On distinct "
                         "visible GPUs; with --device cpu the shards share "
                         "the CPU.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain path there)")
    args = ap.parse_args(argv)

    if args.policy != "fifo" and not args.continuous:
        ap.error("--policy requires --continuous (the static engine has no "
                 "admission queue)")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.replicas > 1 and not args.continuous:
        ap.error("--replicas requires --continuous (the router fans out "
                 "over continuous-batching engines)")
    if args.speculate and not args.continuous:
        ap.error("--speculate requires --continuous (drafts alias paged "
                 "arenas and verify through the chunked prefill path)")
    if args.speculate < 0:
        ap.error("--speculate must be >= 0 (0 disables)")
    if args.speculate and args.prefill_chunk == 0:
        ap.error("--speculate requires chunked admission (--prefill-chunk "
                 "> 0): the verify pass is a spec_len+1 wide prefill chunk")
    if args.preset:
        if not args.continuous:
            ap.error("--preset requires --continuous (presets are tuned "
                     "continuous-serving operating points)")
        for flag, dest in (("--policy", "policy"),
                           ("--prefill-chunk", "prefill_chunk"),
                           ("--speculate", "speculate")):
            if getattr(args, dest) != ap.get_default(dest):
                ap.error(f"--preset sets {flag}; drop the explicit flag "
                         "(or drop --preset to hand-tune)")
    if args.deadline_scale and not args.continuous:
        ap.error("--deadline-scale requires --continuous (tick deadlines "
                 "are enforced by the continuous scheduler)")
    if args.deadline_scale < 0:
        ap.error("--deadline-scale must be >= 0")
    if args.auto_drain and args.replicas < 2:
        ap.error("--auto-drain requires --replicas > 1 (the HealthMonitor "
                 "lives in the router)")
    if args.inject_faults is not None and args.replicas < 2:
        ap.error("--inject-faults requires --replicas > 1 (faults exercise "
                 "the router's drain/recovery machinery)")
    mesh = None
    if args.mesh:
        if not args.continuous:
            ap.error("--mesh requires --continuous (paged arenas)")
        from repro_torch.launch.mesh import parse_mesh_arg

        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        mesh = parse_mesh_arg(args.mesh, devices="cpu" if cpu else None)
    device = mesh.devices.reshape(-1)[0] if mesh is not None else resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.mode:
        cfg = cfg.with_attention(args.mode)

    params = init_params(cfg, args.seed, device)
    shape = ShapeCfg("serve", args.prompt, args.batch, "prefill")
    batch = SyntheticLMData(cfg, shape, DataConfig(seed=args.seed)).batch(0)
    batch.pop("labels")

    if args.continuous:
        n_max = args.prompt + args.new
        if args.preset:
            # tuned knobs from the materialized frontier; capacity re-derived
            # for THIS context ceiling (the tuner sized its arena for the
            # smoke trace, not for --prompt/--new)
            base = ServingCfg.from_preset(args.preset)
            serving = ServingCfg.from_preset(
                args.preset,
                num_pages=base.num_slots * pages_needed(n_max, base.page_size) + 1,
                max_blocks_per_slot=pages_needed(n_max, base.page_size),
                prefill_bucket=base.prefill_chunk or base.page_size,
                probe_interval=args.probe_interval,
                auto_drain=args.auto_drain or args.inject_faults is not None,
                deadline_scale=args.deadline_scale)
            print(f"[serve] preset={args.preset}: policy={serving.policy} "
                  f"page_size={serving.page_size} "
                  f"prefill_chunk={serving.prefill_chunk} "
                  f"num_slots={serving.num_slots} "
                  f"spec_len={serving.spec_len}")
        else:
            serving = ServingCfg(
                num_slots=args.batch, page_size=16,
                num_pages=args.batch * pages_needed(n_max, 16) + 1,
                max_blocks_per_slot=pages_needed(n_max, 16), prefill_bucket=16,
                prefill_chunk=args.prefill_chunk, policy=args.policy,
                probe_interval=args.probe_interval,
                auto_drain=args.auto_drain or args.inject_faults is not None,
                deadline_scale=args.deadline_scale, spec_len=args.speculate)
        if args.replicas > 1:
            from repro_torch.serving import ReplicaRouter

            plans = None
            if args.inject_faults is not None:
                from repro_torch.serving.faults import FaultPlan

                plans = [FaultPlan.random(args.inject_faults + i,
                                          horizon=4 * args.new, n_events=2)
                         for i in range(args.replicas)]
            eng = ReplicaRouter(cfg, params, num_replicas=args.replicas,
                                serving=serving, placement=args.placement,
                                mesh=mesh, fault_plans=plans, device=device)
            print(f"[serve] router: {args.replicas} replicas, "
                  f"placement={args.placement} "
                  f"({args.replicas * args.batch} slots aggregate)")
            if plans is not None:
                events = "; ".join(
                    f"r{i}:" + ",".join(f"{e.kind}@{e.tick}x{e.duration}"
                                        for e in p.events)
                    for i, p in enumerate(plans))
                print(f"[serve] fault injection seed={args.inject_faults}: "
                      f"{events} (auto-drain on)")
        else:
            eng = ContinuousServeEngine(cfg, params, serving=serving, mesh=mesh,
                                        device=device)
        print(f"[serve] policy={serving.policy}; chunked prefill: "
              f"{'on, chunk=' + str(serving.prefill_chunk) if eng.chunked else 'off (one-shot admission)'}")
        if serving.spec_len:
            on = getattr(eng, "spec_on",
                         args.replicas > 1)  # router: per-replica gate
            print(f"[serve] speculative decoding: "
                  f"{f'on, k={serving.spec_len} (prompt lookup)' if on else 'requested but gated off (needs chunked dense/decomposed)'}")
        if mesh is not None:
            print(f"[serve] mesh: data={mesh.shape['data']} "
                  f"model={mesh.shape['model']} "
                  f"(arenas sharded over the kv-head axis)")
    else:
        eng = ServeEngine(cfg, params, max_len=args.prompt + args.new, device=device)
    gen = GenerationConfig(max_new_tokens=args.new, temperature=args.temperature,
                           seed=args.seed)
    t0 = time.time()
    out, stats = eng.generate(batch, gen)  # numpy on the host: the device has finished
    dt = time.time() - t0

    from repro_torch.models.attention_layer import decoupled_rope_dims
    mode = cfg.attention.mode
    if mode == "dense":
        bpt = 2.0 * cfg.num_kv_heads * cfg.head_dim * 2
    elif mode == "decomposed":
        bpt = (cfg.d_model + cfg.num_kv_heads * decoupled_rope_dims(cfg)) * 2.0
    elif mode == "cpq":
        from repro_torch.core.cpq import cpq_bytes_per_token
        bpt = 2 * cpq_bytes_per_token(cfg.attention.cpq, cfg.num_kv_heads, cfg.head_dim)
    elif mode == "decomposed_cpq":  # T1+T2: CPQ codes over the X cache
        from repro_torch.core.cpq import cpq_bytes_per_token
        bpt = (cpq_bytes_per_token(cfg.attention.cpq, 1, cfg.d_model)
               + cfg.num_kv_heads * decoupled_rope_dims(cfg) * 2.0)
    else:  # retrieval: dense cache + proxy codes; V reads drop to top_k
        bpt = 2.0 * cfg.num_kv_heads * cfg.head_dim * 2 + cfg.num_kv_heads * cfg.head_dim

    if args.continuous and mesh is not None:
        print(f"[serve] arena: {stats['arena_bytes_per_device'] / 2**20:.2f} "
              f"MiB/device of {stats['arena_bytes_total'] / 2**20:.2f} MiB "
              f"total; interconnect "
              f"{stats['interconnect_bytes_per_token']:.1f} B/token "
              "(per-head partial concat + latent pool gathers)")
    if args.replicas > 1:
        rows = ", ".join(
            f"r{p['replica']}: {p['generated_tokens']} tok @ "
            f"{p['tokens_per_step']:.2f}/step"
            for p in stats["per_replica"])
        print(f"[serve] router aggregate: "
              f"{stats['tokens_per_step']:.2f} tok/step over "
              f"{stats['decode_steps_max']} lockstep ticks ({rows})")
    print(f"[serve] arch={cfg.name} mode={mode}")
    print(f"[serve] generated {out.shape} in {dt:.2f}s "
          f"({out.size / max(dt, 1e-9):.1f} tok/s batch-aggregate)")
    print(f"[serve] decode cache traffic: {bpt:.1f} B/token/layer "
          f"({cfg.num_layers * bpt / 1024:.1f} KiB/token end-to-end)")
    print(f"[serve] sample row: {out[0][:16].tolist()}")
    return out


if __name__ == "__main__":
    main()
