"""Device time per tick of the port's continuous engine on one NVIDIA GPU:
full-width qwen1.5-0.5b in bf16 (random weights from seed 0) serving
chip_smoke.py's traffic (8 greedy requests arriving at once, prompts of
64-512 tokens, 64 new tokens each; 8 slots, pages of 16, chunks of 16),
profiled with torch.profiler over a window of ticks.

    PYTHONPATH=src python benchmarks/torch_tick_profile.py --mode decomposed --ticks 40 45

With PYTHONPATH at another checkout's ``src`` it profiles that checkout
(it uses only the engine's public surface). Prints one JSON object: the
window, the card, device ms per tick, the attention kernels' share of it
and the kernels that took the most device time.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

# the namespaces of the port's attention kernels, as a profile names them
ATTENTION = ("paged_attn", "paged_chunk", "cpq_attn", "decomposed_attn", "decomposed_chunk",
             "topk_retrieval", "flash_prompt", "single_query")


def requests(T, vocab: int):
    """chip_smoke.py's traffic."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=8)
    lens[0], lens[1] = 64, 512
    return [T.Request(rid=i, prompt=rng.integers(0, vocab, size=int(n)).astype(np.int32),
                      max_new_tokens=64) for i, n in enumerate(lens)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="decomposed", help="dense, cpq, decomposed")
    ap.add_argument("--ticks", type=int, nargs=2, default=(40, 45), metavar=("LO", "HI"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_tick_profile: needs an NVIDIA GPU")
    import repro_torch as T
    from repro_torch.params import init_params
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = T.ARCHS["qwen1.5-0.5b"]
    eng = T.ContinuousServeEngine(
        cfg, init_params(cfg, 0, "cuda"), rt=T.AttentionRuntime(mode=args.mode),
        serving=T.ServingCfg(num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64),
        device="cuda")
    eng.reset(T.GenerationConfig())
    for r in requests(T, cfg.vocab_size):
        eng.add_request(r)
    lo, hi = args.ticks
    for _ in range(lo):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(hi - lo):
            eng.step()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
                     key=lambda k: -k[1])
    busy = sum(ms for _, ms, _ in kernels)
    attn = sum(ms for k, ms, _ in kernels if any(a in k for a in ATTENTION))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"mode": args.mode, "ticks": [lo, hi], "card": card.splitlines()[0],
                      "device_ms_per_tick": busy / (hi - lo),
                      "attention_ms_per_tick": attn / (hi - lo),
                      "top_kernels": [{"name": k[:90], "ms": ms, "count": n}
                                      for k, ms, n in kernels[:6]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
