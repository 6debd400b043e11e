"""Device time per tick of the port's continuous engine on one NVIDIA GPU:
full-width qwen1.5-0.5b in bf16 (random weights from seed 0) serving
chip_smoke.py's traffic (8 greedy requests arriving at once, prompts of
64-512 tokens, 64 new tokens each; 8 slots, pages of 16, chunks of 16),
profiled with torch.profiler over a window of ticks. With ``--static``,
per decode step of the static ServeEngine on chip_smoke.py's static
traffic (8 prompts of 512 seeded tokens, 64 new tokens) instead.

    PYTHONPATH=src python benchmarks/torch_tick_profile.py --mode decomposed --ticks 40 45
    PYTHONPATH=src python benchmarks/torch_tick_profile.py --static --mode decomposed --ticks 30 40

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
ATTENTION = ("paged_attn", "paged_chunk", "paged_token", "cpq_attn", "decomposed_attn",
             "decomposed_chunk", "t1_token", "topk_retrieval", "flash_prompt", "single_query")


def requests(T, vocab: int):
    """chip_smoke.py's traffic."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=8)
    lens[0], lens[1] = 64, 512
    return [T.Request(rid=i, prompt=rng.integers(0, vocab, size=int(n)).astype(np.int32),
                      max_new_tokens=64) for i, n in enumerate(lens)]


def static_window(T, cfg, params, rt, prof, lo: int, hi: int) -> None:
    """Serve chip_smoke.py's static traffic, ``prof`` around decode steps
    lo .. hi - 1."""
    from repro_torch.models import model as M

    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(8, 512)).astype(np.int32)
    eng, dec, calls = T.ServeEngine(cfg, params, rt=rt, device="cuda"), M.decode_step, [0]

    def step(*a, **kw):
        if calls[0] == lo:
            torch.cuda.synchronize()
            prof.__enter__()
        out = dec(*a, **kw)
        calls[0] += 1
        if calls[0] == hi:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        return out

    M.decode_step = step
    try:
        eng.generate({"tokens": prompts}, T.GenerationConfig(max_new_tokens=64))
    finally:
        M.decode_step = dec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="decomposed", help="dense, cpq, decomposed")
    ap.add_argument("--ticks", type=int, nargs=2, default=(40, 45), metavar=("LO", "HI"))
    ap.add_argument("--static", action="store_true",
                    help="profile decode steps of the static engine instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_tick_profile: needs an NVIDIA GPU")
    import repro_torch as T
    from repro_torch.params import init_params
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = T.ARCHS["qwen1.5-0.5b"]
    params, rt = init_params(cfg, 0, "cuda"), T.AttentionRuntime(mode=args.mode)
    lo, hi = args.ticks
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if args.static:
        static_window(T, cfg, params, rt, prof, lo, hi)
    else:
        eng = T.ContinuousServeEngine(
            cfg, params, rt=rt, serving=T.ServingCfg(num_slots=8, page_size=16, num_pages=513,
                                                     max_blocks_per_slot=64), device="cuda")
        eng.reset(T.GenerationConfig())
        for r in requests(T, cfg.vocab_size):
            eng.add_request(r)
        for _ in range(lo):
            eng.step()
        torch.cuda.synchronize()
        with prof:
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
    print(json.dumps({"mode": args.mode, "static": args.static, "ticks": [lo, hi],
                      "card": card.splitlines()[0],
                      "device_ms_per_tick": busy / (hi - lo),
                      "attention_ms_per_tick": attn / (hi - lo),
                      "top_kernels": [{"name": k[:90], "ms": ms, "count": n}
                                      for k, ms, n in kernels[:6]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
