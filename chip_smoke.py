"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Phases, each of which fails the run (nonzero exit) on a miss:
  1. device   needs CUDA; prints the card's name and power limit
  2. build    compiles the port's CUDA kernels with nvcc from the checkout
  3. kernels  B1 paged_decode and B2 paged_prefill against their plain
              PyTorch versions, bf16 and f32, on the layouts of the CPU tests
              (permuted pages, a poisoned null page, ragged and empty rows,
              partial last pages), at qwen1.5-0.5b's shape (KV=16, G=1,
              Dh=64, page 16) and at a GQA shape (KV=8, G=4, Dh=128)
  4. serve    full-width qwen1.5-0.5b (24 layers, vocab 151936, random
              weights from a seed) in bf16 through ContinuousServeEngine:
              8 greedy requests, prompts of 64-512 tokens, 64 new tokens
              each; both kernels must have launched. Then times each kernel
              at the shapes that run gave it, beside its bound, its plain
              version and one PyTorch library call (a yardstick only)
  5. parity   the same requests in f32 (TF32 off) with the paged kernels on
              and off: prefill and first-decode logits within 1e-3, greedy
              streams identical except where the plain path's top-2 logit
              gap is below 1e-4

The last line is {"ok": true, "device": {...}}; the line before it lists
every kernel with its launches, error and times.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}  # kernel vs plain, max abs
LOGIT_TOL = 1e-3            # f32 logits, kernels vs gather path (atol = rtol)
ARGMAX_GAP = 1e-4           # top-2 gap below which a greedy tie is excused
SEED = 0
DEVICE = "cuda"
T0 = 0.0                    # start of the run, for phase timestamps


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one ``fn()`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------- phase 3: sweeps


def layout(rng, B, nb, page):
    """Ragged lengths (an empty row, partial last pages) over permuted
    physical pages; unmapped entries stay at the null page 0."""
    num_pages = 1 + B * nb + 3
    lengths = rng.integers(0, nb * page + 1, size=B).astype(np.int32)
    lengths[0] = 0
    lengths[-1] = nb * page - page // 2        # long row, partial last page
    perm = list(rng.permutation(np.arange(1, num_pages)))
    bt = np.zeros((B, nb), np.int32)
    for b in range(B):
        for j in range(-(-int(lengths[b]) // page)):
            bt[b, j] = perm.pop()
    return num_pages, lengths, bt


def sweep(ops, dtype, KV, G, Dh, page=16, nb=64, B=8, C=16):
    """Max abs error of B1 and B2 against their plain versions."""
    rng = np.random.default_rng(SEED)
    dev = DEVICE
    num_pages, lengths, bt = layout(rng, B, nb, page)
    kp = torch.randn(num_pages, page, KV, Dh, device=dev).to(dtype)
    vp = torch.randn(num_pages, page, KV, Dh, device=dev).to(dtype)
    kp[0] = vp[0] = 1e3                          # poisoned null page
    q = torch.randn(B, 1, KV * G, Dh, device=dev).to(dtype)
    bt_t = torch.tensor(bt, device=dev)
    len_t = torch.tensor(lengths, device=dev)
    scale = Dh ** -0.5
    out = ops.paged_decode(q, kp, vp, bt_t, len_t, scale)
    torch.cuda.synchronize()
    ref = ops.paged_decode_plain(q, kp, vp, bt_t, len_t, scale)
    err_dec = (out.float() - ref.float()).abs().max().item()
    check(not out[0].any().item(), "paged_decode: an empty row is not zero")
    err_pre = 0.0
    row = bt_t[-1]                               # the long row's pages
    for offset, valid in ((0, C), (C, 5), (512, C), (int(lengths[-1]) - 3, 3)):
        qc = torch.randn(1, C, KV * G, Dh, device=dev).to(dtype)
        o = ops.paged_prefill(qc, kp, vp, row, offset, valid, scale)
        torch.cuda.synchronize()
        r = ops.paged_prefill_plain(qc, kp, vp, row, offset, valid, scale)
        err_pre = max(err_pre, (o[0, :valid].float() - r[0, :valid].float()).abs().max().item())
    return err_dec, err_pre


# --------------------------------------------------------- phase 4: serve


class Recorder:
    """Wraps a kernel wrapper: passes every call through, keeps the arenas of
    the first ``n_layers`` calls (one per layer) and a sample of the calls'
    small inputs, so the kernel can be timed later at the served shapes."""

    def __init__(self, fn, n_layers: int, every: int, snap):
        self.fn, self.n_layers, self.every, self.snap = fn, n_layers, every, snap
        self.calls, self.arenas, self.samples = 0, [], []

    # the wrapper counts its launches through its module-level name, which
    # is this recorder while it is installed: keep the count on the wrapper
    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n

    def __call__(self, q, k_pages, v_pages, *rest):
        if len(self.arenas) < self.n_layers:
            self.arenas.append((k_pages, v_pages))
        if self.calls % (self.n_layers * self.every) == 0:
            self.samples.append((q.clone(),) + self.snap(*rest))
        self.calls += 1
        return self.fn(q, k_pages, v_pages, *rest)


def served_config(T):
    """Full-width qwen1.5-0.5b: 24 layers, d_model 1024, vocab 151936."""
    cfg = T.ARCHS["qwen1.5-0.5b"]
    check(cfg.num_layers == 24 and cfg.vocab_size == 151936, "not the full config")
    return cfg


def make_requests(T, vocab: int):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 513, size=8)
    lens[0], lens[1] = 64, 512
    return [T.Request(rid=i, prompt=rng.integers(0, vocab, size=int(n)).astype(np.int32),
                      max_new_tokens=64) for i, n in enumerate(lens)]


def serve_timed(eng, T, reqs):
    """Drive the engine tick by tick, a device sync around each tick.
    Returns (results, stats, ticks, wall s); a tick is (ms, rows decoded,
    ran a prompt chunk, ran the decode step)."""
    eng.reset(T.GenerationConfig())
    for r in reqs:
        eng.add_request(r)
    ticks = []
    t_all = time.perf_counter()
    while eng.has_unfinished():
        before = eng.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = eng.stats()
        rows = after["generated_tokens"] - before["generated_tokens"]
        chunk = after["prefill_chunks"] > before["prefill_chunks"]
        decoded = after["decode_steps"] > before["decode_steps"]
        ticks.append((ms, rows if decoded else 0, chunk, decoded))
    wall = time.perf_counter() - t_all
    return eng.results(), eng.stats(), ticks, wall


def decode_bound(q, bt, lengths, Dh, Dv, KV, elt):
    """(bytes, flops) one B1 call needs: the live K/V, q and out once each,
    the block table and lengths."""
    live = lengths.long().sum().item()
    nbytes = (live * KV * (Dh + Dv) * elt + q.numel() * elt * (1 + Dv / Dh)
              + bt.numel() * 4 + lengths.numel() * 4)
    flops = 2.0 * live * q.shape[2] * (Dh + Dv)
    return nbytes, flops


def prefill_bound(q, offset, valid, Dh, Dv, KV, elt, page):
    """(bytes, flops) one B2 call needs: the slot's live K/V, q and out
    once each, the mapped block-table entries; flops of the valid rows."""
    H = q.shape[2]
    live = offset + valid
    pairs = sum(offset + i + 1 for i in range(valid))
    nbytes = (live * KV * (Dh + Dv) * elt + q.numel() * elt * (1 + Dv / Dh)
              + -(-live // page) * 4)
    flops = 2.0 * pairs * H * (Dh + Dv)
    return nbytes, flops


def bound_of(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(fn, reps: int = 10) -> float:
    """Device time of one ``fn()``: replays of a CUDA graph that captured it,
    so host launch overhead stays out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def time_kernel(rec, make) -> dict:
    """Mean per-launch times of one kernel over the calls sampled from the
    served run. Each sampled call is replayed over every layer's arena in
    turn, as the model runs it (the next layer's pages are cold in L2):
    ``ms`` from a CUDA graph of those launches (device time), ``eager_ms``
    launched from Python as the engine does (host launch cost included).
    ``make(sample, k0, v0)`` returns (kernel(k, v), plain(), library(),
    (bytes, flops)) for one sample; plain and library run on layer 0."""
    rows = []
    for sample in rec.samples:
        kern, plain, lib, need = make(sample, *rec.arenas[0])

        def layers():
            for k, v in rec.arenas:
                kern(k, v)

        n = len(rec.arenas)
        rows.append((graph_ms(layers) / n, cuda_ms(layers, 3) / n, graph_ms(plain),
                     graph_ms(lib)) + bound_of(*need, sample[0].dtype))
    ms, eager, plain, lib, bound, kinds = zip(*rows)
    return dict(ms=float(np.mean(ms)), eager_ms=float(np.mean(eager)),
                plain_ms=float(np.mean(plain)), library_ms=float(np.mean(lib)),
                bound_ms=float(np.mean(bound)),
                bound_by="bytes" if set(kinds) == {"bytes"} else "operations",
                samples=len(rows))


def decode_case(ops, scale):
    """B1 at one sampled decode call; the yardstick is
    scaled_dot_product_attention on the gathered K/V under a length mask."""
    from repro_torch.serving.paged_cache import gather_pages

    def make(sample, k0, v0):
        q, bt, lengths = sample
        KV, Dh, Dv, H = k0.shape[2], k0.shape[3], v0.shape[3], q.shape[2]
        kg = gather_pages(k0, bt).transpose(1, 2)           # (B, KV, N, Dh)
        vg = gather_pages(v0, bt).transpose(1, 2)
        mask = (torch.arange(kg.shape[2], device=q.device)[None, :]
                < lengths[:, None])[:, None, None, :]
        qq = q.transpose(1, 2)
        gqa = {"enable_gqa": True} if H != KV else {}
        return (lambda k, v: ops.paged_decode(q, k, v, bt, lengths, scale),
                lambda: ops.paged_decode_plain(q, k0, v0, bt, lengths, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kg, vg, attn_mask=mask, scale=scale, **gqa),
                decode_bound(q, bt, lengths, Dh, Dv, KV, q.element_size()))
    return make


def prefill_case(ops, scale):
    """B2 at one sampled chunk call; the yardstick is
    scaled_dot_product_attention on the slot's gathered K/V, causal mask."""
    from repro_torch.serving.paged_cache import gather_pages

    def make(sample, k0, v0):
        q, row, offset, valid = sample
        KV, Dh, Dv, C, H = k0.shape[2], k0.shape[3], v0.shape[3], q.shape[1], q.shape[2]
        n = offset + valid
        kg = gather_pages(k0, row[None])[:, :n].transpose(1, 2)   # (1, KV, n, Dh)
        vg = gather_pages(v0, row[None])[:, :n].transpose(1, 2)
        pos = torch.arange(n, device=q.device)
        mask = (pos[None, :] <= offset + torch.arange(C, device=q.device)[:, None])
        qq = q.transpose(1, 2)
        gqa = {"enable_gqa": True} if H != KV else {}
        return (lambda k, v: ops.paged_prefill(q, k, v, row, offset, valid, scale),
                lambda: ops.paged_prefill_plain(q, k0, v0, row, offset, valid, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kg, vg, attn_mask=mask[None, None], scale=scale, **gqa),
                prefill_bound(q, offset, valid, Dh, Dv, KV, q.element_size(),
                              k0.shape[1]))
    return make


def profile_windows(make_engine, T, reqs, ticks, windows) -> list[dict]:
    """Replays the same serve (greedy, so tick i does the same work) and
    profiles the given tick windows with torch.profiler: device time by
    kernel, and the device's busy share of those ticks' unprofiled wall
    time (taken from ``ticks`` of the measured run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = make_engine()
    eng.reset(T.GenerationConfig())
    for r in reqs:
        eng.add_request(r)
    done = 0

    def run_to(n):
        nonlocal done
        while done < n and eng.has_unfinished():
            eng.step()
            done += 1

    out = []
    for lo, hi in windows:
        run_to(lo)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_to(hi)
            torch.cuda.synchronize()
        kernels = sorted(((e.key, e.device_time_total / 1e3, e.count)
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
                         key=lambda r: -r[1])
        busy = sum(ms for _, ms, _ in kernels)
        wall = sum(t[0] for t in ticks[lo:hi])
        attn = sum(ms for k, ms, _ in kernels if "paged_attn" in k)
        gemm = sum(ms for k, ms, _ in kernels if any(g in k for g in ("gemm", "nvjet", "cutlass", "xmma")))
        out.append({"ticks": [lo, hi], "decode_only_ticks": sum(1 for t in ticks[lo:hi] if not t[2]),
                    "device_busy_ms": busy, "unprofiled_wall_ms": wall,
                    "busy_share": busy / wall, "paged_attn_ms": attn, "gemm_ms": gemm,
                    "top_kernels": [{"name": k, "ms": ms, "count": n}
                                    for k, ms, n in kernels[:12]]})
    run_to(10 ** 9)
    return out


# -------------------------------------------------------- phase 5: parity


def chunk_logits(M, cfg, rt, params, ctx, serving, caches, slot_row):
    """Stream ``ctx`` through prefill_chunk_rows; returns the final chunk's
    logits (1, V)."""
    C = serving.prefill_chunk
    logits = None
    for off in range(0, len(ctx), C):
        valid = min(C, len(ctx) - off)
        chunk = np.concatenate([ctx[off:off + valid],
                                np.full(C - valid, ctx[off + valid - 1], np.int32)])
        logits, _ = M.prefill_chunk_rows(cfg, rt, params,
                                         torch.tensor(chunk[None], device=DEVICE),
                                         slot_row, off, valid, caches)
    return logits


def parity(T, M, cfg, params, reqs):
    from repro_torch.serving.paged_cache import RowState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rts = {True: T.AttentionRuntime(paged_kernels=True),
           False: T.AttentionRuntime(paged_kernels=False)}
    # logits: two slots (the shortest and the longest prompt) streamed
    # chunk by chunk, then one decode step, on both paths
    small = T.ServingCfg(num_slots=2, page_size=16, num_pages=80, max_blocks_per_slot=64)
    bt = np.zeros((2, 64), np.int32)
    lens = [len(reqs[0].prompt), len(reqs[1].prompt)]
    perm = np.random.default_rng(SEED).permutation(np.arange(1, 80))
    bt[0, :lens[0] // 16 + 1] = perm[:lens[0] // 16 + 1]
    bt[1, :lens[1] // 16 + 1] = perm[40:40 + lens[1] // 16 + 1]
    got = {}
    for fused, rt in rts.items():
        caches = M.init_paged_caches(cfg, rt, small, DEVICE)
        pre = [chunk_logits(M, cfg, rt, params, reqs[s].prompt, small, caches,
                            torch.tensor(bt[s], device=DEVICE)) for s in range(2)]
        first = torch.cat([p.argmax(-1) for p in pre]).to(torch.int32)
        rows = RowState(lengths=torch.tensor(lens, dtype=torch.int32, device=DEVICE),
                        block_table=torch.tensor(bt, device=DEVICE),
                        active=torch.ones(2, dtype=torch.bool, device=DEVICE),
                        tier=torch.zeros(2, dtype=torch.int32, device=DEVICE))
        dec, _ = M.decode_step_rows(cfg, rt, params, first[:, None], rows, caches)
        got[fused] = (torch.cat(pre), dec)
        del caches
    for i, name in enumerate(("prefill", "first-decode")):
        a, b = got[True][i], got[False][i]
        err = (a - b).abs().max().item()
        log(f"parity: {name} logits max abs diff {err:.3e} (atol=rtol={LOGIT_TOL})")
        check(torch.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL),
              f"parity: {name} logits differ by {err:.3e}")

    serving = T.ServingCfg(num_slots=8, page_size=16, num_pages=513,
                           max_blocks_per_slot=64)
    streams = {}
    for fused in (True, False):
        eng = T.ContinuousServeEngine(cfg, params, rt=rts[fused], serving=serving,
                                      device=DEVICE)
        res, _ = eng.serve(make_requests(T, cfg.vocab_size), T.GenerationConfig())
        streams[fused] = {rid: res[rid]["tokens"] for rid in res}
        del eng
    excused = 0
    one = T.ServingCfg(num_slots=1, page_size=16, num_pages=40, max_blocks_per_slot=64)
    row = torch.tensor(np.where(np.arange(64) < 39, np.arange(1, 65), 0).astype(np.int32),
                       device=DEVICE)
    for r in reqs:
        a, b = streams[True][r.rid], streams[False][r.rid]
        check(len(a) == len(b) == r.max_new_tokens, f"parity: request {r.rid} lengths")
        diff = np.flatnonzero(a != b)
        if not len(diff):
            continue
        t = int(diff[0])   # after a divergence the contexts differ: stop there
        ctx = np.concatenate([r.prompt, b[:t]]).astype(np.int32)
        caches = M.init_paged_caches(cfg, rts[False], one, DEVICE)
        top2 = chunk_logits(M, cfg, rts[False], params, ctx, one, caches, row)[0].topk(2).values
        gap = (top2[0] - top2[1]).item()
        log(f"parity: request {r.rid} diverges at token {t}: kernels {a[t]} vs "
            f"gather {b[t]}, gather top-2 gap {gap:.3e}")
        check(gap < ARGMAX_GAP, f"parity: request {r.rid} token {t} differs at a "
              f"resolvable gap {gap:.3e}")
        excused += 1
    log(f"parity: greedy streams identical for {len(reqs) - excused}/{len(reqs)} "
        f"requests, {excused} near-tie divergences excused")


# ------------------------------------------------------------------ main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the report as JSON here")
    args = ap.parse_args()
    global T0
    T0 = time.perf_counter()

    # 1) device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch as T
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attn import ops
    from repro_torch.models import model as M
    from repro_torch.params import init_params, to_device

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")
    report = {"card": smi}

    # 2) build
    t0 = time.perf_counter()
    build.build(list(ops.SOURCES.values()))
    for name in ops.SOURCES:
        ops.launcher(name)
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f} s")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"nvcc[{name}]: {line.strip()}", file=sys.stderr)

    # 3) kernels against their plain versions
    errs = {"paged_decode": {}, "paged_prefill": {}}
    for dtype in (torch.bfloat16, torch.float32):
        for KV, G, Dh in ((16, 1, 64), (8, 4, 128)):
            e_dec, e_pre = sweep(ops, dtype, KV, G, Dh)
            tag = f"{str(dtype).removeprefix('torch.')} KV={KV} G={G} Dh={Dh}"
            log(f"sweep {tag}: paged_decode {e_dec:.3e}, paged_prefill {e_pre:.3e} "
                f"(tol {TOL[dtype]})")
            check(e_dec <= TOL[dtype], f"paged_decode {tag}: error {e_dec}")
            check(e_pre <= TOL[dtype], f"paged_prefill {tag}: error {e_pre}")
            errs["paged_decode"][tag] = e_dec
            errs["paged_prefill"][tag] = e_pre

    log(f"[{time.perf_counter() - T0:.0f} s] kernels checked")
    # 4) serve full-width qwen1.5-0.5b in bf16
    cfg = served_config(T)
    params = init_params(cfg, SEED, DEVICE)
    serving = T.ServingCfg(num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64)
    eng = T.ContinuousServeEngine(cfg, params, serving=serving, device=DEVICE)
    reqs = make_requests(T, cfg.vocab_size)
    warm = T.ContinuousServeEngine(cfg, params, serving=T.ServingCfg(
        num_slots=2, page_size=16, num_pages=17, max_blocks_per_slot=8), device=DEVICE)
    warm.serve([T.Request(rid=0, prompt=reqs[0].prompt[:40], max_new_tokens=4)])
    del warm
    dec_fn, pre_fn = ops.paged_decode, ops.paged_prefill
    rec_dec = Recorder(dec_fn, cfg.num_layers, 10, lambda bt, ln, s: (bt.clone(), ln.clone()))
    rec_pre = Recorder(pre_fn, cfg.num_layers, 8, lambda row, off, val, s: (row.clone(), off, val))
    ops.paged_decode, ops.paged_prefill = rec_dec, rec_pre
    dec_fn.launches = pre_fn.launches = 0
    results, stats, ticks, wall = serve_timed(eng, T, reqs)
    launches = {"paged_decode": dec_fn.launches, "paged_prefill": pre_fn.launches}
    ops.paged_decode, ops.paged_prefill = dec_fn, pre_fn
    for r in reqs:
        got = results[r.rid]
        check(got["finish_reason"] == "max_tokens" and len(got["tokens"]) == 64,
              f"request {r.rid}: {got['finish_reason']}, {len(got['tokens'])} tokens")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    check(launches["paged_decode"] == cfg.num_layers * stats["decode_steps"]
          and launches["paged_prefill"] == cfg.num_layers * stats["prefill_chunks"],
          f"launch counts {launches} vs {stats['decode_steps']} decode ticks and "
          f"{stats['prefill_chunks']} chunks")
    pure = [(ms, rows) for ms, rows, chunk, dec in ticks if dec and not chunk]
    step_ms = float(np.median([ms for ms, _ in pure]))
    rows_per = float(np.mean([rows for _, rows in pure]))
    serve = {"ticks": len(ticks), "decode_steps": stats["decode_steps"],
             "prefill_chunks": stats["prefill_chunks"], "pure_decode_ticks": len(pure),
             "decode_step_ms_median": step_ms,
             "decode_step_ms_p90": float(np.percentile([ms for ms, _ in pure], 90)),
             "rows_per_decode_step": rows_per,
             "decode_tokens_per_s": rows_per / step_ms * 1e3,
             "generated_tokens": stats["generated_tokens"], "serve_wall_s": wall,
             "end_to_end_tokens_per_s": stats["generated_tokens"] / wall,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    report["serve"] = serve
    log(f"serve: {len(reqs)} requests, {serve['ticks']} ticks "
        f"({serve['decode_steps']} decode, {serve['prefill_chunks']} prefill chunks); "
        f"decode step median {step_ms:.3f} ms (p90 {serve['decode_step_ms_p90']:.3f}) over "
        f"{len(pure)} decode-only ticks at {rows_per:.2f} rows = "
        f"{serve['decode_tokens_per_s']:.1f} tokens/s; end to end "
        f"{serve['end_to_end_tokens_per_s']:.1f} tokens/s over {wall:.2f} s")
    log(f"[{time.perf_counter() - T0:.0f} s] served")
    scale = cfg.head_dim ** -0.5
    timing = {"paged_decode": time_kernel(rec_dec, decode_case(ops, scale)),
              "paged_prefill": time_kernel(rec_pre, prefill_case(ops, scale))}
    per_tick = {"paged_decode": launches["paged_decode"] / stats["decode_steps"],
                "paged_prefill": launches["paged_prefill"] / stats["prefill_chunks"]}
    for name, t in timing.items():
        log(f"{name}: {t['ms'] * 1e3:.2f} us/launch on the device, {t['eager_ms'] * 1e3:.2f} "
            f"us launched eagerly (bound {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}; "
            f"plain {t['plain_ms'] * 1e3:.1f} us, sdpa {t['library_ms'] * 1e3:.1f} us) over "
            f"{t['samples']} sampled calls; {launches[name]} launches, "
            f"{per_tick[name]:.0f} per tick")
    del eng, rec_dec, rec_pre
    torch.cuda.empty_cache()
    pure_idx = [i for i, t in enumerate(ticks) if t[3] and not t[2]]
    windows = [(40, 60), (pure_idx[len(pure_idx) // 2 - 10], pure_idx[len(pure_idx) // 2 + 10])]
    prof = profile_windows(
        lambda: T.ContinuousServeEngine(cfg, params, serving=serving, device=DEVICE),
        T, make_requests(T, cfg.vocab_size), ticks, windows)
    report["profile"] = prof
    for w in prof:
        log(f"profile ticks {w['ticks']} ({w['decode_only_ticks']} decode-only): device busy "
            f"{w['device_busy_ms']:.2f} ms of {w['unprofiled_wall_ms']:.2f} ms wall = "
            f"{w['busy_share']:.1%}; paged attention {w['paged_attn_ms']:.2f} ms, "
            f"GEMMs {w['gemm_ms']:.2f} ms")
        for k in w["top_kernels"][:6]:
            log(f"profile:   {k['ms']:8.3f} ms {k['count']:5d}x {k['name'][:100]}")
    log(f"[{time.perf_counter() - T0:.0f} s] profiled")
    torch.cuda.empty_cache()

    log(f"[{time.perf_counter() - T0:.0f} s] kernels timed")
    # 5) f32 parity, paged kernels on and off
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = to_device(_tree_float(params), DEVICE)
    del params
    parity(T, M, cfg32, params32, reqs)

    log(f"[{time.perf_counter() - T0:.0f} s] parity checked")
    replaces = {"paged_decode": "src/repro/kernels/flash_attn/kernel.py:223",
                "paged_prefill": "src/repro/kernels/flash_attn/kernel.py:170"}
    sources = {n: os.path.relpath(str(p), os.path.dirname(os.path.abspath(__file__)))
               for n, p in ops.SOURCES.items()}
    kernels = []
    for name in ("paged_decode", "paged_prefill"):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "launches_per_tick": per_tick[name],
            "max_abs_err": errs[name]["bfloat16 KV=16 G=1 Dh=64"],
            "max_abs_err_sweep": errs[name],
            "ms": t["ms"], "eager_ms": t["eager_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "timed_samples": t["samples"]})
    report["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_float(v) for v in tree]
    return tree.float()


if __name__ == "__main__":
    sys.exit(main())
