"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json] [--against PARENT_CHECKOUT [--changed KEYS]]

Phases, each of which fails the run (nonzero exit) on a miss:
  1. device   needs CUDA; prints the card's name and power limit
  2. build    compiles the port's CUDA kernels with nvcc from the checkout,
              one nvcc per source, all started together; with --against,
              also both trees afresh (repro_torch.kernels.build.compare),
              printing the verdict and failing unless every kernel both
              compile has an identical ptxas report, apart from those a
              change names on purpose with --changed (substrings of
              "<source> <kernel>": for example a redesigned kernel's
              source)
  3. kernels  every kernel against its plain PyTorch version, bf16 and f32,
              at qwen1.5-0.5b's shape (KV=16, G=1, Dh=64, page 16) and at a
              GQA shape (KV=8, G=4, Dh=128): B1 paged_decode and B2
              paged_prefill on the layouts of the CPU tests (permuted pages,
              a poisoned null page, ragged and empty rows, partial last
              pages), each B1 call on its route (widths that are multiples
              of 16 the ring kernel, either dtype; Dh 24 and 12 the sweep),
              and B1 at the served decode's capacity (8 rows over 64 pages
              of 16, lengths 0, 1, on 16-key tiles and full) at both shapes
              with the planned and with the most cluster ranks; B5
              paged_cpq_decode and B6 paged_cpq_prefill over CPQ code pages
              of 4 and 8 bits, L = 4 levels, with the null page's
              levels out of range, a live row over an all-null block row
              (each B5 call must take its route: widths that are multiples
              of 16 the single-query kernel, Dh 24 and 12 the sweep);
              B2 and B6 on prompt chunks of 16 at offset 0, mid-prompt, at a
              mid-page offset, far in and with valid < C, and chunks of 8
              (fewer than 16 query rows), also at Dh 24 and 12: each call
              must take its route (bf16 at widths that are multiples of 8
              the tensor-core kernel, float32 and Dh 12 the sweep), and the
              log names each error's route;
              B3 paged_decomposed_decode and B4 paged_decomposed_prefill on
              the same layouts and chunks at qwen1.5-0.5b's T1 shape (H=16,
              Dm=1024, 16 roped keys of 32), an MLA-like shape (H=16,
              Dm=512, one shared roped key of 64), a no-rope shape (H=8,
              Dm=256) and past d_model 2048 (Dm 2560, 3072, 4096, 8192),
              each B3 and B4 call on its route (bf16 up to Dm 1024 the
              tensor-core kernel, float32 and wider models the sweep), and
              B3 at the served shape over 8 rows of 64 pages with lengths
              on its split boundaries, 0 and the full capacity, with the
              planned and with the most splits; B7
              paged_proxy_scores (one launch forming the query factors from
              q in float32 or bf16, rows at a wider query's stride, its
              scale given or not, and the slot's float32 tables; int8
              codes) at qwen1.5-0.5b's T3 shape (KV=16, G=1, Dp=64) and GQA
              shapes (KV=8, G=4 and G=3, Dp=128) on the same layouts, and
              in its contiguous form (the factors given, and formed from a
              bf16 query as the static T3 decode does), held to 1e-5 x max
              |score|; the contiguous kernels: B8
              flash_attention (a bf16 prompt on its tensor-core route, a
              float32 prompt on its CUDA-core sweep, a decode token on its
              single-query route) on the five cases of tests/test_kernels.py,
              qwen1.5-0.5b's static prefill (8 x 512 tokens, causal), a
              one-shot prompt (1 x 512), a decode token over 575 keys (a
              prefix of a 576-key arena), T = S = 77, and at Dh 32, 64, 128
              and 256 with G of 1, 4 and 8 a prompt of 200 (causal and not)
              and a decode token; B9 decomposed_decode at qwen's T1 shape
              (kv_r 16, Rr 32, length < N, past one key split, length 0),
              an MLA-like shape (kv_r 1, Rr 64), a no-rope shape, 32 heads,
              N = 77 and Dm 2560-8192, each call on its route (as B3's);
              B10 cpq_decode
              with 4- and 8-bit codes, G of 1, 4 and 8 (Dh 256), tiles
              rounded and not, pruned codes, length < N and N = 77 (float32
              output, its tolerance)
  4. serve    full-width qwen1.5-0.5b (24 layers, vocab 151936, random
              weights from a seed) in bf16 through ContinuousServeEngine:
              8 greedy requests, prompts of 64-512 tokens, 64 new tokens
              each, (a) dense, (b) mode="cpq", (d) mode="decomposed" (T1),
              (e) mode="retrieval" (T3, top_k=256, recent_window=64: rows
              past 256 keys really select), (c) the tiered engine
              (enable_escalation=True, a dense arena small enough that rows
              are admitted into and escalated to the CPQ tier). Each run
              must launch its kernels 24 times per tick (T3: B7 per decode
              tick, B2 per chunk tick), every chunk launch of B2, B4 and B6
              and every decode launch of B3 on the tensor-core route, every
              decode launch of B5 on the single-query route and every decode
              launch of B1 on the ring route (route counters against
              launches; B1's also in (g));
              (a), (b), (d) and (e) then time
              them at the shapes the run gave
              them, beside their bound, their plain version and one PyTorch
              library call (a yardstick only); each run is replayed under
              torch.profiler over a window of decode-only ticks, (a), (b)
              and (d) also over a window of chunk ticks (10, 5 and 5). Then the
              contiguous path: (f)
              the static ServeEngine on 8 prompts of 512 seeded tokens, 64
              new tokens, in the four modes: B8 launched 24 times for the
              prefill, and 24 times per decode step B8 (dense), B9
              (decomposed), B10 (cpq) or B7's contiguous form (retrieval);
              every bf16 prefill through B8's tensor-core route, every
              dense decode step through its single-query route and every B9
              launch through its tensor-core route (counted per route); B8
              (prompt and decode shapes), B9 and B10 timed at the shapes the
              runs gave them, ten dense and ten decomposed decode steps
              profiled; (g) ContinuousServeEngine with prefill_chunk=0
              (one-shot admission), dense, on the traffic of (a): B8's
              tensor-core route 24 times per admission, B1 24 times per
              decode tick, B2 never. No gate: layer 0's K/V of the static
              prompts encoded by the HQE compression (448 tokens at once,
              64 appended) and the T3 proxy encode on the card and on the
              CPU, and how many codes, levels and tables differ
  5. parity   the same requests in f32 (TF32 off), dense, mode="cpq",
              mode="decomposed" and mode="retrieval" (top_k=256), with the
              kernels on and off: prefill and first-decode logits within
              1e-3, greedy streams identical except where the gather path's
              top-2 logit gap is below 1e-4. T3 also prints (no gate) how
              many (row, head, layer) top-k sets picked by B7's scores differ
              from those picked by its plain version's and by the gather
              path's scores over sampled decode calls; its gather path
              attends the keys the kernel path picked, and every pick of its
              own that differs must be a swap within 1e-4 (relative) of the
              top-k boundary. Dense and decomposed run each path on its own
              history; CPQ and T3 run them in lockstep on one history (the
              gather path writes the K/V the kernel path wrote), since each
              path's 4-bit CPQ or 8-bit proxy codes would otherwise turn
              last-ulp K/V differences into whole steps. These continuous
              serves run the first 8 of the 24 layers here, to keep the
              script well inside its time limit. Then, at full depth, the
              same checks for (g) (dense, each path on its own history)
              and for (f) in the four modes (CPQ and T3 in lockstep, T3
              pinned): the prefill and first-decode logits of the batch,
              and the greedy streams

The last line is {"ok": true, "device": {...}}; the line before it lists
every kernel with its launches, error and times.
"""
from __future__ import annotations

import argparse
import contextlib
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
TOPK_GAP = 1e-4             # T3: relative proxy-score gap below which a top-k swap is a tie
CPQ_LEVELS = 4              # HQE levels of the default CPQCfg
PARITY_DEPTH = 8            # layers of the continuous serves' f32 parity (of 24)
SEED = 0
DEVICE = "cuda"
# the namespaces of the attention kernels' device functions, as a profile
# names them
ATTENTION_KERNELS = ("paged_attn", "paged_chunk", "paged_token", "cpq_attn",
                     "decomposed_attn", "decomposed_chunk", "t1_token", "topk_retrieval",
                     "flash_prompt", "single_query")
# B8's wrapper counts every launch; its kernels (routes) are counted apart,
# under these names in a serve's launch counts
COUNT_KEY = {"flash_attention": "flash_attention/decode",
             "flash_attention_prompt": "flash_attention/prompt"}
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


def chunk_calls(long_len: int, C: int = 16) -> tuple:
    """(offset, valid, C) of the prompt chunks a sweep runs over a long row:
    a first chunk, valid < C, a mid-page offset, a chunk far in, the row's
    last tokens, and chunks of 8 (fewer than 16 query rows at G = 1)."""
    return ((0, C, C), (C, 5, C), (213, C, C), (512, C, C), (long_len - 3, 3, C),
            (37, 8, 8), (300, 5, 8))


def routes_moved(routes: dict, before: dict) -> dict:
    """The launches of each route of a kernel (``routes``, its module's
    counter dict) since ``before``."""
    return {r: n - before[r] for r, n in routes.items()}


def decode_err(ops, dtype, q, kp, vp, bt, lengths, scale) -> float:
    """Max abs error of one B1 call against its plain version; the call must
    take the route its dtype and widths pick, and its empty rows be zero."""
    before = dict(ops.DECODE_ROUTE_LAUNCHES)
    out = ops.paged_decode(q, kp, vp, bt, lengths, scale)
    torch.cuda.synchronize()
    route = ops.decode_route(dtype, kp.shape[-1], vp.shape[-1], bt.shape[1])
    moved = routes_moved(ops.DECODE_ROUTE_LAUNCHES, before)
    check(moved == {k: int(k == route) for k in moved},
          f"paged_decode {dtype} {tuple(kp.shape)}: routes {moved}, want {route}")
    ref = ops.paged_decode_plain(q, kp, vp, bt, lengths, scale)
    check(not out[lengths == 0].any().item(), "paged_decode: an empty row is not zero")
    return (out.float() - ref.float()).abs().max().item()


# B1 at the served decode's capacity (8 rows over 64 pages of 16): lengths
# 0, 1, on the ring route's 16-key tiles and at the full capacity, at
# qwen1.5-0.5b's shape (KV 16, G 1, Dh 64: one block a unit) and at GQA (KV
# 8, G 4, Dh 128: two ranks a unit), each also with every unit over the most
# ranks of a cluster (8)
SERVED_DECODE = ((0, 1, 256, 1024, 77, 576, 767, 16), (640, 128, 0, 511, 257, 1000, 17, 33))


def sweep_decode_served(ops, dtype, page=16, nb=64) -> dict:
    """Max abs error of B1 against its plain version on SERVED_DECODE, with
    the planned ranks and with the most, each call on its route."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    errs = {}
    for KV, G, Dh in ((16, 1, 64), (8, 4, 128)):
        err = 0.0
        for lengths in SERVED_DECODE:
            B = len(lengths)
            pages = torch.randperm(B * nb, generator=gen, device=DEVICE).int() + 1
            bt = torch.zeros((B, nb), dtype=torch.int32, device=DEVICE)
            for b, n in enumerate(lengths):
                bt[b, :-(-n // page)] = pages[b * nb:b * nb + -(-n // page)]
            kp = torch.randn((1 + B * nb, page, KV, Dh), generator=gen, device=DEVICE).to(dtype)
            vp = torch.randn((1 + B * nb, page, KV, Dh), generator=gen, device=DEVICE).to(dtype)
            kp[0] = vp[0] = 1e3                  # poisoned null page
            q = torch.randn((B, 1, KV * G, Dh), generator=gen, device=DEVICE).to(dtype)
            len_t = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
            plan = ops.decode_plan
            try:
                for forced in (None, ops.RING_MAX_CLUSTER):
                    if forced:
                        ops.decode_plan = lambda *a: forced  # noqa: E731
                    err = max(err, decode_err(ops, dtype, q, kp, vp, bt, len_t, Dh ** -0.5))
            finally:
                ops.decode_plan = plan
        errs[f"KV={KV} G={G} Dh={Dh}"] = err
    return errs


def sweep(ops, dtype, KV, G, Dh, page=16, nb=64, B=8, C=16):
    """Max abs error of B1 and B2 against their plain versions; every B1 and
    B2 call must take the route its dtype and width pick."""
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
    err_dec = decode_err(ops, dtype, q, kp, vp, bt_t, len_t, scale)
    err_pre = 0.0
    row = bt_t[-1]                               # the long row's pages
    calls = chunk_calls(int(lengths[-1]), C)
    before = dict(ops.ROUTE_LAUNCHES)
    for offset, valid, c in calls:
        qc = torch.randn(1, c, KV * G, Dh, device=dev).to(dtype)
        o = ops.paged_prefill(qc, kp, vp, row, offset, valid, scale)
        torch.cuda.synchronize()
        r = ops.paged_prefill_plain(qc, kp, vp, row, offset, valid, scale)
        err_pre = max(err_pre, (o[0, :valid].float() - r[0, :valid].float()).abs().max().item())
    route = ops.prefill_route(dtype, Dh, Dh)
    moved = routes_moved(ops.ROUTE_LAUNCHES, before)
    check(moved == {r: len(calls) * (r == route) for r in moved},
          f"paged_prefill {dtype} Dh={Dh}: routes {moved}, want all {route}")
    return err_dec, err_pre


def cpq_pool(gen, P, page, KV, D, slots, bits, L=CPQ_LEVELS):
    """A CPQ arena on the card: ``bits``-bit codes, levels in [0, L), and
    per-slot scale/zero tables whose levels span 1.2-3 around 0. The null
    page 0 holds full-range codes and levels outside [0, L)."""
    from repro_torch.serving.paged_cache import PagedCPQTensor

    dev = DEVICE

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    codes = (torch.randint(0, 1 << bits, (P, page, KV, D), generator=gen, device=dev)
             - 128).to(torch.int8)
    codes[0] = torch.randint(-128, 128, (page, KV, D), generator=gen, device=dev).to(torch.int8)
    level = torch.randint(0, L, (P, page, KV), generator=gen, device=dev).to(torch.int32)
    level[0] = torch.where(rand(page, KV) < 0.5, L + 3, -2).to(torch.int32)
    width = 1.2 + 1.8 * rand(slots, L, KV, D)
    scale = width / ((1 << bits) - 2)
    zero = -width / 2 + 0.1 * torch.randn((slots, L, KV, D), generator=gen, device=dev)
    return PagedCPQTensor(codes, level, scale, zero,
                          torch.ones((slots, KV), dtype=torch.int32, device=dev),
                          torch.zeros((slots, KV, D), device=dev))


def sweep_cpq(cpq_ops, dtype, KV, G, Dh, bits, page=16, nb=64, B=8, C=16):
    """Max abs error of B5 and B6 against their plain versions. Row 0 is
    empty; row 1 has a live length over an all-null block row (the CPQ arm
    of a tiered decode on a dense-tier row); the last row is long, with a
    partial last page, and serves the prefill chunks."""
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    num_pages, lengths, bt = layout(rng, B, nb, page)
    bt[1], lengths[1] = 0, 3 * page + 5
    kt = cpq_pool(gen, num_pages, page, KV, Dh, B, bits)
    vt = cpq_pool(gen, num_pages, page, KV, Dh, B, bits)
    q = torch.randn((B, 1, KV * G, Dh), generator=gen, device=DEVICE).to(dtype)
    bt_t = torch.tensor(bt, device=DEVICE)
    len_t = torch.tensor(lengths, device=DEVICE)
    scale = Dh ** -0.5
    before = dict(cpq_ops.DECODE_ROUTE_LAUNCHES)
    out = cpq_ops.paged_cpq_decode(q, kt, vt, bt_t, len_t, scale)
    torch.cuda.synchronize()
    route = cpq_ops.cpq_decode_route(Dh, Dh)
    moved = routes_moved(cpq_ops.DECODE_ROUTE_LAUNCHES, before)
    check(moved == {r: int(r == route) for r in moved},
          f"paged_cpq_decode {dtype} Dh={Dh}: routes {moved}, want {route}")
    ref = cpq_ops.paged_cpq_decode_plain(q, kt, vt, bt_t, len_t, scale)
    err_dec = (out.float() - ref.float()).abs().max().item()
    check(not out[0].any().item(), "paged_cpq_decode: an empty row is not zero")
    err_pre = 0.0
    row, slot = bt_t[-1], B - 1
    calls = chunk_calls(int(lengths[-1]), C)
    before = dict(cpq_ops.ROUTE_LAUNCHES)
    for offset, valid, c in calls:
        qc, k_raw, v_raw = (torch.randn((1, c, h, Dh), generator=gen, device=DEVICE).to(dtype)
                            for h in (KV * G, KV, KV))
        o = cpq_ops.paged_cpq_prefill(qc, kt, vt, k_raw, v_raw, slot, row, offset, valid, scale)
        torch.cuda.synchronize()
        r = cpq_ops.paged_cpq_prefill_plain(qc, kt, vt, k_raw, v_raw, slot, row, offset,
                                            valid, scale)
        err_pre = max(err_pre, (o[0, :valid].float() - r[0, :valid].float()).abs().max().item())
    route = cpq_ops.cpq_prefill_route(dtype, Dh, Dh, kt.scale.shape[1])
    moved = routes_moved(cpq_ops.ROUTE_LAUNCHES, before)
    check(moved == {r: len(calls) * (r == route) for r in moved},
          f"paged_cpq_prefill {dtype} Dh={Dh}: routes {moved}, want all {route}")
    return err_dec, err_pre


T1_SHAPES = ((16, 1024, 16, 32), (16, 512, 1, 64), (8, 256, 1, 0),  # H, Dm, kv_r, Rr
             # past d_model 2048 (qwen3-4b, phi4-mini, opt-6.7b, jamba): fewer rows a block
             (32, 2560, 8, 32), (24, 3072, 8, 32), (32, 4096, 32, 32), (64, 8192, 8, 64))


def t1_decode_err(t1_ops, dtype, r, qr, xp, krp, bt, lengths, scale) -> float:
    """Max abs error of one B3 call against its plain version; the call must
    take the route its dtype and widths pick, and its empty rows be zero."""
    before = dict(t1_ops.DECODE_ROUTE_LAUNCHES)
    out = t1_ops.paged_decomposed_decode_fwd(r, qr, xp, krp, bt, lengths, scale)
    torch.cuda.synchronize()
    route = t1_ops.t1_decode_route(dtype, r.shape[1], r.shape[2], krp.shape[2], qr.shape[2])
    moved = routes_moved(t1_ops.DECODE_ROUTE_LAUNCHES, before)
    check(moved == {k: int(k == route) for k in moved},
          f"paged_decomposed_decode {dtype} {tuple(r.shape)}: routes {moved}, want {route}")
    ref = t1_ops.paged_decomposed_decode_plain(r, qr, xp, krp, bt, lengths, scale)
    check(not out[lengths == 0].any().item(), "paged_decomposed_decode: an empty row is not zero")
    return (out.float() - ref.float()).abs().max().item()


# B3 at the served T1 shape over the served decode's capacity (8 rows over
# 64 pages of 16): lengths on the tensor-core route's split boundaries, 0
# and the full capacity, each case also with the most splits
# (TOKEN_MAX_SPLITS of 64 keys: many partials merged by the last block of
# each rank)
T1_SERVED_DECODE = ((0, 1024, 576, 77, 300, 129, 64, 1), (640, 128, 0, 511, 257, 1000, 16, 33))


def sweep_t1_served(t1_ops, dtype, H=16, Dm=1024, kv_r=16, Rr=32, page=16, nb=64) -> float:
    """Max abs error of B3 against its plain version on T1_SERVED_DECODE,
    with the planned splits and with the most splits, each call on its
    route."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    err = 0.0
    for lengths in T1_SERVED_DECODE:
        B = len(lengths)
        pages = torch.randperm(B * nb, generator=gen, device=DEVICE).int() + 1
        bt = torch.zeros((B, nb), dtype=torch.int32, device=DEVICE)
        for b, n in enumerate(lengths):
            bt[b, :-(-n // page)] = pages[b * nb:b * nb + -(-n // page)]
        xp = torch.randn((1 + B * nb, page, Dm), generator=gen, device=DEVICE).to(dtype)
        krp = torch.randn((1 + B * nb, page, kv_r, Rr), generator=gen, device=DEVICE).to(dtype)
        xp[0] = krp[0] = 1e3                     # poisoned null page
        r = torch.randn((B, H, Dm), generator=gen, device=DEVICE).to(dtype)
        qr = torch.randn((B, H, Rr), generator=gen, device=DEVICE).to(dtype)
        len_t = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
        plan, most = t1_ops.t1_decode_plan, t1_ops.TOKEN_MAX_SPLITS
        try:
            for forced in (None, (most, -(-nb * page // most))):
                if forced:
                    t1_ops.t1_decode_plan = lambda *a: forced  # noqa: E731
                err = max(err, t1_decode_err(t1_ops, dtype, r, qr, xp, krp, bt, len_t,
                                             (Dm + Rr) ** -0.5))
        finally:
            t1_ops.t1_decode_plan = plan
    return err


def sweep_t1(t1_ops, dtype, H, Dm, kv_r, Rr, page=16, nb=64, B=8, C=16):
    """Max abs error of B3 and B4 against their plain versions on the layout
    of ``sweep``: an empty row, ragged rows, a long row with a partial last
    page serving the prefill chunks of ``chunk_calls`` (at qwen1.5-0.5b's
    widths the served chunks: a first chunk, valid < C, a mid-page offset,
    past 512 keys, chunks of 8), a poisoned null page. Every B4 call must
    take the route its dtype and widths pick."""
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    num_pages, lengths, bt = layout(rng, B, nb, page)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    xp, krp = randn(num_pages, page, Dm), randn(num_pages, page, kv_r, Rr)
    xp[0] = krp[0] = 1e3                         # poisoned null page
    bt_t = torch.tensor(bt, device=DEVICE)
    len_t = torch.tensor(lengths, device=DEVICE)
    scale = (Dm + Rr) ** -0.5
    r, qr = randn(B, H, Dm), randn(B, H, Rr)
    err_dec = t1_decode_err(t1_ops, dtype, r, qr, xp, krp, bt_t, len_t, scale)
    err_pre = 0.0
    row = bt_t[-1]
    calls = chunk_calls(int(lengths[-1]), C)
    before = dict(t1_ops.ROUTE_LAUNCHES)
    for offset, valid, c in calls:
        rc, qc = randn(c, H, Dm), randn(c, H, Rr)
        o = t1_ops.paged_decomposed_prefill_fwd(rc, qc, xp, krp, row, offset, valid, scale)
        torch.cuda.synchronize()
        ref = t1_ops.paged_decomposed_prefill_plain(rc, qc, xp, krp, row, offset, valid,
                                                    scale)
        err_pre = max(err_pre, (o[:valid].float() - ref[:valid].float()).abs().max().item())
    route = t1_ops.t1_prefill_route(dtype, Dm, Rr)
    moved = routes_moved(t1_ops.ROUTE_LAUNCHES, before)
    check(moved == {r: len(calls) * (r == route) for r in moved},
          f"paged_decomposed_prefill {dtype} Dm={Dm} Rr={Rr}: routes {moved}, want all {route}")
    return err_dec, err_pre


T3_SHAPES = ((16, 1, 64), (8, 4, 128), (8, 3, 128))   # KV, G, Dp (G = 3: phi4-mini)
T3_REL = 1e-5           # B7 vs plain: max abs error <= T3_REL * max |score|


def t3_err(got, want) -> tuple[float, float]:
    """(max abs error over live scores, its bound T3_REL * max |score|); the
    masked scores must be exactly -1e30."""
    live = want > -1e29
    check(torch.equal(got[~live], want[~live]), "proxy scores: a masked score is not -1e30")
    if not live.any():
        return 0.0, 0.0
    return ((got[live] - want[live]).abs().max().item(),
            T3_REL * want[live].abs().max().item())


def sweep_t3(t3_ops, KV, G, Dp, page=16, nb=64, B=8, N=1000):
    """Max abs error of B7 against its plain version, each case checked
    against its own tolerance (T3_REL x its max |score|): the served call
    (the query factors formed in the kernel from q in float32 and bf16,
    rows at the stride of a wider query, its scale given or not, n at and
    short of the capacity) over code pages on the layout of ``sweep`` (an
    empty row, ragged rows, a long row with a partial last page, a poisoned
    null page), then in the contiguous form at N = 1000 (not a multiple of
    the kernel's 128-key blocks) with the factors given at lengths 777 and 0, and
    formed from a bf16 query (the static T3 decode's ``proxy_scores_q``)."""
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    num_pages, lengths, bt = layout(rng, B, nb, page)
    codes = torch.randint(-128, 128, (num_pages, page, KV, Dp), generator=gen,
                          device=DEVICE).to(torch.int8)
    codes[0] = 127                               # poisoned null page
    scale = 0.005 + 0.025 * torch.rand((B, KV, Dp), generator=gen, device=DEVICE)
    zero = -1.5 + 0.3 * torch.randn((B, KV, Dp), generator=gen, device=DEVICE)
    q = torch.randn((B, KV * G, Dp), generator=gen, device=DEVICE) * Dp ** -0.5
    bt_t = torch.tensor(bt, device=DEVICE)
    len_t = torch.tensor(lengths, device=DEVICE)
    errs = []
    # the served call: the query as rows of a (B, 1, H, 2 Dp) tensor in q's
    # type, its scale given (float32 and bf16), and n short of the capacity
    wide = torch.cat([q, q.flip(-1)], -1)[:, None]
    for qdt, q_scale, n in ((torch.float32, None, nb * page), (torch.bfloat16, 0.125, nb * page),
                            (torch.float32, 0.125, nb * page - 37)):
        qv = wide.to(qdt)[:, 0, :, :Dp]
        out = t3_ops.paged_proxy_scores(qv, scale, zero, codes, bt_t, len_t, n, q_scale=q_scale)
        torch.cuda.synchronize()
        q_eff = qv if q_scale is None else qv * q_scale
        errs.append(t3_err(out, t3_ops.paged_proxy_scores_plain(q_eff, scale, zero, codes,
                                                               bt_t, len_t, n)))
        check(bool((out[0] == -1e30).all().item()), "paged_proxy_scores: an empty row is live")
    cont = torch.randint(-128, 128, (B, N, KV, Dp), generator=gen, device=DEVICE).to(torch.int8)
    qs = 0.02 * torch.randn((B, KV, G, Dp), generator=gen, device=DEVICE)
    qz = torch.randn((B, KV, G, 1), generator=gen, device=DEVICE)
    for length in (777, 0):
        o = t3_ops.proxy_scores(qs, qz, cont, length)
        torch.cuda.synchronize()
        errs.append(t3_err(o, t3_ops.proxy_scores_plain(qs, qz, cont, length)))
    # the static T3 decode's form: the factors formed over contiguous codes
    fq = torch.randn((B, KV * G, Dp), generator=gen, device=DEVICE).bfloat16()
    o = t3_ops.proxy_scores_q(fq, scale, zero, cont, torch.tensor(777, dtype=torch.int32))
    torch.cuda.synchronize()
    fs, fz = t3_ops.query_factors(fq, scale, zero)
    errs.append(t3_err(o, t3_ops.proxy_scores_plain(fs, fz, cont, 777).reshape(o.shape)))
    for err, tol in errs:
        check(err <= tol, f"proxy scores KV={KV} G={G} Dp={Dp}: error {err} > {tol}")
    return max(e for e, _ in errs)


FLASH_SWEEP = (  # B, T, S, H, KV, D, causal, arena (k and v: the first S keys)
    (2, 128, 128, 4, 2, 64, True, 128),      # the five cases of tests/test_kernels.py
    (2, 256, 256, 8, 8, 128, True, 256),
    (2, 100, 100, 4, 1, 32, False, 100),
    (2, 192, 192, 6, 3, 64, True, 192),
    (2, 128, 128, 4, 4, 64, True, 128),
    (8, 512, 512, 16, 16, 64, True, 512),    # qwen1.5-0.5b's static prefill
    (8, 1, 575, 16, 16, 64, False, 576),     # its last static dense decode
    (3, 77, 77, 4, 2, 64, True, 77),         # T and S no block multiple
    (1, 512, 512, 16, 16, 64, True, 512),    # a one-shot admission's prompt
) + tuple(  # every head width and group size of the routes, a prompt (causal and not,
    # T no multiple of the 64-row tile, k and v a prefix) and a decode token
    case for D in (32, 64, 128, 256) for G in (1, 4, 8)
    for case in ((2, 200, 200, 2 * G, 2, D, True, 208), (2, 200, 200, 2 * G, 2, D, False, 200),
                 (3, 1, 300, 2 * G, 2, D, False, 301)))

T1C_SWEEP = (  # B, N, H, Dm, kv_r, Rr, length
    (8, 576, 16, 1024, 16, 32, 575),         # qwen1.5-0.5b's static T1 decode
    (4, 300, 16, 512, 1, 64, 300),           # MLA-like: one shared roped key
    (4, 200, 8, 256, 1, 0, 150),             # no roped term, length < N
    (3, 77, 16, 1024, 16, 32, 77),           # N no multiple of the 16-key split
    (4, 300, 32, 2560, 8, 32, 299),          # past d_model 2048: qwen3-4b
    (2, 100, 24, 3072, 8, 32, 77),           # phi4-mini
    (2, 64, 32, 4096, 1, 64, 64),            # opt-6.7b / llama-vision widths
    (2, 50, 64, 8192, 8, 64, 33),            # jamba
    (2, 300, 16, 1024, 16, 32, 290),         # qwen's widths past one key split
    (2, 300, 32, 512, 8, 16, 257),           # 32 heads: two head tiles
    (2, 40, 16, 1024, 16, 32, 0),            # length 0: zeros
)
CPQC_SWEEP = (  # B, N, KV, G, Dh, bits, length
    (8, 576, 16, 1, 64, 4, 575),             # qwen1.5-0.5b's static T2 decode
    (4, 300, 4, 4, 128, 8, 250),             # G = 4, length < N
    (2, 77, 16, 1, 64, 8, 77),               # N no multiple of a split
    (2, 90, 1, 8, 256, 4, 77),               # gemma-2b: 8 heads over one kv head, Dh 256
)


def sweep_flash(fa_ops, dtype) -> dict:
    """Max abs error of B8 against its plain version per FLASH_SWEEP case."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    for B, T, S, H, KV, D, causal, arena in FLASH_SWEEP:
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                   for shape in ((B, T, H, D), (B, arena, KV, D), (B, arena, KV, D)))
        k, v = k[:, :S], v[:, :S]
        got = fa_ops.flash_attention(q, k, v, D ** -0.5, causal)
        torch.cuda.synchronize()
        ref = fa_ops.flash_attention_plain(q, k, v, D ** -0.5, causal)
        out[f"B={B} T={T} S={S} H={H} KV={KV} D={D} causal={causal}"] = (
            (got.float() - ref.float()).abs().max().item())
    return out


def sweep_t1c(t1_ops, dtype) -> dict:
    """Max abs error of B9 against its plain version per T1C_SWEEP case; each
    call must take the route its dtype and widths pick, and a length of 0
    give zeros."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    for B, N, H, Dm, kv_r, Rr, length in T1C_SWEEP:
        r, qr, x, kr = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                        for shape in ((B, H, Dm), (B, H, Rr), (B, N, Dm), (B, N, kv_r, Rr)))
        x[:, length:] = 1e3                      # unwritten slots: never read
        scale = (Dm + Rr) ** -0.5
        before = dict(t1_ops.CONTIG_ROUTE_LAUNCHES)
        got = t1_ops.decomposed_decode_fwd(r, qr, x, kr, length, scale)
        torch.cuda.synchronize()
        route = t1_ops.t1_decode_route(dtype, H, Dm, kv_r, Rr)
        moved = routes_moved(t1_ops.CONTIG_ROUTE_LAUNCHES, before)
        tag = f"B={B} N={N} H={H} Dm={Dm} kv_r={kv_r} Rr={Rr} length={length}"
        check(moved == {k: int(k == route) for k in moved},
              f"decomposed_decode {dtype} {tag}: routes {moved}, want {route}")
        check(length > 0 or not got.any().item(), f"decomposed_decode {tag}: not zero")
        ref = t1_ops.decomposed_decode_plain(r, qr, x, kr, length, scale)
        out[tag] = (got.float() - ref.float()).abs().max().item()
    return out


def sweep_cpqc(cpq_ops, dtype) -> dict:
    """Max abs error of B10 (float32 output) against its plain version per
    CPQC_SWEEP case, tiles rounded to bf16 and not; q in ``dtype``. The
    arenas hold pruned codes (-128, which dequantize to 0) and, in row 0,
    levels outside [0, L) (scale = zero = 0)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    for B, N, KV, G, Dh, bits, length in CPQC_SWEEP:
        kt = cpq_pool(gen, B, N, KV, Dh, B, bits)   # (B, N, KV, D): one page of N per row
        vt = cpq_pool(gen, B, N, KV, Dh, B, bits)
        check(bool((kt.codes == -128).any().item()), "cpq sweep: no pruned code")
        q = torch.randn((B, KV, G, Dh), generator=gen, device=DEVICE).to(dtype)
        args = (q, kt.codes, vt.codes, kt.scale, kt.zero, vt.scale, vt.zero, kt.level,
                vt.level, length, Dh ** -0.5)
        for rnd in (True, False):
            got = cpq_ops.cpq_decode_fwd(*args, rnd)
            torch.cuda.synchronize()
            ref = cpq_ops.cpq_decode_plain(*args, rnd)
            out[f"B={B} N={N} KV={KV} G={G} Dh={Dh} bits={bits} length={length} "
                f"round={rnd}"] = (got - ref).abs().max().item()
        pruned = cpq_ops.cpq_decode_fwd(*args[:2], torch.full_like(vt.codes, -128),
                                        *args[3:], True)
        check(not pruned.any().item(), "cpq_decode: all-pruned values do not give 0")
    return out


# --------------------------------------------------------- phase 4: serve


class StandIn:
    """Installed under a kernel wrapper's module-level name, passing calls
    on to the wrapper ``fn``. The wrapper counts its launches through that
    name, which is this stand-in while it is installed: keep the count on
    the wrapper."""

    fn = None

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n


class Recorder(StandIn):
    """Wraps a kernel wrapper: passes every call through, keeps the arenas of
    the first ``n_layers`` calls (one per layer) and a sample of the calls'
    small inputs, so the kernel can be timed later at the served shapes.
    ``split(*args)`` names a call's two arenas; ``snap(*args)`` copies the
    sample."""

    def __init__(self, fn, n_layers: int, every: int, split, snap):
        self.fn, self.n_layers, self.every = fn, n_layers, every
        self.split, self.snap = split, snap
        self.calls, self.arenas, self.samples = 0, [], []

    def __call__(self, *args, **kw):
        if len(self.arenas) < self.n_layers:
            self.arenas.append(self.split(*args))
        if self.calls % (self.n_layers * self.every) == 0:
            self.samples.append(self.snap(*args, **kw))
        self.calls += 1
        return self.fn(*args, **kw)


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
    prefilled a prompt chunk or a one-shot admission, ran the decode step)."""
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
        chunk = after["prefill_tokens"] > before["prefill_tokens"]  # a chunk or an admission
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


def cpq_decode_bound(q, bt, lengths, kt, vt):
    """(bytes, flops, float32 flops) one B5 call needs: the live codes and
    levels, the scale/zero tables of every row with a live key (a row of
    length 0 reads none), q and out once each, the block table and lengths;
    the attention's flops in q's type and the dequantization's float32
    multiply-adds."""
    live = lengths.long().sum().item()
    KV, Dh, Dv = kt.codes.shape[2], kt.codes.shape[3], vt.codes.shape[3]
    elt = q.element_size()
    live_rows = int((lengths > 0).sum().item())
    tables = 2 * 4 * (kt.scale[0].numel() + vt.scale[0].numel()) * live_rows
    nbytes = (live * KV * (Dh + Dv + 2 * 4) + tables + q.numel() * elt * (1 + Dv / Dh)
              + bt.numel() * 4 + lengths.numel() * 4)
    return nbytes, 2.0 * live * q.shape[2] * (Dh + Dv), 2.0 * live * KV * (Dh + Dv)


def cpq_prefill_bound(q, k_raw, offset, valid, kt, vt):
    """(bytes, flops, float32 flops) one B6 call needs: the slot's codes and
    levels before ``offset``, its tables (none at offset 0, where only the
    raw tail is attended), the chunk's raw K/V, q and out once each, the
    mapped block-table entries."""
    KV, Dh, Dv, page = kt.codes.shape[2], kt.codes.shape[3], vt.codes.shape[3], kt.codes.shape[1]
    H, elt = q.shape[2], q.element_size()
    pairs = valid * offset + sum(i + 1 for i in range(valid))
    tables = 2 * 4 * (kt.scale[0].numel() + vt.scale[0].numel()) if offset > 0 else 0
    nbytes = (offset * KV * (Dh + Dv + 2 * 4) + tables
              + k_raw.numel() * elt * (1 + Dv / Dh) + q.numel() * elt * (1 + Dv / Dh)
              + -(-offset // page) * 4)
    return nbytes, 2.0 * pairs * H * (Dh + Dv), 2.0 * offset * KV * (Dh + Dv)


def t1_decode_bound(r, qr, bt, lengths, x0, kr0):
    """(bytes, flops) one B3 call needs: the live X rows and roped keys, R
    and q_rope of the rows with a live key (a row of length 0 reads none),
    P of every row once, the block table and lengths; two products of width
    Dm and the roped one per live key and head."""
    live = lengths.long().sum().item()
    live_rows = int((lengths > 0).sum().item())
    H, Dm, Rr, elt = r.shape[1], r.shape[2], qr.shape[-1], x0.element_size()
    nbytes = (live * (Dm + kr0.shape[2] * kr0.shape[3]) * elt
              + (live_rows * H * (Dm + Rr) + r.numel()) * elt
              + bt.numel() * 4 + lengths.numel() * 4)
    return nbytes, 2.0 * live * H * (2 * Dm + Rr)


def t1_prefill_bound(r, qr, offset, valid, x0, kr0):
    """(bytes, flops) one B4 call needs: the slot's live X rows and roped
    keys, R, q_rope and P of the ``valid`` chunk rows once each (the padding
    rows' P is never read), the mapped block-table entries; flops of the
    valid rows under the causal mask."""
    C, H, Dm = r.shape
    Rr, elt, page = qr.shape[-1], x0.element_size(), x0.shape[1]
    live = offset + valid
    pairs = sum(offset + i + 1 for i in range(valid))
    nbytes = (live * (Dm + kr0.shape[2] * kr0.shape[3]) * elt
              + valid * H * (2 * Dm + Rr) * elt + -(-live // page) * 4)
    return nbytes, 2.0 * pairs * H * (2 * Dm + Rr)


def t3_bound(q, tables, bt, lengths, n, codes0):
    """(bytes, flops, float32 flops) one B7 call needs: the live codes (up
    to n per row), q, every row's proxy scale and zero tables, the scores
    written, the block table and lengths; one float32 multiply-add per live
    code and query head."""
    live = lengths.long().clamp(max=n).sum().item()
    B, H = q.shape[:2]
    KV, Dp = codes0.shape[2], codes0.shape[3]
    nbytes = (live * KV * Dp + q.numel() * q.element_size() + 2 * tables[0].numel() * 4
              + B * H * n * 4 + bt.numel() * 4 + lengths.numel() * 4)
    return nbytes, 0.0, 2.0 * live * H * Dp


def bound_of(nbytes, flops, dtype, f32_flops=0.0):
    """The least time of a call: its bytes over the memory rate, or its
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / (BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
             + f32_flops / F32_FLOPS) * 1e3
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
                     graph_ms(lib)) + bound_of(need[0], need[1], sample[0].dtype, *need[2:]))
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


def cpq_decode_case(cpq_ops, scale):
    """B5 at one sampled decode call; the yardstick is
    scaled_dot_product_attention over K/V dequantized and gathered
    beforehand, under a length mask."""
    from repro_torch.core.cpq import cpq_dequant
    from repro_torch.serving.paged_cache import logical_cpq

    def make(sample, k0, v0):
        q, bt, lengths = sample
        H, KV = q.shape[2], k0.codes.shape[2]
        kg = cpq_dequant(logical_cpq(k0, bt), q.dtype).transpose(1, 2)   # (B, KV, N, Dh)
        vg = cpq_dequant(logical_cpq(v0, bt), q.dtype).transpose(1, 2)
        mask = (torch.arange(kg.shape[2], device=q.device)[None, :]
                < lengths[:, None])[:, None, None, :]
        qq = q.transpose(1, 2)
        gqa = {"enable_gqa": True} if H != KV else {}
        return (lambda k, v: cpq_ops.paged_cpq_decode(q, k, v, bt, lengths, scale),
                lambda: cpq_ops.paged_cpq_decode_plain(q, k0, v0, bt, lengths, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kg, vg, attn_mask=mask, scale=scale, **gqa),
                cpq_decode_bound(q, bt, lengths, k0, v0))
    return make


def cpq_prefill_case(cpq_ops, scale):
    """B6 at one sampled chunk call; the yardstick is
    scaled_dot_product_attention over the slot's earlier tokens,
    dequantized and gathered beforehand, and the chunk's raw K/V, with the
    chunk's causal mask."""
    from repro_torch.core.cpq import cpq_dequant
    from repro_torch.serving.paged_cache import _slot_cpq

    def make(sample, k0, v0):
        q, k_raw, v_raw, slot, row, offset, valid = sample
        H, KV, C = q.shape[2], k0.codes.shape[2], q.shape[1]
        kg = torch.cat([cpq_dequant(_slot_cpq(k0, row, slot), q.dtype)[:, :offset], k_raw], 1)
        vg = torch.cat([cpq_dequant(_slot_cpq(v0, row, slot), q.dtype)[:, :offset], v_raw], 1)
        col = torch.arange(offset + C, device=q.device)[None, :] - offset
        tok = torch.arange(C, device=q.device)[:, None]
        mask = (col < 0) | ((col < valid) & (col <= tok))
        qq = q.transpose(1, 2)
        gqa = {"enable_gqa": True} if H != KV else {}
        return (lambda k, v: cpq_ops.paged_cpq_prefill(q, k, v, k_raw, v_raw, slot, row,
                                                       offset, valid, scale),
                lambda: cpq_ops.paged_cpq_prefill_plain(q, k0, v0, k_raw, v_raw, slot, row,
                                                        offset, valid, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kg.transpose(1, 2), vg.transpose(1, 2), attn_mask=mask[None, None],
                    scale=scale, **gqa),
                cpq_prefill_bound(q, k_raw, offset, valid, k0, v0))
    return make


def _t1_sdpa_operands(r, qr, xg, krg):
    """The yardstick's operands for T1: q = [R | q_rope], k = [X | the head's
    roped key], v = X, heads laid out (N, H, keys, width); xg (N, n, Dm) and
    krg (N, n, kv_r, Rr) are gathered beforehand."""
    N, H, n = r.shape[0], r.shape[-2], xg.shape[1]
    k_rope = krg.repeat_interleave(H // krg.shape[2], dim=2).transpose(1, 2)  # (N, H, n, Rr)
    x = xg[:, None].expand(N, H, n, xg.shape[2])
    return (torch.cat([r, qr], -1).transpose(-3, -2),
            torch.cat([x, k_rope], -1).contiguous(), x.contiguous())


def t1_decode_case(t1_ops, scale):
    """B3 at one sampled decode call (the sweep: R and P W_V are einsums
    outside it); the yardstick is scaled_dot_product_attention with
    q = [R | q_rope], k = [X | roped key of the head] and v = X gathered
    beforehand, under a length mask: the same function."""
    from repro_torch.serving.paged_cache import gather_pages

    def make(sample, x0, kr0):
        r, qr, bt, lengths = sample
        qq, kk, vv = _t1_sdpa_operands(r[:, None], qr[:, None], gather_pages(x0, bt),
                                       gather_pages(kr0, bt))
        mask = (torch.arange(kk.shape[2], device=r.device)[None, :]
                < lengths[:, None])[:, None, None, :]
        return (lambda x, kr: t1_ops.paged_decomposed_decode_fwd(r, qr, x, kr, bt, lengths,
                                                                 scale),
                lambda: t1_ops.paged_decomposed_decode_plain(r, qr, x0, kr0, bt, lengths,
                                                             scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask, scale=scale),
                t1_decode_bound(r, qr, bt, lengths, x0, kr0))
    return make


def t1_prefill_case(t1_ops, scale):
    """B4 at one sampled chunk call; the yardstick is
    scaled_dot_product_attention on the slot's gathered [X | roped key] and
    X with the chunk's causal mask."""
    from repro_torch.serving.paged_cache import gather_pages

    def make(sample, x0, kr0):
        r, qr, row, offset, valid = sample
        C, n = r.shape[0], offset + valid
        qq, kk, vv = _t1_sdpa_operands(r[None], qr[None], gather_pages(x0, row[None])[:, :n],
                                       gather_pages(kr0, row[None])[:, :n])
        pos = torch.arange(n, device=r.device)
        mask = pos[None, :] <= offset + torch.arange(C, device=r.device)[:, None]
        return (lambda x, kr: t1_ops.paged_decomposed_prefill_fwd(r, qr, x, kr, row, offset,
                                                                  valid, scale),
                lambda: t1_ops.paged_decomposed_prefill_plain(r, qr, x0, kr0, row, offset,
                                                              valid, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask[None, None], scale=scale),
                t1_prefill_bound(r, qr, offset, valid, x0, kr0))
    return make


def t3_decode_case(t3_ops):
    """B7 at one sampled decode call (the served ``paged_proxy_scores``: one
    launch that forms the query factors from the query slice and its scale,
    then scores); the yardstick is torch.matmul of the query factors,
    formed beforehand, against the rows' codes gathered, shifted by 128 and
    converted to float32 beforehand, plus qz: the same scores, unmasked."""
    from repro_torch.serving.paged_cache import gather_pages

    def make(sample, codes0, tables0):
        q, bt, lengths, n, q_scale = sample
        q_eff = q if q_scale is None else q * q_scale
        qs, qz = t3_ops.query_factors(q_eff, *tables0)
        cg = (gather_pages(codes0, bt)[:, :n].float() + 128.0).permute(0, 2, 3, 1).contiguous()
        return (lambda codes, tables: t3_ops.paged_proxy_scores(q, *tables, codes, bt,
                                                                 lengths, n, q_scale=q_scale),
                lambda: t3_ops.paged_proxy_scores_plain(q_eff, *tables0, codes0, bt, lengths,
                                                        n),
                lambda: torch.matmul(qs, cg) + qz,
                t3_bound(q, tables0, bt, lengths, n, codes0))
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
        attn = sum(ms for k, ms, _ in kernels if any(a in k for a in ATTENTION_KERNELS))
        gemm = sum(ms for k, ms, _ in kernels if any(g in k for g in ("gemm", "nvjet", "cutlass", "xmma")))
        out.append({"ticks": [lo, hi], "decode_only_ticks": sum(1 for t in ticks[lo:hi] if not t[2]),
                    "device_busy_ms": busy, "unprofiled_wall_ms": wall,
                    "busy_share": busy / wall, "attn_ms": attn, "gemm_ms": gemm,
                    "top_kernels": [{"name": k, "ms": ms, "count": n}
                                    for k, ms, n in kernels[:12]]})
    return out


def log_profile(what: str, prof: list[dict]) -> None:
    for w in prof:
        n = w["ticks"][1] - w["ticks"][0]
        log(f"profile {what} ticks {w['ticks']} ({w['decode_only_ticks']} decode-only): "
            f"device busy {w['device_busy_ms']:.2f} ms of {w['unprofiled_wall_ms']:.2f} ms "
            f"wall = {w['busy_share']:.1%}; {w['device_busy_ms'] / n:.3f} ms device and "
            f"{w['unprofiled_wall_ms'] / n:.3f} ms wall per tick; attention kernels "
            f"{w['attn_ms']:.2f} ms, GEMMs {w['gemm_ms']:.2f} ms")
        for k in w["top_kernels"][:6]:
            log(f"profile:   {k['ms']:8.3f} ms {k['count']:5d}x {k['name'][:100]}")


def zero_routes(routed: dict) -> None:
    for counter, _ in routed.values():
        for r in counter:
            counter[r] = 0


def check_routes(what: str, routed: dict, counts: dict) -> dict:
    """Every launch of a kernel with two routes took the route a bf16 serve
    gives it (B2, B3, B4, B6 and B9 the tensor cores, B5 the single-query
    decode, B1 the ring):
    each route counter against the wrapper's launches. Returns the route
    counts by kernel."""
    routes = {name: dict(counter) for name, (counter, _) in routed.items()}
    for name, got in routes.items():
        n, served = counts.get(name, 0), routed[name][1]
        check(got == {r: n * (r == served) for r in got},
              f"{what}: {name} routes {got} for {n} launches, want all {served}")
    return routes


def mid_decode_window(ticks) -> tuple[int, int]:
    """10 ticks around the middle decode-only tick of a served run."""
    pure = [i for i, t in enumerate(ticks) if t[3] and not t[2]]
    return pure[len(pure) // 2 - 5], pure[len(pure) // 2 + 5]


# ------------------------------------------ phase 4: the contiguous path


def static_prompts(vocab: int) -> np.ndarray:
    """The static serve's batch: 8 prompts of 512 seeded tokens."""
    return np.random.default_rng(SEED + 1).integers(0, vocab, size=(8, 512)).astype(np.int32)


def arena_of(t: torch.Tensor) -> torch.Tensor:
    """The whole (B, N, KV, D) arena that a (B, S, KV, D) prefix view lies in."""
    B, _, KV, D = t.shape
    return torch.as_strided(t, (B, t.stride(0) // (KV * D), KV, D), t.stride())


class FlashRecorder(StandIn):
    """B8's Recorder: its prompt calls (T > 1, causal over fresh K/V) and its
    decode calls (one query token over the written prefix of the static
    dense arena) are sampled apart. A decode sample keeps the prefix length;
    its arena is the layer's whole arena."""

    def __init__(self, fn, n_layers: int):
        self.fn = fn
        self.pre = Recorder(fn, n_layers, 1, lambda q, k, v, *r: (k, v),
                            lambda q, k, v, *r: (q.clone(),))
        self.dec = Recorder(fn, n_layers, 10, lambda q, k, v, *r: (arena_of(k), arena_of(v)),
                            lambda q, k, v, *r: (q.clone(), k.shape[1]))

    def __call__(self, q, k, v, scale, causal=True):
        return (self.pre if q.shape[1] > 1 else self.dec)(q, k, v, scale, causal)


class StepTimer:
    """Wraps the model's ``prefill`` and ``decode_step``: the device-synced
    wall time of every call, and the caches the last call returned."""

    def __init__(self, M):
        self.M, self.pre, self.dec = M, M.prefill, M.decode_step
        self.prefill_ms, self.step_ms, self.caches = [], [], None

    def _timed(self, fn, out):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            self.caches = r[1]
            return r
        return run

    def __enter__(self):
        self.M.prefill = self._timed(self.pre, self.prefill_ms)
        self.M.decode_step = self._timed(self.dec, self.step_ms)
        return self

    def __exit__(self, *exc):
        self.M.prefill, self.M.decode_step = self.pre, self.dec


def device_bytes(tree) -> int:
    """Bytes of the CUDA tensors of a cache tree (a container's length lives
    on the host)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size() if tree.is_cuda else 0
    if isinstance(tree, dict):
        tree = list(tree.values())
    return sum(device_bytes(t) for t in tree)


def counted_launches(counted: list, routes: dict) -> dict:
    """The launch counts of ``counted`` (module, wrapper name) pairs, and of
    B8's routes as ``flash_attention/<route>``."""
    return {**{name: getattr(mod, name).launches for mod, name in counted},
            **{f"flash_attention/{r}": n for r, n in routes.items()}}


def zero_launches(counted: list, routes: dict) -> None:
    for mod, name in counted:
        getattr(mod, name).launches = 0
    for r in routes:
        routes[r] = 0


def serve_static(eng, T, M, prompts, n_new: int, recorders: dict, counted: list,
                 routes: dict):
    """One static generate with each kernel wrapper replaced by its Recorder,
    every launch count of ``counted`` (module, wrapper name) pairs and of
    B8's ``routes`` set to 0 just before and read just after. Returns
    (tokens, stats, StepTimer, wall s, counts)."""
    for name, (mod, rec) in recorders.items():
        setattr(mod, name, rec)
    zero_launches(counted, routes)
    try:
        with StepTimer(M) as timer:
            t0 = time.perf_counter()
            out, stats = eng.generate({"tokens": prompts}, T.GenerationConfig(max_new_tokens=n_new))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for name, (mod, rec) in recorders.items():
            setattr(mod, name, rec.fn)
    return out, stats, timer, wall, counted_launches(counted, routes)


def static_metrics(out, stats, timer, wall, what: str) -> dict:
    step = float(np.median(timer.step_ms))
    B = out.shape[0]
    m = {"prefill_ms": timer.prefill_ms[0], "decode_steps": stats["decode_steps"],
         "decode_step_ms_median": step,
         "decode_step_ms_p90": float(np.percentile(timer.step_ms, 90)),
         "decode_tokens_per_s": B / step * 1e3, "generated_tokens": stats["generated_tokens"],
         "serve_wall_s": wall, "end_to_end_tokens_per_s": stats["generated_tokens"] / wall,
         "arena_bytes": device_bytes(timer.caches)}
    log(f"serve static {what}: prefill {m['prefill_ms']:.3f} ms; decode step median "
        f"{step:.3f} ms (p90 {m['decode_step_ms_p90']:.3f}) over {len(timer.step_ms)} steps "
        f"of {B} rows = {m['decode_tokens_per_s']:.1f} tokens/s; end to end "
        f"{m['end_to_end_tokens_per_s']:.1f} tokens/s over {wall:.2f} s; arena "
        f"{m['arena_bytes'] / 1e9:.3f} GB")
    return m


def flash_bound(q, S, KV, Dv, causal):
    """(bytes, flops) one B8 call needs: q, the S keys and values, out once
    each; 2 (Dh + Dv) flops per (query, key) pair it sees (causal: key j <=
    query i, T == S)."""
    B, T, H, Dh = q.shape
    elt = q.element_size()
    pairs = T * (T + 1) // 2 if causal else T * S
    nbytes = (q.numel() + B * S * KV * (Dh + Dv) + B * T * H * Dv) * elt
    return nbytes, 2.0 * B * H * pairs * (Dh + Dv)


def flash_prefill_case(fa_ops, scale):
    """B8 at a sampled prompt call; the yardstick is causal
    scaled_dot_product_attention on the same q, k, v."""
    def make(sample, k0, v0):
        (q,) = sample
        gqa = {"enable_gqa": True} if q.shape[2] != k0.shape[2] else {}
        return (lambda k, v: fa_ops.flash_attention(q, k, v, scale, True),
                lambda: fa_ops.flash_attention_plain(q, k0, v0, scale, True),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k0.transpose(1, 2), v0.transpose(1, 2), is_causal=True,
                    scale=scale, **gqa),
                flash_bound(q, k0.shape[1], k0.shape[2], v0.shape[3], True))
    return make


def flash_decode_case(fa_ops, scale):
    """B8 at a sampled static dense decode call, over the first S keys of
    each layer's arena; the yardstick is scaled_dot_product_attention on the
    same prefix."""
    def make(sample, k0, v0):
        q, S = sample
        gqa = {"enable_gqa": True} if q.shape[2] != k0.shape[2] else {}
        return (lambda k, v: fa_ops.flash_attention(q, k[:, :S], v[:, :S], scale, False),
                lambda: fa_ops.flash_attention_plain(q, k0[:, :S], v0[:, :S], scale, False),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k0[:, :S].transpose(1, 2), v0[:, :S].transpose(1, 2),
                    scale=scale, **gqa),
                flash_bound(q, S, k0.shape[2], v0.shape[3], False))
    return make


def t1c_bound(r, qr, length, x0, kr0):
    """(bytes, flops) one B9 call needs: the first ``length`` X rows and
    roped keys of every row, R and q_rope, P once each."""
    B, H, Dm = r.shape
    elt = x0.element_size()
    nbytes = (B * length * (Dm + kr0.shape[2] * kr0.shape[3]) + r.numel() + qr.numel()
              + B * H * Dm) * elt
    return nbytes, 2.0 * B * length * H * (2 * Dm + qr.shape[-1])


def t1c_decode_case(t1_ops, scale):
    """B9 at a sampled static T1 decode call; the yardstick is
    scaled_dot_product_attention with q = [R | q_rope], k = [X | roped key],
    v = X over the written prefix, as for B3."""
    def make(sample, x0, kr0):
        r, qr, length = sample
        qq, kk, vv = _t1_sdpa_operands(r[:, None], qr[:, None], x0[:, :length],
                                       kr0[:, :length])
        return (lambda x, kr: t1_ops.decomposed_decode_fwd(r, qr, x, kr, length, scale),
                lambda: t1_ops.decomposed_decode_plain(r, qr, x0, kr0, length, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(qq, kk, vv,
                                                                         scale=scale),
                t1c_bound(r, qr, length, x0, kr0))
    return make


def cpqc_bound(q, length, kt, vt):
    """(bytes, flops, float32 flops) one B10 call needs: the first
    ``length`` codes and levels of every row, every row's tables, q (float32)
    and out once each; the attention's and the dequantization's float32
    operations."""
    B, KV, G, Dh = q.shape
    Dv = vt.codes.shape[3]
    nbytes = (B * length * KV * (Dh + Dv + 2 * 4) + 2 * 4 * (kt.scale.numel() + vt.scale.numel())
              + 4 * (q.numel() + B * KV * G * Dv))
    return nbytes, 0.0, 2.0 * B * length * KV * (G + 1) * (Dh + Dv)


def cpqc_decode_case(cpq_ops, scale):
    """B10 at a sampled static T2 decode call (rounded tiles, the served
    function); the yardstick is scaled_dot_product_attention on K/V
    dequantized (to bf16) and sliced to the written prefix beforehand."""
    from repro_torch.core.cpq import cpq_dequant

    def make(sample, kt0, vt0):
        q, length = sample                      # q (B, KV, G, Dh) float32
        B, KV, G, Dh = q.shape
        kg = cpq_dequant(kt0)[:, :length].transpose(1, 2)   # (B, KV, n, Dh) bf16
        vg = cpq_dequant(vt0)[:, :length].transpose(1, 2)
        qq = q.reshape(B, KV * G, 1, Dh).to(torch.bfloat16)
        gqa = {"enable_gqa": True} if G > 1 else {}

        def kern(kt, vt):
            return cpq_ops.cpq_decode_fwd(q, kt.codes, vt.codes, kt.scale, kt.zero, vt.scale,
                                          vt.zero, kt.level, vt.level, length, scale, True)
        return (kern,
                lambda: cpq_ops.cpq_decode_plain(q, kt0.codes, vt0.codes, kt0.scale, kt0.zero,
                                                 vt0.scale, vt0.zero, kt0.level, vt0.level,
                                                 length, scale, True),
                lambda: torch.nn.functional.scaled_dot_product_attention(qq, kg, vg,
                                                                         scale=scale, **gqa),
                cpqc_bound(q, length, kt0, vt0))
    return make


def profile_static(make_engine, T, M, prompts, n_new, step_ms, lo: int, hi: int) -> dict:
    """Replays the static serve and profiles decode steps lo .. hi-1 with
    torch.profiler: device time by kernel and the device's busy share of
    those steps' unprofiled wall time (``step_ms`` of the measured run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng, dec, calls = make_engine(), M.decode_step, [0]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def step(*a, **kw):
        if calls[0] == lo:
            torch.cuda.synchronize()
            prof.__enter__()
        r = dec(*a, **kw)
        calls[0] += 1
        if calls[0] == hi:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        return r

    M.decode_step = step
    try:
        eng.generate({"tokens": prompts}, T.GenerationConfig(max_new_tokens=n_new))
    finally:
        M.decode_step = dec
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
                     key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kernels)
    wall = sum(step_ms[lo:hi])
    attn = sum(ms for k, ms, _ in kernels if any(a in k for a in ATTENTION_KERNELS))
    gemm = sum(ms for k, ms, _ in kernels if any(g in k for g in ("gemm", "nvjet", "cutlass", "xmma")))
    return {"ticks": [lo, hi], "decode_only_ticks": hi - lo, "device_busy_ms": busy,
            "unprofiled_wall_ms": wall, "busy_share": busy / wall, "attn_ms": attn,
            "gemm_ms": gemm, "top_kernels": [{"name": k, "ms": ms, "count": n}
                                             for k, ms, n in kernels[:12]]}


def encode_parity(k, v, cpq_cfg, t3_cfg, split: int) -> dict:
    """The T2 and T3 encoders on the card against the same on the CPU (no
    gate): one layer's K/V history (B, N, KV, D), its first ``split`` tokens
    compressed at once (``cpq_compress_prefill``; T3: ``fit_proxy``), the
    rest appended token by token (``cpq_append_decode``, which may spawn HQE
    levels; T3: ``encode_proxy``), as the static engine does. Returns how
    many codes, levels and tables differ between the two devices."""
    from repro_torch.core import cpq as C
    from repro_torch.core import retrieval_attention as R

    def hqe(x):
        t = C.cpq_compress_prefill(x[:, :split], cpq_cfg, x.shape[1])
        for pos in range(split, x.shape[1]):
            t = C.cpq_append_decode(t, x[:, pos:pos + 1], pos, cpq_cfg)
        return t

    def proxy(x):
        dp = t3_cfg.proxy_dim or x.shape[-1]
        codes, sc, z = R.fit_proxy(x[:, :split, :, :dp], t3_cfg.proxy_bits)
        return codes, R.encode_proxy(x[:, split:, :, :dp], sc, z, t3_cfg.proxy_bits), sc, z

    out = {}
    for name, x in (("K", k), ("V", v)):
        card, cpu = hqe(x), hqe(x.cpu())
        out[f"hqe {name}"] = {
            "codes": card.codes.numel(),
            "codes_differ": int((card.codes.cpu() != cpu.codes).sum()),
            "levels_differ": int((card.level.cpu() != cpu.level).sum()),
            "num_levels_differ": int((card.num_levels.cpu() != cpu.num_levels).sum()),
            "table_max_abs_diff": max((card.scale.cpu() - cpu.scale).abs().max().item(),
                                      (card.zero.cpu() - cpu.zero).abs().max().item())}
    card, cpu = proxy(k), proxy(k.cpu())
    out["proxy K"] = {
        "codes": card[0].numel() + card[1].numel(),
        "fit_codes_differ": int((card[0].cpu() != cpu[0]).sum()),
        "encode_codes_differ": int((card[1].cpu() != cpu[1]).sum()),
        "table_max_abs_diff": max((card[2].cpu() - cpu[2]).abs().max().item(),
                                  (card[3].cpu() - cpu[3]).abs().max().item())}
    return out


# -------------------------------------------------------- phase 5: parity


class SharedKV:
    """Lockstep runs on one history. While recording, every attention call
    keeps the K/V it writes into its arena (paged: a decode token or a
    prompt chunk; contiguous: a whole prompt or a decode token); while
    replaying, the matching call of the second run writes those instead of
    its own. Both runs then attend over arenas of the same contents, each
    with its own queries."""

    def __init__(self):
        from repro_torch.core import attention as core_attn
        from repro_torch.serving import paged_cache as pgc

        self.pgc, self.core, self.kept, self.record = pgc, core_attn, [], True
        self.decode, self.chunk = pgc.decode_attend_paged, pgc.chunk_attend_paged
        self.c_prefill, self.c_decode = core_attn.prefill_into_cache, core_attn.decode_attend

    def _take(self, k, v):
        if self.record:
            self.kept.append((k, v))
            return k, v
        return self.kept.pop(0)

    def __enter__(self):
        def decode(rt, cache, rows, *, k_t, v_t, **kw):
            k_t, v_t = self._take(k_t, v_t)
            return self.decode(rt, cache, rows, k_t=k_t, v_t=v_t, **kw)

        def chunk(rt, cache, *, k_c, v_c, **kw):
            k_c, v_c = self._take(k_c, v_c)
            return self.chunk(rt, cache, k_c=k_c, v_c=v_c, **kw)

        def c_prefill(rt, cache, *, k, v, **kw):
            k, v = self._take(k, v)
            return self.c_prefill(rt, cache, k=k, v=v, **kw)

        def c_decode(rt, cache, *, k_t, v_t, **kw):
            k_t, v_t = self._take(k_t, v_t)
            return self.c_decode(rt, cache, k_t=k_t, v_t=v_t, **kw)

        self.pgc.decode_attend_paged, self.pgc.chunk_attend_paged = decode, chunk
        self.core.prefill_into_cache, self.core.decode_attend = c_prefill, c_decode
        return self

    def __exit__(self, *exc):
        self.pgc.decode_attend_paged, self.pgc.chunk_attend_paged = self.decode, self.chunk
        self.core.prefill_into_cache, self.core.decode_attend = self.c_prefill, self.c_decode


def pair(recorders, first_fn, second_fn):
    """Run ``first_fn`` with every lockstep recorder (SharedKV,
    SelectionPin) recording, then ``second_fn`` replaying it."""
    for r in recorders:
        r.record = True
    a = first_fn()
    for r in recorders:
        r.record = False
    b = second_fn()
    check(not any(r.kept for r in recorders), "parity: the two runs made different calls")
    return a, b


class TopkWitness(StandIn):
    """Installed in place of the served B7 wrapper ``paged_proxy_scores``:
    on every ``every``-th decode tick (all layers), the call's inputs are
    also scored by B7's plain version and by the gather path's
    ``proxy_scores`` (the reference's einsum order over the gathered codes),
    each picks its top-k as the engine does, and the (row, head, layer)
    sets that differ from the kernel's are counted: rows whose proxy scores
    lie within an ulp at the top-k boundary can swap a key. A witness only;
    nothing is gated on it."""

    def __init__(self, t3_ops, cfg, n_layers: int, every: int = 8):
        from repro_torch.core import retrieval_attention as ret_lib
        from repro_torch.serving.paged_cache import gather_pages

        self.ops, self.cfg, self.n_layers, self.every = t3_ops, cfg, n_layers, every
        self.fn = t3_ops.paged_proxy_scores
        self.ret_lib, self.gather_pages = ret_lib, gather_pages
        self.select = ret_lib.select_topk
        self.calls = self.sets = self.differ_plain = self.differ_gather = 0

    def __enter__(self):
        self.ops.paged_proxy_scores = self
        return self

    def __exit__(self, *exc):
        self.ops.paged_proxy_scores = self.fn

    def _sets(self, s, lengths):
        return self.select(s[:, None], lengths, self.cfg)[:, 0].sort(-1).values

    def __call__(self, q, sc, z, codes, bt, lengths, n, q_scale=None):
        out = self.fn(q, sc, z, codes, bt, lengths, n, q_scale=q_scale)
        q = q if q_scale is None else q * q_scale  # the pre-scaled query, as served
        if (self.calls // self.n_layers) % self.every == 0:
            plain = self.ops.paged_proxy_scores_plain(q, sc, z, codes, bt, lengths, n)
            gather = self.ret_lib.proxy_scores(
                q[:, None], self.gather_pages(codes, bt)[:, :n], sc, z)[:, 0]
            kern, live = self._sets(out, lengths), lengths > 0
            self.sets += int(live.sum().item()) * q.shape[1]
            for name, other in (("differ_plain", plain), ("differ_gather", gather)):
                differ = (self._sets(other, lengths) != kern).any(-1)[live]
                setattr(self, name, getattr(self, name) + int(differ.sum().item()))
        self.calls += 1
        return out


class SelectionPin:
    """T3's top-k choices in lockstep across the two paths of a parity run.
    While recording (the kernel path), every ``select_topk`` call keeps its
    choice; while replaying (the gather path), the matching call makes its
    own choice from its own proxy scores, measures how far it is from the
    recorded one, and returns the recorded one, so both paths attend the
    same keys. Where the two choices differ, ``gap`` is how far the gather
    path's own scores rank the keys only it picked above those only the
    kernel path picked, relative to the largest live |score| of that (row,
    head): a swap at a near-tie of the boundary has a gap near 0."""

    def __init__(self):
        from repro_torch.core import retrieval_attention as ret_lib

        self.ret_lib, self.select = ret_lib, ret_lib.select_topk
        self.kept, self.record = [], True
        self.sets = self.differ = 0
        self.max_gap = 0.0

    def __enter__(self):
        self.ret_lib.select_topk = self._call
        return self

    def __exit__(self, *exc):
        self.ret_lib.select_topk = self.select

    def _call(self, s_proxy, length, cfg, query_positions=None):
        idx = self.select(s_proxy, length, cfg, query_positions)
        if self.record:
            self.kept.append(idx)
            return idx
        pinned = self.kept.pop(0)
        own = torch.zeros(s_proxy.shape, dtype=torch.bool, device=idx.device)
        own.scatter_(-1, idx, True)
        pin = torch.zeros_like(own).scatter_(-1, pinned, True)
        differ = (own != pin).any(-1)
        live = torch.arange(s_proxy.shape[-1], device=idx.device) < torch.as_tensor(
            length, device=idx.device).reshape(-1, 1, 1, 1)
        self.sets += int(live.any(-1).expand(differ.shape).sum().item())
        if differ.any():
            hi = torch.where(own & ~pin, s_proxy, -torch.inf).amax(-1)[differ]
            lo = torch.where(pin & ~own, s_proxy, torch.inf).amin(-1)[differ]
            top = torch.where(live, s_proxy.abs(), 0.0).amax(-1)[differ]
            self.differ += int(differ.sum().item())
            self.max_gap = max(self.max_gap, ((hi - lo) / top).max().item())
        return pinned


def top2_gap(logits: torch.Tensor) -> torch.Tensor:
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def gather_gaps(M, eng, gaps: dict):
    """``eng.step`` that also files the gather path's top-2 logit gap of
    every token it emits under (rid, index). A tick emits its admissions'
    first tokens before the decode step's: chunked, the tick's last prompt
    chunk's (one chunk per tick); one-shot, each admission's prefill, in
    order; then the decode step's tokens in slot order."""
    seen = {}
    dec, chunk, pre = M.decode_step_rows, M.prefill_chunk_rows, M.prefill

    def keep_decode(*a):
        out = dec(*a)
        seen["decode"] = (top2_gap(out[0]).tolist(), a[4].active.nonzero()[:, 0].tolist())
        return out

    def keep_chunk(*a):
        out = chunk(*a)
        seen["chunk"] = top2_gap(out[0][0]).item()
        return out

    def keep_prefill(*a, **kw):
        out = pre(*a, **kw)
        seen["oneshot"].append(top2_gap(out[0][0]).item())
        return out

    def step():
        seen.clear()
        seen["oneshot"] = []
        M.decode_step_rows, M.prefill_chunk_rows, M.prefill = keep_decode, keep_chunk, keep_prefill
        try:
            events = eng.step()
        finally:
            M.decode_step_rows, M.prefill_chunk_rows, M.prefill = dec, chunk, pre
        admitted = len(seen["oneshot"])
        for e, g in zip(events, seen["oneshot"]):
            gaps[(e.rid, e.index)] = g
        decoded = [e for e in events[admitted:] if admitted or e.index > 0]
        if decoded:
            row_gaps, slots = seen["decode"]
            for e, slot in zip(decoded, slots):
                gaps[(e.rid, e.index)] = row_gaps[slot]
        for e in events[admitted:]:
            if not admitted and e.index == 0:
                gaps[(e.rid, 0)] = seen["chunk"]
        return events
    return step


def first_logits(M, cfg, rt, params, reqs, small, bt):
    """Two slots (the shortest and the longest prompt) streamed chunk by
    chunk through prefill_chunk_rows, or admitted one-shot when
    ``small.prefill_chunk`` is 0 (the prompt padded to the bucket, prefilled
    as a B=1 contiguous cache and packed into its pages), then one decode
    step: the prompt logits of each slot (2, V) and the decode logits (2, V)."""
    from repro_torch.serving.paged_cache import RowState

    caches = M.init_paged_caches(cfg, rt, small, DEVICE)
    C, bucket = small.prefill_chunk, small.prefill_bucket
    pre = []
    for s in range(2):
        ctx, row = reqs[s].prompt, torch.tensor(bt[s], device=DEVICE)
        if not C:
            n = len(ctx)
            pad = max(bucket, -(-n // bucket) * bucket)
            tok = np.concatenate([ctx, np.full(pad - n, ctx[-1], np.int32)])
            logits, ctg = M.prefill(cfg, rt, params, torch.tensor(tok[None], device=DEVICE),
                                    M.init_caches(cfg, rt, 1, pad, DEVICE), last_index=n - 1)
            M.pack_prefill_caches(cfg, rt, caches, ctg, row, s)
        for off in range(0, len(ctx), C) if C else ():
            valid = min(C, len(ctx) - off)
            tok = np.concatenate([ctx[off:off + valid],
                                  np.full(C - valid, ctx[off + valid - 1], np.int32)])
            logits, _ = M.prefill_chunk_rows(cfg, rt, 0, off == 0, params,
                                             torch.tensor(tok[None], device=DEVICE), s, row,
                                             off, valid, caches)
        pre.append(logits)
    first = torch.cat([p.argmax(-1) for p in pre]).to(torch.int32)
    lens = [len(reqs[0].prompt), len(reqs[1].prompt)]
    rows = RowState(lengths=torch.tensor(lens, dtype=torch.int32, device=DEVICE),
                    block_table=torch.tensor(bt, device=DEVICE),
                    active=torch.ones(2, dtype=torch.bool, device=DEVICE),
                    tier=torch.zeros(2, dtype=torch.int32, device=DEVICE))
    dec, _ = M.decode_step_rows(cfg, rt, params, first[:, None], rows, caches)
    return torch.cat(pre), dec


def max_diff(got) -> dict:
    return {f"{name}_logits_max_abs_diff": (got[0][i] - got[1][i]).abs().max().item()
            for i, name in enumerate(("prefill", "first-decode"))}


def parity(T, M, cfg, params, reqs, mode: str, rt_kw=None, serving_kw=None) -> dict:
    """Kernels on vs the gather path in float32 for attention ``mode`` (with
    the runtime's other settings ``rt_kw`` and the serving ones
    ``serving_kw``: ``prefill_chunk=0`` admits one-shot):
    chunked-prefill and first-decode logits of two slots, then the greedy
    streams of the served requests. Dense and decomposed (T1, which
    re-quantizes nothing) run each path on its own history. CPQ runs the two
    in lockstep on one history (SharedKV): each path compresses the K/V it
    computed, which differ in the last ulp, and 4-bit codes can turn that
    into whole quantization steps, which the next layer's K/V then carry
    (PERF.md). T3 (retrieval) runs in lockstep too, for the same reason
    (int8 proxy codes of K/V that differ in the last ulp differ by a whole
    step), and with its top-k choices pinned (``SelectionPin``): the two
    paths' queries still differ in the last ulps, which can swap a key at
    the top-k boundary, and one swap moves the next logits by ~1e-3
    (PERF.md). So the gather path attends the keys the kernel path chose,
    every choice of its own that differs must differ by a swap within
    TOPK_GAP of the boundary, and the logits and streams are held as for
    the other modes; the unpinned first-decode logits are reported."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = (True, False)
    rts = {fused: T.AttentionRuntime(mode=mode, paged_kernels=fused, **(rt_kw or {}))
           for fused in paths}
    lockstep, pinned = mode in ("cpq", "retrieval"), mode == "retrieval"
    what = mode if (serving_kw or {}).get("prefill_chunk", 1) else f"oneshot {mode}"
    small = T.ServingCfg(num_slots=2, page_size=16, num_pages=80, max_blocks_per_slot=64,
                         **(serving_kw or {}))
    bt = np.zeros((2, 64), np.int32)
    lens = [len(reqs[0].prompt), len(reqs[1].prompt)]
    perm = np.random.default_rng(SEED).permutation(np.arange(1, 80))
    bt[0, :lens[0] // 16 + 1] = perm[:lens[0] // 16 + 1]
    bt[1, :lens[1] // 16 + 1] = perm[40:40 + lens[1] // 16 + 1]
    run = {f: (lambda f=f: first_logits(M, cfg, rts[f], params, reqs, small, bt))
           for f in paths}
    out = {}
    if pinned:
        with SharedKV() as shared:
            own = pair([shared], run[True], run[False])
        err = (own[0][1] - own[1][1]).abs().max().item()
        out["unpinned_first-decode_logits_max_abs_diff"] = err
        log(f"parity {what}: unpinned first-decode_logits_max_abs_diff {err:.3e} (no gate)")
    if lockstep:
        with SharedKV() as shared, pin_if(pinned) as pin:
            got = pair([shared] + [pin] * pinned, run[True], run[False])
        if pinned:
            out.update(pin_report(what, "first logits", pin))
    else:
        got = (run[True](), run[False]())
    check_logits(what, got, out)

    serving = T.ServingCfg(num_slots=8, page_size=16, num_pages=513,
                           max_blocks_per_slot=64, **(serving_kw or {}))
    engs = {f: T.ContinuousServeEngine(cfg, params, rt=rts[f], serving=serving,
                                       device=DEVICE) for f in paths}
    for eng in engs.values():
        eng.reset(T.GenerationConfig())
        for r in make_requests(T, cfg.vocab_size):
            eng.add_request(r)
    gaps = {}
    step = gather_gaps(M, engs[False], gaps)
    if lockstep:
        with SharedKV() as shared, pin_if(pinned) as pin:
            while engs[True].has_unfinished():
                pair([shared] + [pin] * pinned, engs[True].step, step)
        if pinned:
            out.update(pin_report(what, "streams", pin))
    else:
        while engs[True].has_unfinished():
            engs[True].step()
        while engs[False].has_unfinished():
            step()
    streams = {f: {rid: res["tokens"] for rid, res in engs[f].results().items()} for f in paths}
    del engs
    out["streams_identical"] = compare_streams(what, streams, gaps,
                                               {r.rid: r.max_new_tokens for r in reqs})
    out["lockstep"] = lockstep
    return out


def compare_streams(mode: str, streams: dict, gaps: dict, lengths: dict) -> int:
    """Greedy streams of the kernel path (``streams[True]``) and the gather
    path, by request id: identical, but for a first divergence where the
    gather path's top-2 logit gap is below ARGMAX_GAP. Returns the number
    of identical streams."""
    excused = 0
    for rid, n in lengths.items():
        a, b = streams[True][rid], streams[False][rid]
        check(len(a) == len(b) == n, f"parity {mode}: request {rid} lengths")
        diff = np.flatnonzero(a != b)
        if not len(diff):
            continue
        t = int(diff[0])   # after a divergence the contexts differ: stop there
        gap = gaps[(rid, t)]
        log(f"parity {mode}: request {rid} diverges at token {t}: kernels {a[t]} vs "
            f"gather {b[t]}, gather top-2 gap {gap:.3e}")
        check(gap < ARGMAX_GAP, f"parity {mode}: request {rid} token {t} differs at a "
              f"resolvable gap {gap:.3e}")
        excused += 1
    log(f"parity {mode}: greedy streams identical for {len(lengths) - excused}/"
        f"{len(lengths)} requests, {excused} near-tie divergences excused")
    return len(lengths) - excused


def check_logits(mode: str, got, out: dict) -> None:
    """Prefill and first-decode logits of the two paths within LOGIT_TOL."""
    for i, (name, err) in enumerate(max_diff(got).items()):
        out[name] = err
        log(f"parity {mode}: {name} {err:.3e} (atol=rtol={LOGIT_TOL})")
        check(torch.allclose(got[0][i], got[1][i], atol=LOGIT_TOL, rtol=LOGIT_TOL),
              f"parity {mode}: {name} {err:.3e}")


def static_first_logits(M, cfg, rt, params, prompts):
    """The static engine's prefill logits of the batch and the first decode
    step's (its argmax fed back)."""
    tok = torch.tensor(prompts, device=DEVICE)
    B, S = tok.shape
    caches = M.init_caches(cfg, rt, B, S + 1, DEVICE)
    pre, caches = M.prefill(cfg, rt, params, tok, caches)
    dec, _ = M.decode_step(cfg, rt, params, pre.argmax(-1).to(torch.int32)[:, None], S, caches)
    return pre, dec


def static_gaps(M, gaps: dict):
    """A context in which the model's ``prefill`` and ``decode_step`` file
    the top-2 logit gap of every row's token under (row, index)."""
    pre, dec = M.prefill, M.decode_step
    count = [0]

    def keep_pre(*a, **kw):
        out = pre(*a, **kw)
        for row, g in enumerate(top2_gap(out[0]).tolist()):
            gaps[(row, 0)] = g
        return out

    def keep_dec(*a, **kw):
        out = dec(*a, **kw)
        count[0] += 1
        for row, g in enumerate(top2_gap(out[0]).tolist()):
            gaps[(row, count[0])] = g
        return out

    @contextlib.contextmanager
    def ctx():
        M.prefill, M.decode_step = keep_pre, keep_dec
        try:
            yield
        finally:
            M.prefill, M.decode_step = pre, dec
    return ctx()


def static_parity(T, M, cfg, params, prompts, mode: str, n_new: int, rt_kw=None) -> dict:
    """The static engine with its contiguous kernels (B8, B9, B10, B7) on
    and off, in float32: prefill and first-decode logits of the batch within
    LOGIT_TOL, then the greedy streams of ``n_new`` tokens. CPQ and T3 run in
    lockstep on one K/V history, T3 with its top-k choices pinned, as in
    ``parity``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = (True, False)
    rts = {f: T.AttentionRuntime(mode=mode, paged_kernels=f, **(rt_kw or {})) for f in paths}
    lockstep, pinned = mode in ("cpq", "retrieval"), mode == "retrieval"
    what = f"static {mode}"
    run = {f: (lambda f=f: static_first_logits(M, cfg, rts[f], params, prompts)) for f in paths}
    out = {}
    if lockstep:
        with SharedKV() as shared, pin_if(pinned) as pin:
            got = pair([shared] + [pin] * pinned, run[True], run[False])
        if pinned:
            out.update(pin_report(what, "first logits", pin))
    else:
        got = (run[True](), run[False]())
    check_logits(what, got, out)
    engs = {f: T.ServeEngine(cfg, params, rt=rts[f], device=DEVICE) for f in paths}
    gen = T.GenerationConfig(max_new_tokens=n_new)
    gaps = {}

    def gather():
        with static_gaps(M, gaps):
            return engs[False].generate({"tokens": prompts}, gen)[0]

    if lockstep:
        with SharedKV() as shared, pin_if(pinned) as pin:
            a, b = pair([shared] + [pin] * pinned,
                        lambda: engs[True].generate({"tokens": prompts}, gen)[0], gather)
        if pinned:
            out.update(pin_report(what, "streams", pin))
    else:
        a, b = engs[True].generate({"tokens": prompts}, gen)[0], gather()
    out["streams_identical"] = compare_streams(
        what, {True: dict(enumerate(a)), False: dict(enumerate(b))}, gaps,
        {row: n_new for row in range(len(prompts))})
    out["lockstep"] = lockstep
    return out


def pin_if(pinned: bool):
    return SelectionPin() if pinned else contextlib.nullcontext()


def pin_report(mode: str, what: str, pin: SelectionPin) -> dict:
    """Log and gate the top-k choices of a pinned parity run."""
    log(f"parity {mode} {what}: {pin.differ} of {pin.sets} (row, head, layer) top-k sets "
        f"the gather path chose differ from the kernel path's; largest relative gap "
        f"{pin.max_gap:.3e} (tie below {TOPK_GAP})")
    check(pin.max_gap <= TOPK_GAP, f"parity {mode} {what}: a top-k choice differs at a "
          f"resolvable gap {pin.max_gap:.3e}")
    key = what.replace(" ", "_")
    return {f"{key}_topk_sets": pin.sets, f"{key}_topk_sets_differ": pin.differ,
            f"{key}_topk_max_rel_gap": pin.max_gap}


# ------------------------------------------------------------------ main


def check_finished(results, reqs, what: str) -> None:
    for r in reqs:
        got = results[r.rid]
        check(got["finish_reason"] == "max_tokens" and len(got["tokens"]) == r.max_new_tokens,
              f"{what}: request {r.rid}: {got['finish_reason']}, {len(got['tokens'])} tokens")


def serve_metrics(stats, ticks, wall, what: str) -> dict:
    """Tick times of the decode-only ticks, decode and end-to-end rates."""
    pure = [(ms, rows) for ms, rows, chunk, dec in ticks if dec and not chunk]
    step_ms = float(np.median([ms for ms, _ in pure]))
    rows_per = float(np.mean([rows for _, rows in pure]))
    out = {"ticks": len(ticks), "decode_steps": stats["decode_steps"],
           "prefill_chunks": stats["prefill_chunks"], "pure_decode_ticks": len(pure),
           "decode_step_ms_median": step_ms,
           "decode_step_ms_p90": float(np.percentile([ms for ms, _ in pure], 90)),
           "rows_per_decode_step": rows_per,
           "decode_tokens_per_s": rows_per / step_ms * 1e3,
           "generated_tokens": stats["generated_tokens"], "serve_wall_s": wall,
           "end_to_end_tokens_per_s": stats["generated_tokens"] / wall,
           "arena_bytes": stats["arena_bytes_total"],
           "bytes_per_token_layer": stats["bytes_per_token_layer"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"serve {what}: {out['ticks']} ticks ({out['decode_steps']} decode, "
        f"{out['prefill_chunks']} prefill chunks); decode step median {step_ms:.3f} ms "
        f"(p90 {out['decode_step_ms_p90']:.3f}) over {len(pure)} decode-only ticks at "
        f"{rows_per:.2f} rows = {out['decode_tokens_per_s']:.1f} tokens/s; end to end "
        f"{out['end_to_end_tokens_per_s']:.1f} tokens/s over {wall:.2f} s; arena "
        f"{out['arena_bytes'] / 1e9:.3f} GB")
    return out


def serve_recorded(eng, T, reqs, recorders: dict):
    """Serve with each kernel wrapper ``module.name`` replaced by its
    Recorder, the launch counts set to 0 just before and read just after.
    recorders: {name: (module, Recorder)}."""
    for name, (mod, rec) in recorders.items():
        setattr(mod, name, rec)
        rec.fn.launches = 0
    try:
        results, stats, ticks, wall = serve_timed(eng, T, reqs)
    finally:
        for name, (mod, rec) in recorders.items():
            setattr(mod, name, rec.fn)
    return results, stats, ticks, wall, {n: rec.fn.launches for n, (_, rec) in recorders.items()}


def log_timing(name, t, launches, per_tick, unit="tick") -> None:
    log(f"{name}: {t['ms'] * 1e3:.2f} us/launch on the device, {t['eager_ms'] * 1e3:.2f} "
        f"us launched eagerly (bound {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}; "
        f"plain {t['plain_ms'] * 1e3:.1f} us, library {t['library_ms'] * 1e3:.1f} us) over "
        f"{t['samples']} sampled calls; {launches} launches, {per_tick:.0f} per {unit}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the report as JSON here")
    ap.add_argument("--against", default=None,
                    help="root of another checkout of the repository (for example the "
                         "parent commit): build its kernels too and fail unless every "
                         "kernel both builds compile has the same ptxas report")
    ap.add_argument("--changed", default="",
                    help="with --against: comma-separated substrings of '<source> "
                         "<kernel>' whose ptxas reports may differ (kernels changed on "
                         "purpose); every difference is still printed")
    args = ap.parse_args()
    global T0
    T0 = time.perf_counter()

    # 1) device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch as T
    from repro_torch.configs import RetrievalCfg
    from repro_torch.kernels import build
    from repro_torch.kernels.cpq_attn import ops as cpq_ops
    from repro_torch.kernels.decomposed_attn import ops as t1_ops
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.paged_attn import ops
    from repro_torch.kernels.topk_retrieval import ops as t3_ops
    from repro_torch.models import model as M
    from repro_torch.params import init_params, to_device
    from repro_torch.serving import scheduler as S

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")
    report = {"card": smi, "profile": {}}
    kmods = {"paged_decode": ops, "paged_prefill": ops,
             "paged_cpq_decode": cpq_ops, "paged_cpq_prefill": cpq_ops,
             "paged_decomposed_decode": t1_ops, "paged_decomposed_prefill": t1_ops,
             "paged_proxy_scores": t3_ops, "flash_attention": fa_ops,
             "decomposed_decode": t1_ops, "cpq_decode": cpq_ops}
    counted = [(mod, name) for name, mod in kmods.items()] + [(t3_ops, "proxy_scores")]
    # the kernels with two routes: their route counters, and the route every
    # launch of a bf16 serve takes
    routed = {"paged_decode": (ops.DECODE_ROUTE_LAUNCHES, "ring"),
              "paged_prefill": (ops.ROUTE_LAUNCHES, "tensor_core"),
              "paged_cpq_prefill": (cpq_ops.ROUTE_LAUNCHES, "tensor_core"),
              "paged_decomposed_prefill": (t1_ops.ROUTE_LAUNCHES, "tensor_core"),
              "paged_decomposed_decode": (t1_ops.DECODE_ROUTE_LAUNCHES, "tensor_core"),
              "paged_cpq_decode": (cpq_ops.DECODE_ROUTE_LAUNCHES, "single_query")}
    # ... and those of the static serves (B9)
    static_routed = {"decomposed_decode": (t1_ops.CONTIG_ROUTE_LAUNCHES, "tensor_core")}

    # 2) build: one nvcc per source, all started together (B7's two wrappers
    #    share one source, built once; B8's three routes have a source each)
    t0 = time.perf_counter()
    sources = {src: (mod, name) for mod in set(kmods.values())
               for name, src in mod.SOURCES.items()}
    build.build(sorted(sources))
    for mod, name in sources.values():
        mod.launcher(name)
    report["build_s"] = time.perf_counter() - t0
    report["nvcc_s"] = dict(build.BUILD_SECONDS)
    log(f"build: {report['build_s']:.1f} s; nvcc per source: "
        + ", ".join(f"{n} {s:.1f} s" for n, s in sorted(build.BUILD_SECONDS.items())))
    report["ptxas"] = {name: build.ptxas_report(text) for name, text in build.BUILD_LOGS.items()}
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"nvcc[{name}]: {line.strip()}", file=sys.stderr)
    if args.against:  # the other tree built afresh (this one too, unless built above)
        t0 = time.perf_counter()
        cmp = build.compare(args.against, build.reports(sorted(build.KERNELS_DIR.glob(
            "*/csrc/*.cu"))))
        differ = sorted(k for k, same in cmp["compared"].items() if not same)
        named = [c for c in args.changed.split(",") if c]
        unnamed = [k for k in differ if not any(c in k for c in named)]
        report["ptxas_against"] = {"against": args.against, "compared": cmp["compared"],
                                   "changed": named, "differ": differ,
                                   "seconds": time.perf_counter() - t0}
        log(f"{build.verdict(cmp)} (against {args.against}, "
            f"{report['ptxas_against']['seconds']:.1f} s); differ, named by --changed: "
            f"{len(differ) - len(unnamed)}")
        for k in differ:
            src, name = k.split(" ", 1)
            log(f"ptxas differs: {k}: {cmp['this'][src][name]} (was {cmp['against'][src][name]})")
        check(not unnamed, f"ptxas reports differ from {args.against}: {unnamed}")

    # 3) kernels against their plain versions
    errs = {name: {} for name in kmods}
    report["prefill_routes"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        # qwen1.5-0.5b's shape, a GQA shape, and widths of 8-byte rows
        # (Dh 24: the tensor-core route's half-chunk loads) and of no
        # multiple of 8 (Dh 12: bf16 on the sweep)
        for KV, G, Dh in ((16, 1, 64), (8, 4, 128), (4, 2, 24), (4, 2, 12)):
            tag = f"{str(dtype).removeprefix('torch.')} KV={KV} G={G} Dh={Dh}"
            e_dec, e_pre = sweep(ops, dtype, KV, G, Dh)
            errs["paged_decode"][tag], errs["paged_prefill"][tag] = e_dec, e_pre
            for bits in (4, 8):
                e_cd, e_cp = sweep_cpq(cpq_ops, dtype, KV, G, Dh, bits)
                btag = f"{tag} bits={bits}"
                errs["paged_cpq_decode"][btag], errs["paged_cpq_prefill"][btag] = e_cd, e_cp
            routes = (ops.prefill_route(dtype, Dh, Dh),
                      cpq_ops.cpq_prefill_route(dtype, Dh, Dh, CPQ_LEVELS))
            report["prefill_routes"][tag] = dict(zip(("paged_prefill", "paged_cpq_prefill"),
                                                     routes))
            log(f"sweep {tag}: paged_decode {e_dec:.3e} "
                f"({ops.decode_route(dtype, Dh, Dh, 64)} route), paged_prefill {e_pre:.3e} "
                f"({routes[0]} route), paged_cpq_decode {e_cd:.3e}, paged_cpq_prefill "
                f"{e_cp:.3e} ({routes[1]} route; bits 8; tol {TOL[dtype]})")
        for H, Dm, kv_r, Rr in T1_SHAPES:
            tag = f"{str(dtype).removeprefix('torch.')} H={H} Dm={Dm} kv_r={kv_r} Rr={Rr}"
            e_dec, e_pre = sweep_t1(t1_ops, dtype, H, Dm, kv_r, Rr)
            errs["paged_decomposed_decode"][tag] = e_dec
            errs["paged_decomposed_prefill"][tag] = e_pre
            log(f"sweep {tag}: paged_decomposed_decode {e_dec:.3e} "
                f"({t1_ops.t1_decode_route(dtype, H, Dm, kv_r, Rr)} route), "
                f"paged_decomposed_prefill {e_pre:.3e} "
                f"({t1_ops.t1_prefill_route(dtype, Dm, Rr)} route; tol {TOL[dtype]})")
        dname = str(dtype).removeprefix("torch.")
        for shape, err in sweep_decode_served(ops, dtype).items():
            errs["paged_decode"][f"{dname} served rows {shape}"] = err
            log(f"sweep {dname} served rows {shape}: paged_decode {err:.3e} over "
                f"{len(SERVED_DECODE)} layouts, planned and most ranks "
                f"({ops.decode_route(dtype, 64, 64, 64)} route; tol {TOL[dtype]})")
        tag = f"{dname} served rows H=16 Dm=1024 kv_r=16 Rr=32"
        errs["paged_decomposed_decode"][tag] = sweep_t1_served(t1_ops, dtype)
        log(f"sweep {tag}: paged_decomposed_decode "
            f"{errs['paged_decomposed_decode'][tag]:.3e} over {len(T1_SERVED_DECODE)} layouts, "
            f"planned and most splits "
            f"({t1_ops.t1_decode_route(dtype, 16, 1024, 16, 32)} route; tol {TOL[dtype]})")
        for name, sweep_fn, mod in (("flash_attention", sweep_flash, fa_ops),
                                    ("decomposed_decode", sweep_t1c, t1_ops)):
            for case, err in sweep_fn(mod, dtype).items():
                errs[name][f"{dname} {case}"] = err
        for case, err in sweep_cpqc(cpq_ops, dtype).items():  # float32 output
            errs["cpq_decode"][f"float32 q={dname} {case}"] = err
        log(f"sweep {dname}: flash_attention {max(errs['flash_attention'].values()):.3e} over "
            f"{len(FLASH_SWEEP)} cases, decomposed_decode "
            f"{max(errs['decomposed_decode'].values()):.3e} over {len(T1C_SWEEP)}, cpq_decode "
            f"{max(errs['cpq_decode'].values()):.3e} over {2 * len(CPQC_SWEEP)} (tol "
            f"{TOL[dtype]}, cpq_decode {TOL[torch.float32]})")
    for name, by_tag in errs.items():
        for tag, err in by_tag.items():
            check(err <= TOL[torch.bfloat16 if tag.startswith("bfloat16") else torch.float32],
                  f"{name} {tag}: error {err}")
    errs["paged_proxy_scores"] = {}
    for KV, G, Dp in T3_SHAPES:  # float32 only: B7 takes float32 factors, int8 codes
        tag = f"float32 KV={KV} G={G} Dp={Dp}"
        errs["paged_proxy_scores"][tag] = sweep_t3(t3_ops, KV, G, Dp)
        log(f"sweep {tag}: paged_proxy_scores and proxy_scores "
            f"{errs['paged_proxy_scores'][tag]:.3e} (tol {T3_REL} x max |score|)")
    log(f"[{time.perf_counter() - T0:.0f} s] kernels checked")

    # 4a) serve full-width qwen1.5-0.5b in bf16, dense
    cfg = served_config(T)
    params = init_params(cfg, SEED, DEVICE)
    serving = T.ServingCfg(num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64)
    reqs = make_requests(T, cfg.vocab_size)
    warm = T.ContinuousServeEngine(cfg, params, serving=T.ServingCfg(
        num_slots=2, page_size=16, num_pages=17, max_blocks_per_slot=8), device=DEVICE)
    warm.serve([T.Request(rid=0, prompt=reqs[0].prompt[:40], max_new_tokens=4)])
    del warm
    scale = cfg.head_dim ** -0.5
    L = cfg.num_layers
    launches, per_tick, per_prefill, timing, serves = {}, {}, {}, {}, {}

    def recorders_of(dec, pre):
        return {name: (kmods[name], Recorder(getattr(kmods[name], name), L, every,
                                             *split_of[name]))
                for name, every in ((dec, 10), (pre, 8))}

    kv_arenas = lambda q, k, v, *rest: (k, v)  # noqa: E731
    x_arenas = lambda qn, qr, x, kr, *rest: (x, kr)  # noqa: E731
    code_arenas = lambda q, sc, z, codes, *rest: (codes, (sc, z))  # noqa: E731
    decode_snap = lambda q, k, v, bt, ln, s: (q.clone(), bt.clone(), ln.clone())  # noqa: E731
    split_of = {  # (the call's arenas, a copy of its small inputs)
        "paged_decode": (kv_arenas, decode_snap),
        "paged_cpq_decode": (kv_arenas, decode_snap),
        "paged_prefill": (kv_arenas, lambda q, k, v, row, off, val, s:
                          (q.clone(), row.clone(), off, val)),
        "paged_cpq_prefill": (kv_arenas, lambda q, k, v, kr, vr, slot, row, off, val, s:
                              (q.clone(), kr.clone(), vr.clone(), slot, row.clone(), off,
                               val)),
        "paged_decomposed_decode": (x_arenas, lambda qn, qr, x, kr, bt, ln, wk, wv, s: (
            t1_ops.query_rows(qn, wk, x.dtype)[:, 0], qr[:, 0].to(x.dtype).contiguous(),
            bt.clone(), ln.clone())),
        "paged_decomposed_prefill": (x_arenas, lambda qn, qr, x, kr, row, off, val, wk, wv, s: (
            t1_ops.query_rows(qn, wk, x.dtype)[0], qr[0].to(x.dtype).contiguous(),
            row.clone(), off, val)),
        "paged_proxy_scores": (code_arenas, lambda q, sc, z, codes, bt, ln, n, q_scale=None: (
            q.clone(), bt.clone(), ln.clone(), n, q_scale)),
    }
    cases = {"paged_decode": decode_case(ops, scale), "paged_prefill": prefill_case(ops, scale),
             "paged_cpq_decode": cpq_decode_case(cpq_ops, scale),
             "paged_cpq_prefill": cpq_prefill_case(cpq_ops, scale),
             "paged_decomposed_decode": t1_decode_case(t1_ops, scale),
             "paged_decomposed_prefill": t1_prefill_case(t1_ops, scale),
             "paged_proxy_scores": t3_decode_case(t3_ops)}
    # T3 with top_k=256 (one of bench_retrieval.py's K): with prompts of
    # 64-512 tokens plus 64 new ones, rows past 256 keys really select
    t3_cfg = RetrievalCfg(top_k=256, recent_window=64)
    rts = {mode: T.AttentionRuntime(mode=mode) for mode in ("dense", "cpq", "decomposed")}
    rts["retrieval"] = T.AttentionRuntime(mode="retrieval", retrieval=t3_cfg)
    for mode, (dec, pre) in (("dense", ("paged_decode", "paged_prefill")),
                             ("cpq", ("paged_cpq_decode", "paged_cpq_prefill")),
                             ("decomposed", ("paged_decomposed_decode",
                                             "paged_decomposed_prefill")),
                             ("retrieval", ("paged_proxy_scores", "paged_prefill"))):
        # 4a) dense, 4b) mode="cpq", 4d) mode="decomposed", 4e) mode="retrieval"
        eng = T.ContinuousServeEngine(cfg, params, rt=rts[mode], serving=serving,
                                      device=DEVICE)
        recs = recorders_of(dec, pre)
        run = make_requests(T, cfg.vocab_size)  # a served Request keeps its tokens
        zero_routes(routed)
        results, stats, ticks, wall, counts = serve_recorded(eng, T, run, recs)
        check_finished(results, run, mode)
        check(counts[dec] == L * stats["decode_steps"] and counts[pre] == L * stats["prefill_chunks"],
              f"{mode}: launch counts {counts} vs {stats['decode_steps']} decode ticks and "
              f"{stats['prefill_chunks']} chunks")
        routes = check_routes(mode, routed, counts)
        serves[mode] = serve_metrics(stats, ticks, wall, mode)
        serves[mode]["launches"] = counts
        serves[mode]["routes"] = routes
        log(f"[{time.perf_counter() - T0:.0f} s] served {mode}")
        for name in (dec, pre):
            if name in timing:  # B2 again, under T3: its launches are logged only
                log(f"{name}: {counts[name]} launches in the {mode} serve, "
                    f"{counts[name] / stats['prefill_chunks']:.0f} per chunk tick")
                continue
            launches[name] = counts[name]
            per_tick[name] = counts[name] / stats["decode_steps" if name == dec
                                                 else "prefill_chunks"]
            timing[name] = time_kernel(recs[name][1], cases[name])
            log_timing(name, timing[name], launches[name], per_tick[name])
        if mode == "retrieval":
            d, r = serves["dense"], serves[mode]
            log(f"serve retrieval vs dense, same call: decode tick median "
                f"{r['decode_step_ms_median']:.3f} vs {d['decode_step_ms_median']:.3f} ms, "
                f"end to end {r['end_to_end_tokens_per_s']:.1f} vs "
                f"{d['end_to_end_tokens_per_s']:.1f} tokens/s, arena {r['arena_bytes']} vs "
                f"{d['arena_bytes']} bytes")
        del eng, recs
        torch.cuda.empty_cache()
        # chunk ticks: 10 dense, 5 cpq (its host-bound chunk tick is slow to
        # profile) and 5 decomposed
        chunk = {"dense": [(40, 50)], "cpq": [(40, 45)], "decomposed": [(40, 45)]}.get(mode, [])
        windows = chunk + [mid_decode_window(ticks)]
        report["profile"][mode] = profile_windows(
            lambda: T.ContinuousServeEngine(cfg, params, rt=rts[mode], serving=serving,
                                            device=DEVICE),
            T, make_requests(T, cfg.vocab_size), ticks, windows)
        log_profile(mode, report["profile"][mode])
        torch.cuda.empty_cache()
        log(f"[{time.perf_counter() - T0:.0f} s] profiled {mode}")

    # 4c) the tiered engine: a dense arena small enough that later requests
    #     are admitted into the CPQ tier and running dense rows escalate
    tiered = T.ServingCfg(num_slots=8, page_size=16, num_pages=97, max_blocks_per_slot=64,
                          escalated_pages=513, low_watermark=0.5, critical_watermark=0.45,
                          enable_escalation=True)
    eng = T.ContinuousServeEngine(cfg, params, serving=tiered, device=DEVICE)
    tiers, admit = [], S.Scheduler.admit_next

    def admit_counted(sched, now, step):
        req = admit(sched, now, step)
        if req is not None:
            tiers.append(req.tier)
        return req

    tiered_kernels = ("paged_decode", "paged_prefill", "paged_cpq_decode",
                      "paged_cpq_prefill")
    for name, mod in kmods.items():
        getattr(mod, name).launches = 0
    zero_routes(routed)
    S.Scheduler.admit_next = admit_counted
    run = make_requests(T, cfg.vocab_size)
    try:
        results, stats, ticks, wall = serve_timed(eng, T, run)
    finally:
        S.Scheduler.admit_next = admit
    counts = {name: kmods[name].__dict__[name].launches for name in tiered_kernels}
    routes = check_routes("tiered", routed, counts)
    check(not any(getattr(mod, name).launches for name, mod in kmods.items()
                  if name not in tiered_kernels), "tiered: a T1 or T3 kernel launched")
    check_finished(results, run, "tiered")
    serves["tiered"] = serve_metrics(stats, ticks, wall, "tiered")
    serves["tiered"].update(
        escalations=stats["escalations"], cpq_admissions=int(sum(tiers)),
        admissions=len(tiers), launches=counts, routes=routes,
        dense_pages_leaked=stats["dense_pages_leaked"],
        cpq_pages_leaked=stats["cpq_pages_leaked"],
        serving={k: getattr(tiered, k) for k in ("num_pages", "escalated_pages",
                                                 "low_watermark", "critical_watermark")})
    log(f"serve tiered: {stats['escalations']} escalations, {sum(tiers)} of {len(tiers)} "
        f"admissions into the CPQ tier, pages leaked dense {stats['dense_pages_leaked']} "
        f"cpq {stats['cpq_pages_leaked']}; launches {counts}")
    check(stats["escalations"] >= 1 and sum(tiers) >= 1,
          "tiered: no escalation or no admission into the CPQ tier")
    check(stats["dense_pages_leaked"] == 0 and stats["cpq_pages_leaked"] == 0,
          "tiered: pages leaked")
    check(all(n > 0 for n in counts.values()), f"tiered: a kernel never launched: {counts}")
    check(counts["paged_decode"] == counts["paged_cpq_decode"] == L * stats["decode_steps"]
          and counts["paged_prefill"] + counts["paged_cpq_prefill"]
          == L * stats["prefill_chunks"],
          f"tiered: launch counts {counts} vs {stats['decode_steps']} decode ticks and "
          f"{stats['prefill_chunks']} chunks")
    report["serve"] = serves
    del eng
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - T0:.0f} s] served tiered")
    report["profile"]["tiered"] = profile_windows(
        lambda: T.ContinuousServeEngine(cfg, params, serving=tiered, device=DEVICE),
        T, make_requests(T, cfg.vocab_size), ticks, [mid_decode_window(ticks)])
    log_profile("tiered", report["profile"]["tiered"])
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - T0:.0f} s] profiled tiered")

    # 4f) the static ServeEngine: 8 prompts of 512 tokens, 64 new, in four
    #     modes; B8 prefills (24 launches) and decodes dense, B9, B10 and B7
    #     decode T1, T2 and T3 (24 launches per step)
    prompts = static_prompts(cfg.vocab_size)
    n_new = 64
    step_kernel = {"dense": "flash_attention", "decomposed": "decomposed_decode",
                   "cpq": "cpq_decode", "retrieval": "proxy_scores"}
    for mode in ("dense", "decomposed", "cpq", "retrieval"):
        eng = T.ServeEngine(cfg, params, rt=rts[mode], device=DEVICE)
        recs = {"flash_attention": (fa_ops, FlashRecorder(fa_ops.flash_attention, L))}
        if mode == "decomposed":
            recs["decomposed_decode"] = (t1_ops, Recorder(
                t1_ops.decomposed_decode, L, 10, lambda qn, qr, x, kr, *r: (x, kr),
                lambda qn, qr, x, kr, ln, wk, wv, s: (t1_ops.query_rows(qn, wk, x.dtype)[:, 0],
                                                      qr[:, 0].to(x.dtype).contiguous(), ln)))
        if mode == "cpq":
            recs["cpq_decode"] = (cpq_ops, Recorder(
                cpq_ops.cpq_decode, L, 10, lambda q, kt, vt, *r: (kt, vt),
                lambda q, kt, vt, ln, *r: (q[:, 0].reshape(q.shape[0], kt.codes.shape[2], -1,
                                                           q.shape[3]).float().contiguous(),
                                           ln)))
        zero_routes(static_routed)
        out, stats, timer, wall, counts = serve_static(eng, T, M, prompts, n_new, recs, counted,
                                                       fa_ops.ROUTE_LAUNCHES)
        static_routes = check_routes(f"static {mode}", static_routed, counts)
        steps = stats["decode_steps"]
        check(out.shape == (len(prompts), n_new) and steps == n_new - 1
              and stats["generated_tokens"] == out.size, f"static {mode}: {out.shape}, {stats}")
        want = {name: 0 for name in counts}
        want["flash_attention"] = L * (1 + steps if mode == "dense" else 1)
        want["flash_attention/prompt"] = L         # the bf16 prefill: tensor cores
        if mode == "dense":
            want["flash_attention/decode"] = L * steps
        else:
            want[step_kernel[mode]] = L * steps
        check(counts == want, f"static {mode}: launch counts {counts}, want {want}")
        serves[f"static {mode}"] = static_metrics(out, stats, timer, wall, mode)
        serves[f"static {mode}"]["launches"] = {k: n for k, n in counts.items() if n}
        serves[f"static {mode}"]["routes"] = static_routes
        if mode == "dense":
            name = "flash_attention_prompt"
            timing[name] = time_kernel(recs["flash_attention"][1].pre,
                                       flash_prefill_case(fa_ops, scale))
            # the static serve prefills once: its count is the count per prefill
            launches[name] = per_prefill[name] = counts["flash_attention/prompt"]
            log_timing(name, timing[name], launches[name], per_prefill[name], "prefill")
        if mode != "retrieval":
            name = step_kernel[mode]
            rec = recs[name][1].dec if name == "flash_attention" else recs[name][1]
            case = {"flash_attention": flash_decode_case(fa_ops, scale),
                    "decomposed_decode": t1c_decode_case(t1_ops, scale),
                    "cpq_decode": cpqc_decode_case(cpq_ops, scale)}[name]
            n = counts[COUNT_KEY.get(name, name)]
            launches[name], per_tick[name] = n, n / steps
            timing[name] = time_kernel(rec, case)
            log_timing(name, timing[name], launches[name], per_tick[name])
        step_ms = timer.step_ms
        if mode == "dense":  # layer 0's prompt K/V, for the encoders' device check
            history = tuple(t.clone() for t in recs["flash_attention"][1].pre.arenas[0])
        del eng, recs, timer
        torch.cuda.empty_cache()
        if mode in ("dense", "decomposed"):
            report["profile"][f"static {mode}"] = [profile_static(
                lambda: T.ServeEngine(cfg, params, rt=rts[mode], device=DEVICE), T, M,
                prompts, n_new, step_ms, 30, 40)]
            log_profile(f"static {mode}", report["profile"][f"static {mode}"])
        log(f"[{time.perf_counter() - T0:.0f} s] served static {mode}")

    # 4g) one-shot admission (prefill_chunk=0), dense, on the traffic of 4a:
    #     B8 prefills each admission's padded prompt, B1 decodes
    eng = T.ContinuousServeEngine(cfg, params, serving=dataclasses.replace(
        serving, prefill_chunk=0), device=DEVICE)
    zero_launches(counted, fa_ops.ROUTE_LAUNCHES)
    zero_routes(routed)
    run = make_requests(T, cfg.vocab_size)
    results, stats, ticks, wall = serve_timed(eng, T, run)
    counts = counted_launches(counted, fa_ops.ROUTE_LAUNCHES)
    oneshot_routes = check_routes("oneshot", {"paged_decode": routed["paged_decode"]}, counts)
    check_finished(results, run, "oneshot")
    want = {name: 0 for name in counts}
    want.update({"flash_attention": L * stats["admitted"],
                 "flash_attention/prompt": L * stats["admitted"],
                 "paged_decode": L * stats["decode_steps"]})
    check(counts == want and stats["admitted"] == len(run) and not stats["chunked_prefill"],
          f"oneshot: launch counts {counts}, want {want}; {stats['admitted']} admissions")
    serves["oneshot"] = serve_metrics(stats, ticks, wall, "oneshot dense")
    serves["oneshot"]["launches"] = {k: n for k, n in counts.items() if n}
    serves["oneshot"]["routes"] = oneshot_routes
    del eng
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - T0:.0f} s] served oneshot")

    # C3: the T2 (HQE) and T3 (proxy) encoders on the card and on the CPU, on
    #     layer 0's K/V of the static prompts (448 at once, 64 appended)
    report["encode_parity"] = encode_parity(*history, rts["cpq"].cpq, t3_cfg, 448)
    for what, r in report["encode_parity"].items():
        log(f"encode parity {what} (card vs CPU, no gate): {r}")
    del history

    # 5) f32 parity, kernels on and off, dense, CPQ, T1 and T3
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = to_device(_tree_float(params), DEVICE)
    # the continuous serves' parity runs the first PARITY_DEPTH layers, to
    # keep the script well inside its time limit; the contiguous path's
    # (static, one-shot) runs the full depth
    depth = min(PARITY_DEPTH, cfg32.num_blocks)
    cfg_p = dataclasses.replace(cfg32, num_blocks=depth)
    params_p = {**params32, "blocks": [b[:depth] for b in params32["blocks"]]}
    del params
    report["parity"] = {mode: parity(T, M, cfg_p, params_p, reqs, mode)
                        for mode in ("dense", "cpq", "decomposed")}
    with TopkWitness(t3_ops, t3_cfg, cfg_p.num_layers) as witness:
        report["parity"]["retrieval"] = parity(T, M, cfg_p, params_p, reqs, "retrieval",
                                               dict(retrieval=t3_cfg))
    report["parity"]["retrieval"].update(
        topk_sets_compared=witness.sets, topk_sets_differ_plain=witness.differ_plain,
        topk_sets_differ_gather=witness.differ_gather)
    log(f"parity retrieval: of {witness.sets} (row, head, layer) top-k sets over sampled "
        f"decode calls, {witness.differ_plain} differ between B7's scores and its plain "
        f"version's, {witness.differ_gather} between B7's and the gather path's (no gate)")
    log(f"[{time.perf_counter() - T0:.0f} s] parity checked (continuous)")
    report["parity"]["oneshot"] = parity(T, M, cfg32, params32, reqs, "dense",
                                         serving_kw=dict(prefill_chunk=0))
    for mode in ("dense", "decomposed", "cpq", "retrieval"):
        report["parity"][f"static {mode}"] = static_parity(
            T, M, cfg32, params32, prompts, mode, n_new,
            dict(retrieval=t3_cfg) if mode == "retrieval" else None)
    log(f"[{time.perf_counter() - T0:.0f} s] parity checked (contiguous)")

    kernel_mod = {**kmods, "flash_attention_prompt": fa_ops}
    replaces = {"paged_decode": "src/repro/kernels/flash_attn/kernel.py:223",
                "paged_prefill": "src/repro/kernels/flash_attn/kernel.py:170",
                "paged_cpq_decode": "src/repro/kernels/cpq_dequant_attn/kernel.py:281",
                "paged_cpq_prefill": "src/repro/kernels/cpq_dequant_attn/kernel.py:213",
                "paged_decomposed_decode": "src/repro/kernels/decomposed_attn/kernel.py:244",
                "paged_decomposed_prefill": "src/repro/kernels/decomposed_attn/kernel.py:187",
                "paged_proxy_scores": "src/repro/kernels/topk_retrieval/kernel.py:39",
                "flash_attention": "src/repro/kernels/flash_attn/kernel.py:276",
                "flash_attention_prompt": "src/repro/kernels/flash_attn/kernel.py:276",
                "decomposed_decode": "src/repro/kernels/decomposed_attn/kernel.py:298",
                "cpq_decode": "src/repro/kernels/cpq_dequant_attn/kernel.py:338"}
    source = {name: mod.SOURCES[name] for name, mod in kmods.items()}
    route_source = {  # the header of each served route
        "paged_decode": ops.CSRC / "paged_token.cuh",
        "paged_prefill": ops.CSRC / "paged_chunk.cuh",
        "paged_cpq_prefill": ops.CSRC / "paged_chunk.cuh",
        "paged_decomposed_prefill": t1_ops.CSRC / "paged_decomposed_chunk.cuh",
        "paged_decomposed_decode": t1_ops.CSRC / "t1_token.cuh",
        "decomposed_decode": t1_ops.CSRC / "t1_token.cuh",
        "paged_cpq_decode": fa_ops.CSRC / "single_query.cuh"}
    source.update(flash_attention=fa_ops.SOURCES["flash_decode"],
                  flash_attention_prompt=fa_ops.SOURCES["flash_prompt"])
    sdpa = "torch.nn.functional.scaled_dot_product_attention"
    library = {name: sdpa for name in kernel_mod}
    library["paged_proxy_scores"] = "torch.matmul on codes gathered beforehand, plus qz"
    library["cpq_decode"] = sdpa + " on K/V dequantized beforehand"
    served = {name: "bfloat16 KV=16 G=1 Dh=64" + (" bits=4" if "cpq" in name else "")
              for name in kmods}
    served.update({
        "paged_decomposed_decode": "bfloat16 H=16 Dm=1024 kv_r=16 Rr=32",
        "paged_decomposed_prefill": "bfloat16 H=16 Dm=1024 kv_r=16 Rr=32",
        "paged_proxy_scores": "float32 KV=16 G=1 Dp=64",
        "flash_attention": "bfloat16 B=8 T=1 S=575 H=16 KV=16 D=64 causal=False",
        "flash_attention_prompt": "bfloat16 B=8 T=512 S=512 H=16 KV=16 D=64 causal=True",
        "decomposed_decode": "bfloat16 B=8 N=576 H=16 Dm=1024 kv_r=16 Rr=32 length=575",
        "cpq_decode": "float32 q=bfloat16 B=8 N=576 KV=16 G=1 Dh=64 bits=4 length=575 "
                      "round=True"})
    # B8's sweep, split by route: a decode token, or a prompt
    errs["flash_attention_prompt"] = {k: e for k, e in errs["flash_attention"].items()
                                      if " T=1 " not in k}
    errs["flash_attention"] = {k: e for k, e in errs["flash_attention"].items()
                               if " T=1 " in k}
    root = os.path.dirname(os.path.abspath(__file__))
    kernels = []
    for name in kernel_mod:
        t, key = timing[name], COUNT_KEY.get(name, name)
        by_serve = {mode: sv["launches"][key] for mode, sv in serves.items()
                    if sv.get("launches", {}).get(key)}
        if name == "paged_proxy_scores":  # B7's contiguous wrapper, the static T3 decode
            by_serve["static retrieval"] = serves["static retrieval"]["launches"]["proxy_scores"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(str(source[name]), root),
            "replaces": replaces[name], "launches": launches[name],
            # per decode or chunk tick; B8's prompt route per static prefill
            **({"launches_per_prefill": per_prefill[name]} if name in per_prefill
               else {"launches_per_tick": per_tick[name]}),
            "max_abs_err": errs[name][served[name]], "max_abs_err_sweep": errs[name],
            "ms": t["ms"], "eager_ms": t["eager_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": library[name], "timed_samples": t["samples"],
            "launches_by_serve": by_serve})
        if name in routed or name in static_routed:
            # B2, B3, B4, B6, B9: the tensor-core kernel; B5: the single-query
            # one; B1: the ring
            route = {**routed, **static_routed}[name][1]
            kernels[-1].update({
                f"{route}_source": os.path.relpath(str(route_source[name]), root),
                "routes_by_serve": {mode: sv["routes"][name] for mode, sv in serves.items()
                                    if sv.get("routes", {}).get(name, {}).get(route)}})
    report["kernels"] = kernels
    report["run_s"] = time.perf_counter() - T0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "max_abs_err_sweep"}
                                  for e in kernels]}))  # the sweep's errors: --out
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
