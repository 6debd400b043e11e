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
              and at jamba's (KV 8, G 8, Dh 128) with the planned and with
              the most cluster ranks; B5
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
              prefix of a 576-key arena), each also at jamba's 64 heads over 8
              of Dh 128 as serve (o) runs them (with its static prefill of 8 x
              512), T = S = 77, at llama-vision's cross-attention (32 heads
              over 8 of 128: 8 x 512 and 1 x 77 prompts over 1600 patch
              keys, non-causal, and a decode token over them), at musicgen's
              32 heads of 64 (its static prefill of 8 x 512 and its last
              static decode), and at Dh
              32, 64, 128 and 256 with G of 1, 4 and 8 a prompt of 200
              (causal and not) and a decode token; in bf16 each B8 case is
              held against attention worked in float64 from the same bf16
              inputs, within the bf16 tolerance and no farther from it than
              the plain version; B9 decomposed_decode at
              qwen's T1 shape
              (kv_r 16, Rr 32, length < N, past one key split, length 0),
              an MLA-like shape (kv_r 1, Rr 64), a no-rope shape, 32 heads,
              N = 77, Dm 2560-8192 and musicgen's static decode (H 32, Dm
              2048, no rope), each call on its route (as B3's);
              B10 cpq_decode
              with 4- and 8-bit codes, G of 1, 4 and 8 (Dh 256), tiles
              rounded and not, pruned codes, length < N, N = 77 and
              musicgen's KV 32 (float32 output, its tolerance); B2 at the speculative verify chunk's
              shapes (C = 2, 5, 9 rows, valid = C or 3, at offsets 0, 1,
              15, 17 and 1024 - C, G 1 and 2, over a draft's block row:
              another slot's pages, then scratch pages seeded with the
              frontier page's payload), each call on its route; and at
              deepseek-v2-lite's MLA shapes (16 heads over the latent of
              512 and one roped key of 64 shared by every head): B3 and B4
              on the layouts above (chunks of 16), B3 at the served rows
              with the planned and the most splits, B9 at the static MLA
              decode (8 x 576, lengths 575, 193 and 0), and B8's prompt at
              Dh 192 / Dv 128 (16 heads, T up to 512, causal and not), each
              call on its route (bf16: the tensor cores)
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
              decode tick, B2 never. Then the rest of the continuous tick on
              (a)'s arena at the first REST_DEPTH = 12 of qwen's 24 layers,
              B1 and B2 alone launched (once a layer a decode step, a chunk
              or a verify chunk; every chunk on B2's tensor cores,
              every decode on B1's ring) and no page leaked: (h) prefix
              sharing with copy-on-write and defrag every 4 retirements on
              make_templated_workload (8 sessions of 3 turns behind one
              256-token system prompt; sessions 0, 2, 4, 6 sampled at
              temperature 0.8, top-k 50, top-p 0.9, seed 100 + rid): prefix
              hits and defrags; its prompts diverge at page boundaries, so
              a probe behind the same system prompt (a request diverging 10
              tokens into a page) must split a shared page (copy-on-write);
              (i) speculative decoding (spec_len 4, n-grams of 3) on
              make_loopy_workload (8 greedy requests, a 32-token motif
              tiled 4 times, 64 new tokens): verify steps and accepted
              drafts; (j) make_slo_workload (24 requests, interactive and
              batch classes) through the port's run_trace under the slo
              and fifo policies, with per-class tails. No gate: layer 0's
              K/V of the static
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
              serves run the first 4 of the 24 layers here, to keep the
              script well inside its time limit. Then, at the same depth,
              the same checks for (g) (dense, each path on its own history)
              and for (f) in the four modes (CPQ and T3 in lockstep, T3
              pinned): the prefill and first-decode logits of the batch,
              and the greedy streams. Then (h), its copy-on-write probe and
              (i) at the parity depth, kernels on and off: identical greedy
              and sampled streams (greedy near-ties excused as above) and
              identical counters; sharing on against off and speculation
              on against off: identical streams. Last, the sampler on the
              card against the CPU on 32 rows of 151936 float32 logits:
              identical Threefry bits and uniforms, and identical draws but
              where the CPU's top-2 perturbed logits lie within 1e-6
              (relative), counted. Each added phase prints its seconds
  6. deepseek (k) deepseek-v2-lite at its published widths (27 layers: MLA
              with a latent of 512, one MLA + dense layer and 26 MLA + MoE,
              64 routed and 2 shared experts, top-6; random bf16 weights
              from a seed, ~32 GB) on ContinuousServeEngine over (a)'s
              arena, one-shot (a MoE stack), on (a)'s traffic: mode
              decomposed (the latent: B8's prompt route 27 times an
              admission, B3 on its tensor cores 27 times a decode tick) and
              mode cpq (the latent in CPQ codes: B8 alone), then the static
              ServeEngine on 8 prompts of 512, 64 new (B8 27 times, B9 on
              its tensor cores 27 times a step); its f32 parity, kernels
              on and off, over its first PARITY_DEPTH layers (the model
              freed first): logits within 1e-3, then streams and counters
              identical, or, where they differ, the first router call whose
              top-k sets differ no later than the first tick whose tokens
              differ and a near tie (relative top-k boundary gap below
              1e-5), counted; (l) qwen1.5-0.5b cut to DCPQ_DEPTH = 6 of its
              24 layers in mode decomposed_cpq
              (T1+T2: X in CPQ codes), chunked on (a)'s arena and static (no
              kernel: the reference has none for this tier; B8 prefills
              the static batch); (m) deepseek-moe-16b at its published
              widths cut to MOE_DEPTH = 4 layers (1 dense, 3 MoE), mode
              dense, asked for chunks but admitted one-shot (B8's prompt
              route, B1's ring), and its f32 parity as (k)'s. Each serve's launch counts are
              set to 0 just before it and read just after
  7. recurrent (n) xlstm-125m at its published widths, nothing cut (12
              layers: 2 x [5 mLSTM, 1 sLSTM], d_model 768, 4 heads,
              proj_factor 2, chunk 256, vocab 50304; random bf16 weights
              from a seed, ~0.39 GB) on ContinuousServeEngine over (a)'s
              arena and traffic, asked for chunks of 16 but admitted
              one-shot at each prompt's exact length (no chunk, no kernel:
              the stack has no attention), its slot states (~23.8 MB a
              slot) the whole arena; and on the static ServeEngine (8 x
              512, 64 new); its f32 parity, the card against the CPU
              running the same port code, on 2 of the 8 requests. The
              sLSTM's recurrence is chaotic at these random weights (a
              1e-7 nudge of the embeddings moves the CPU's own logits by
              O(1) over a 64-token prompt, printed), so the whole stack is held
              one decode step at a time from the CPU's state, the CPU's
              static decode_step against the card's continuous
              decode_step_rows over a 2-slot state tree (64 steps a request:
              logits and the states written in place within 1e-3, the
              argmax the CPU's but below a 1e-4 top-2 gap), and the stack of its 10 mLSTM layers alone
              free-running through ContinuousServeEngine on the card and on
              the CPU (prefill and first-decode logits within 1e-3, greedy
              streams identical but below a 1e-4 top-2 gap). (o)
              jamba-1.5-large-398b at its
              published widths (d_model 8192, 64 heads over 8 of 128, d_ff
              24576, Mamba d_state 16 / d_conv 4 / expand 2, 16 experts
              top-2 of 24576, vocab 65536), its depth cut to the first 5
              layers of its block of 8 (mamba+dense, mamba+moe, mamba+dense,
              mamba+moe, attn+dense; 48.1 GB bf16: one block is 90.5 GB, more
              than the card), mode dense, one-shot on (a)'s arena and
              traffic (B8's prompt route once an admission, B1's ring once a
              decode tick, B1 timed at that shape) and static (B8's prompt
              route once, its single-query route once a step, both timed);
              its f32 parity, kernels on and off, with the routed experts
              cut to 8 of 16 (top-2 kept; 57.5 GB, the bf16 model converted
              leaf by leaf), under (k)'s gates and router-tie excuse. The
              phase prints its seconds
  8. multimodal (p) llama-3.2-vision-11b at its published widths, nothing
              cut (40 layers: 8 blocks of attn, attn, attn, xattn, attn;
              d_model 4096, 32 heads over 8 of 128, SwiGLU d_ff 14336, vocab
              128256, untied, rope theta 500000; random bf16 weights from a
              seed, 9.79 B parameters, ~19.6 GB), every cross-attention gate
              set to 1.0 (the reference draws it at 0, where the layer adds
              nothing), on the static ServeEngine: 8 prompts of 512 seeded
              tokens, each row its own 1600 patches of N(0, 1), 64 new; B8's
              prompt route 40 times a prefill (32 causal, 8 non-causal over
              the patch keys) and its decode route 40 times a step (8 over
              the patch keys), both cross-attention shapes timed; arena
              bytes by the arithmetic. (q) musicgen-large at its published
              widths, nothing cut (48 layers, d_model 2048, 32 heads of 64,
              GELU d_ff 8192, layernorm, absolute positions, vocab 2048;
              ~4.85 GB), 8 rows of 512 frames of 0.3 N(0, 1), 64 new codes,
              modes dense (B8), decomposed (B9, every launch on its sweep:
              d_model 2048; its arena half of dense's), cpq (B10) and
              retrieval (B7's contiguous form, top_k 256), each step kernel
              timed. Then each model's f32 parity over its first
              PARITY_DEPTH layers (the bf16 model freed first; llama's
              include its first cross-attention layer), kernels on and off
              under phase 5's gates; llama's again with its patches scaled
              by 3 and shifted by 1, and how far that moves its logits (the
              cross-attention is live: more than 1e-2); musicgen's T1 logits
              within 3e-4 of its dense ones (exact at absolute positions).
              The phase prints its seconds

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
PARITY_DEPTH = 4            # layers of every serve's f32 parity (of 24; deepseek-v2-lite's 27)
REST_DEPTH = 12             # layers of serves (h)-(j) (of 24; cut to make room for phase 8)
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


LOG: list[str] = []         # every logged line, kept for the --out report


def log(msg: str) -> None:
    LOG.append(msg)
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
# qwen1.5-0.5b's shape (KV 16, G 1, Dh 64: one block a unit), at GQA (KV
# 8, G 4, Dh 128: two ranks a unit) and at jamba's (KV 8, G 8, Dh 128: two
# head groups a kv head), each also with every unit over the most ranks of
# a cluster (8)
SERVED_DECODE = ((0, 1, 256, 1024, 77, 576, 767, 16), (640, 128, 0, 511, 257, 1000, 17, 33))


def sweep_decode_served(ops, dtype, page=16, nb=64) -> dict:
    """Max abs error of B1 against its plain version on SERVED_DECODE, with
    the planned ranks and with the most, each call on its route."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    errs = {}
    for KV, G, Dh in ((16, 1, 64), (8, 4, 128), (8, 8, 128)):
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


# B2 at the speculative verify chunk's shapes: C = spec_len + 1 query rows
# (2, 5, 9; most of a 16-row tile is padding), valid = C or fewer, at offsets
# 0, 1, 15, 17 and the block ceiling less C (the last chunk a row at the
# ceiling can verify), over a draft's block row: another slot's pages for
# the history, scratch pages from the frontier block on, the first seeded
# with the frontier page's payload as the engine's page copy does
VERIFY_CHUNKS = ((2, 2), (5, 5), (9, 9), (9, 3))   # C, valid


def sweep_verify(ops, dtype, G, page=16, nb=64, Dh=64) -> float:
    """Max abs error of B2 against its plain version at the verify shapes
    (KV = 16 / G kv heads); every call must take the route its dtype
    picks."""
    KV = 16 // G
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    P = 2 * nb + 8
    kp = torch.randn((P, page, KV, Dh), generator=gen, device=DEVICE).to(dtype)
    vp = torch.randn((P, page, KV, Dh), generator=gen, device=DEVICE).to(dtype)
    kp[0] = vp[0] = 1e3                          # poisoned null page
    perm = torch.randperm(P - 1, generator=gen, device=DEVICE).int() + 1
    target = perm[:nb]                           # the other slot's block row
    err, calls, before = 0.0, 0, dict(ops.ROUTE_LAUNCHES)
    for C, valid in VERIFY_CHUNKS:
        for offset in (0, 1, 15, 17, nb * page - C):
            first, last = offset // page, (offset + valid - 1) // page
            scratch = perm[nb:nb + last - first + 1]
            row = target.clone()
            row[first:last + 1] = scratch        # the draft's view of the row
            if offset % page:                    # the partial frontier's payload
                kp[scratch[0]] = kp[target[first]]
                vp[scratch[0]] = vp[target[first]]
            q = torch.randn((1, C, KV * G, Dh), generator=gen, device=DEVICE).to(dtype)
            o = ops.paged_prefill(q, kp, vp, row, offset, valid, Dh ** -0.5)
            torch.cuda.synchronize()
            r = ops.paged_prefill_plain(q, kp, vp, row, offset, valid, Dh ** -0.5)
            err = max(err, (o[0, :valid].float() - r[0, :valid].float()).abs().max().item())
            calls += 1
    route = ops.prefill_route(dtype, Dh, Dh)
    moved = routes_moved(ops.ROUTE_LAUNCHES, before)
    check(moved == {r: calls * (r == route) for r in moved},
          f"paged_prefill verify {dtype} G={G}: routes {moved}, want all {route}")
    return err


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


T3_SHAPES = ((16, 1, 64), (8, 4, 128), (8, 3, 128), (32, 1, 64))   # KV, G, Dp (G = 3:
# phi4-mini; KV 32: musicgen)
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
    (1, 512, 512, 64, 8, 128, True, 512),    # serve (o), jamba: 64 heads over 8, Dh 128: a
    (8, 512, 512, 64, 8, 128, True, 512),    # one-shot admission's prompt, the static
    (8, 1, 575, 64, 8, 128, False, 576),     # prefill and the last static decode
    (8, 512, 1600, 32, 8, 128, False, 1600),  # serve (p), llama-vision's cross-attention:
    (1, 77, 1600, 32, 8, 128, False, 1600),  # the static prompts over 1600 patch keys (T < S),
    (8, 1, 1600, 32, 8, 128, False, 1600),   # a short one, and a decode token over them
    (8, 512, 512, 32, 32, 64, True, 512),    # serve (q), musicgen: its static prefill and
    (8, 1, 575, 32, 32, 64, False, 576),     # its last static decode
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
    (8, 576, 16, 512, 1, 64, 575),           # deepseek-v2-lite's static MLA decode
    (8, 576, 16, 512, 1, 64, 193),           # ... past one key split, length < N
    (2, 40, 16, 512, 1, 64, 0),              # ... length 0
    (8, 576, 32, 2048, 32, 0, 575),          # musicgen's static T1 decode (the sweep)
)
CPQC_SWEEP = (  # B, N, KV, G, Dh, bits, length
    (8, 576, 16, 1, 64, 4, 575),             # qwen1.5-0.5b's static T2 decode
    (4, 300, 4, 4, 128, 8, 250),             # G = 4, length < N
    (2, 77, 16, 1, 64, 8, 77),               # N no multiple of a split
    (2, 90, 1, 8, 256, 4, 77),               # gemma-2b: 8 heads over one kv head, Dh 256
    (8, 576, 32, 1, 64, 4, 575),             # musicgen's static T2 decode (MHA, 32 heads)
)


# B8 at MLA's prompt shapes (deepseek-v2-lite: 16 heads of Dh 192 = nope 128 +
# rope 64 and Dv 128, every head its own K/V): one-shot admissions of 64-512
# tokens, the static batch of 8 x 512, T no multiple of a tile, k and v a prefix
MLA_FLASH_SWEEP = (  # B, T, S, H, KV, Dh, Dv, causal, arena
    (1, 512, 512, 16, 16, 192, 128, True, 512), (1, 64, 64, 16, 16, 192, 128, True, 64),
    (8, 512, 512, 16, 16, 192, 128, True, 512), (3, 77, 77, 16, 16, 192, 128, True, 77),
    (2, 200, 200, 16, 16, 192, 128, True, 208), (2, 200, 200, 16, 16, 192, 128, False, 200))


def exact_attention(q, k, v, scale: float, causal: bool) -> torch.Tensor:
    """Attention worked wholly in float64 from the given inputs, H / KV
    query heads sharing each k and v head: what B8's bf16 cases are held
    against."""
    g = q.shape[2] // k.shape[2]
    k, v = (t.double().repeat_interleave(g, dim=2) for t in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q.double(), k) * scale
    if causal:  # query i sees keys 0..i
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).triu(1),
                          float("-inf"))
    return torch.einsum("bhts,bshd->bthd", s.softmax(-1), v)


def sweep_flash(fa_ops, dtype, cases=None, exact: dict | None = None) -> dict:
    """Max abs error of B8 per FLASH_SWEEP case (or per ``cases`` of
    MLA_FLASH_SWEEP's form, Dh and Dv apart): in float32 against its plain
    version; in bf16 against ``exact_attention`` on the same bf16 inputs,
    and no farther from it than the plain version (which rounds the
    normalised weights to bf16, where the kernel rounds the unnormalised
    ones, whose largest is exactly 1). ``exact`` collects each bf16 case's
    three distances. Every prompt call in bf16 must take the tensor-core
    route."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    cases = cases or [(B, T, S, H, KV, D, D, c, a) for B, T, S, H, KV, D, c, a in FLASH_SWEEP]
    for B, T, S, H, KV, Dh, Dv, causal, arena in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                   for shape in ((B, T, H, Dh), (B, arena, KV, Dh), (B, arena, KV, Dv)))
        k, v = k[:, :S], v[:, :S]
        before = dict(fa_ops.ROUTE_LAUNCHES)
        got = fa_ops.flash_attention(q, k, v, Dh ** -0.5, causal)
        torch.cuda.synchronize()
        route = "decode" if T == 1 else "prompt" if dtype == torch.bfloat16 else "prompt_f32"
        moved = routes_moved(fa_ops.ROUTE_LAUNCHES, before)
        width = f"D={Dh}" if Dh == Dv else f"Dh={Dh} Dv={Dv}"
        tag = f"B={B} T={T} S={S} H={H} KV={KV} {width} causal={causal}"
        check(moved == {r: int(r == route) for r in moved},
              f"flash_attention {dtype} {tag}: routes {moved}, want {route}")
        ref = fa_ops.flash_attention_plain(q, k, v, Dh ** -0.5, causal)
        if dtype == torch.float32:
            out[tag] = (got - ref).abs().max().item()
            continue
        oracle = exact_attention(q, k, v, Dh ** -0.5, causal)
        out[tag], plain = ((t.double() - oracle).abs().max().item() for t in (got, ref))
        check(out[tag] <= plain, f"flash_attention {dtype} {tag}: {out[tag]} from exact "
              f"attention, farther than the plain version's {plain}")
        if exact is not None:
            exact[tag] = {"kernel": out[tag], "plain": plain,
                          "kernel_vs_plain": (got.float() - ref.float()).abs().max().item()}
        del oracle
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


def static_prompts(vocab: int) -> dict:
    """The static serve's batch: 8 prompts of 512 seeded tokens."""
    rng = np.random.default_rng(SEED + 1)
    return {"tokens": rng.integers(0, vocab, size=(8, 512)).astype(np.int32)}


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
            out, stats = eng.generate(prompts, T.GenerationConfig(max_new_tokens=n_new))
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


def flash_prefill_case(fa_ops, scale, causal: bool = True):
    """B8 at a sampled prompt call (causal over the prompt, or not: the
    cross-attention over the patch keys); the yardstick is
    scaled_dot_product_attention on the same q, k, v."""
    def make(sample, k0, v0):
        (q,) = sample
        gqa = {"enable_gqa": True} if q.shape[2] != k0.shape[2] else {}
        return (lambda k, v: fa_ops.flash_attention(q, k, v, scale, causal),
                lambda: fa_ops.flash_attention_plain(q, k0, v0, scale, causal),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k0.transpose(1, 2), v0.transpose(1, 2),
                    is_causal=causal, scale=scale, **gqa),
                flash_bound(q, k0.shape[1], k0.shape[2], v0.shape[3], causal))
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


def t1c_recorder(t1_ops, n_layers: int) -> Recorder:
    """B9's Recorder: each layer's X and roped-key arenas, and a sample of
    R, q_rope and the length as the kernel gets them."""
    return Recorder(t1_ops.decomposed_decode, n_layers, 10, lambda qn, qr, x, kr, *r: (x, kr),
                    lambda qn, qr, x, kr, ln, wk, wv, s: (
                        t1_ops.query_rows(qn, wk, x.dtype)[:, 0],
                        qr[:, 0].to(x.dtype).contiguous(), ln))


def cpqc_recorder(cpq_ops, n_layers: int) -> Recorder:
    """B10's Recorder: each layer's K and V codes, and a sample of the
    float32 query grouped by kv head and the length."""
    return Recorder(cpq_ops.cpq_decode, n_layers, 10, lambda q, kt, vt, *r: (kt, vt),
                    lambda q, kt, vt, ln, *r: (q[:, 0].reshape(q.shape[0], kt.codes.shape[2],
                                                               -1, q.shape[3]).float()
                                               .contiguous(), ln))


def t3c_recorder(t3_ops, n_layers: int) -> Recorder:
    """B7's Recorder in its contiguous form (``proxy_scores_q``, the static
    T3 decode): each layer's codes and proxy tables, and a sample of the
    pre-scaled query and the length."""
    return Recorder(t3_ops.proxy_scores_q, n_layers, 10, lambda q, sc, z, codes, ln: (codes,
                                                                                     (sc, z)),
                    lambda q, sc, z, codes, ln: (q.clone(), int(ln)))


def t3c_decode_case(t3_ops):
    """B7 at a sampled static T3 decode call (``proxy_scores_q``: one launch
    that forms the query factors and scores the first ``length`` keys); the
    yardstick is torch.matmul of the factors, formed beforehand, against the
    written codes shifted by 128 and converted to float32 beforehand, plus
    qz."""
    def make(sample, codes0, tables0):
        q, length = sample
        qs, qz = t3_ops.query_factors(q, *tables0)
        cg = (codes0[:, :length].float() + 128.0).permute(0, 2, 3, 1).contiguous()
        n = torch.tensor(length, device=q.device)  # the plain mask's length, on the card
        return (lambda codes, tables: t3_ops.proxy_scores_q(q, *tables, codes, length),
                lambda: t3_ops.proxy_scores_plain(qs, qz, codes0, n),
                lambda: torch.matmul(qs, cg) + qz,
                t3c_bound(q, tables0, length, codes0))
    return make


def t3c_bound(q, tables, length, codes0):
    """(bytes, flops, float32 flops) one contiguous B7 call needs: the first
    ``length`` codes of every row, q, the proxy scale and zero tables and
    the N scores of every row written; one float32 multiply-add per written
    code and query head."""
    B, H = q.shape[:2]
    N, KV, Dp = codes0.shape[1:]
    nbytes = (B * length * KV * Dp + q.numel() * q.element_size() + 2 * tables[0].numel() * 4
              + B * H * N * 4)
    return nbytes, 0.0, 2.0 * B * length * H * Dp


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
        eng.generate(prompts, T.GenerationConfig(max_new_tokens=n_new))
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
            logits, ctg = M.prefill(cfg, rt, params, {"tokens": torch.tensor(tok[None],
                                                                        device=DEVICE)},
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


def compare_streams(mode: str, streams: dict, gaps: dict, lengths: dict,
                    names=("kernels", "gather")) -> int:
    """Greedy streams of the kernel path (``streams[True]``) and the gather
    path (or the two ``names``), by request id: identical, but for a first
    divergence where the gather path's top-2 logit gap is below ARGMAX_GAP.
    Returns the number of identical streams."""
    excused = 0
    for rid, n in lengths.items():
        a, b = streams[True][rid], streams[False][rid]
        check(len(a) == len(b) == n, f"parity {mode}: request {rid} lengths")
        diff = np.flatnonzero(a != b)
        if not len(diff):
            continue
        t = int(diff[0])   # after a divergence the contexts differ: stop there
        gap = gaps[(rid, t)]
        log(f"parity {mode}: request {rid} diverges at token {t}: {names[0]} {a[t]} vs "
            f"{names[1]} {b[t]}, {names[1]} top-2 gap {gap:.3e}")
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
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in prompts.items()}
    B, S = (batch["tokens"] if "tokens" in batch else batch["frames"]).shape[:2]
    caches = M.init_caches(cfg, rt, B, S + 1, DEVICE)
    pre, caches = M.prefill(cfg, rt, params, batch, caches)
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


def static_parity(T, M, cfg, params, prompts, mode: str, n_new: int, rt_kw=None,
                  what: str | None = None) -> dict:
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
    what = what or f"static {mode}"
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
            return engs[False].generate(prompts, gen)[0]

    if lockstep:
        with SharedKV() as shared, pin_if(pinned) as pin:
            a, b = pair([shared] + [pin] * pinned,
                        lambda: engs[True].generate(prompts, gen)[0], gather)
        if pinned:
            out.update(pin_report(what, "streams", pin))
    else:
        a, b = engs[True].generate(prompts, gen)[0], gather()
    out["streams_identical"] = compare_streams(
        what, {True: dict(enumerate(a)), False: dict(enumerate(b))}, gaps,
        {row: n_new for row in range(len(a))})
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


# ------------------------- phase 6: the DeepSeek stacks and T1+T2 (T1 + CPQ)

DEEPSEEK_SERVING = dict(num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64,
                        prefill_chunk=0, prefill_bucket=16)  # (a)'s arena, one-shot
MOE_DEPTH = 4               # layers of serve (m): deepseek-moe-16b's dense layer and 3 MoE
                            # (8 until phase 8 came: cut to keep the script's time)
DCPQ_DEPTH = 6              # layers of serve (l) (of 24; cut to 12 for phase 7, to 6 for 8)
ROUTER_GAP = 1e-5           # relative top-k boundary gap of the router below which a flip is a tie


def deepseek_config(T, name: str, num_blocks: int | None = None):
    """A DeepSeek config at its published widths (``num_blocks`` cuts its
    depth where given)."""
    cfg = T.ARCHS[name]
    check(cfg.d_model == 2048 and cfg.vocab_size == 102400 and cfg.moe.num_experts == 64
          and cfg.moe.top_k == 6 and cfg.moe.num_shared == 2 and cfg.moe.d_ff_expert == 1408,
          f"{name}: not the published widths")
    return cfg if num_blocks is None else dataclasses.replace(cfg, num_blocks=num_blocks)


def head_layers(tree, cfg, depth: int):
    """A parameter tree cut to its first ``depth`` layers, as float32 (the
    prefix layers, then the first blocks)."""
    n = depth - len(cfg.prefix_pattern)
    return _tree_float({**tree, "blocks": [b[:n] for b in tree["blocks"]]})


def serve_counted(eng, T, reqs, counted: list, fa_routes: dict, routed: dict):
    """``serve_timed`` with every launch and route count set to 0 just before
    and read just after."""
    zero_launches(counted, fa_routes)
    zero_routes(routed)
    results, stats, ticks, wall = serve_timed(eng, T, reqs)
    return results, stats, ticks, wall, counted_launches(counted, fa_routes)


def check_counts(what: str, counts: dict, want: dict) -> None:
    full = {name: want.get(name, 0) for name in counts}
    check(counts == full, f"{what}: launch counts {counts}, want {full}")


class RouterLog:
    """Wraps ``models.moe.route`` while it is entered: keeps, for every router
    call, the engine tick it ran in (``tick``, set by the caller), each
    token's top-k experts as a set and the relative gap between the k-th and
    the (k+1)-th largest probability (the top-k boundary)."""

    def __init__(self, moe):
        self.moe, self.calls, self.tick = moe, [], 0

    def __enter__(self):
        self.route = self.moe.route

        def logged(cfg, router, xg):
            out = self.route(cfg, router, xg)
            probs, _, top_e, _ = out
            K = cfg.moe.top_k
            p = probs.sort(dim=-1, descending=True).values[..., :K + 1]
            gap = (p[..., K - 1] - p[..., K]) / p[..., K - 1]
            self.calls.append((self.tick, top_e.sort(dim=-1).values.cpu(), gap.cpu()))
            return out
        self.moe.route = logged
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def first_route_diff(a: RouterLog, b: RouterLog):
    """(tick, call index, relative gap) of the first router call whose top-k
    sets differ between two logs of the same schedule, the gap the largest
    over the tokens that differ of the smaller of the two paths' gaps; and
    the number of calls that differ. (None, count) when none does."""
    first, differ = None, 0
    for i, ((tick, ea, ga), (_, eb, gb)) in enumerate(zip(a.calls, b.calls)):
        d = (ea != eb).any(-1) if ea.shape == eb.shape else None
        if d is None or d.any():
            differ += 1
            if first is None:
                gap = (float("inf") if d is None
                       else torch.minimum(ga, gb)[d].max().item())
                first = (tick, i, gap)
    return first, differ + abs(len(a.calls) - len(b.calls))


def moe_parity(T, M, moe, cfg, params, reqs, what: str, mode: str) -> dict:
    """Kernels on vs the gather path in float32 for a MoE stack, one-shot:
    prefill and first-decode logits of two slots within LOGIT_TOL, then the
    greedy streams and the counters of the served requests, each path on its
    own history. Capacity-factor routing turns a router near tie into a
    different expert, and one flip moves everything after it; so every
    router call of both paths is logged, and where the paths differ the
    first router call whose top-k sets differ must come no later than the
    first tick whose tokens differ and be a near tie (relative top-k
    boundary gap below ROUTER_GAP), or the first tokens that differ must be
    a logit near tie (top-2 gap below ARGMAX_GAP). Such ticks are counted
    and reported."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = (True, False)
    rts = {f: T.AttentionRuntime(mode=mode, paged_kernels=f) for f in paths}
    small = T.ServingCfg(num_slots=2, page_size=16, num_pages=80, max_blocks_per_slot=64,
                         prefill_chunk=0, prefill_bucket=16)
    bt = np.zeros((2, 64), np.int32)
    lens = [len(reqs[0].prompt), len(reqs[1].prompt)]
    perm = np.random.default_rng(SEED).permutation(np.arange(1, 80))
    bt[0, :lens[0] // 16 + 1] = perm[:lens[0] // 16 + 1]
    bt[1, :lens[1] // 16 + 1] = perm[40:40 + lens[1] // 16 + 1]
    out = {}
    logs = {f: RouterLog(moe) for f in paths}
    got = []
    for f in paths:
        with logs[f]:
            got.append(first_logits(M, cfg, rts[f], params, reqs, small, bt))
    first, differ = first_route_diff(logs[True], logs[False])
    errs = max_diff(got)
    out.update(errs)
    out["first_logits_router_calls"], out["first_logits_router_calls_differ"] = (
        len(logs[True].calls), differ)
    for name, err in errs.items():
        log(f"parity {what}: {name} {err:.3e} (atol=rtol={LOGIT_TOL}); {differ} of "
            f"{len(logs[True].calls)} router calls differ")
    close = all(torch.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)
                for a, b in zip(got[0], got[1]))
    check(close or (first is not None and first[2] < ROUTER_GAP),
          f"parity {what}: logits differ past {LOGIT_TOL}, router {first}")

    serving = T.ServingCfg(**DEEPSEEK_SERVING)
    engs = {f: T.ContinuousServeEngine(cfg, params, rt=rts[f], serving=serving, device=DEVICE)
            for f in paths}
    gaps, emitted = {}, {f: [] for f in paths}
    steps = {True: engs[True].step, False: gather_gaps(M, engs[False], gaps)}
    logs = {f: RouterLog(moe) for f in paths}
    for f in paths:
        engs[f].reset(T.GenerationConfig())
        for r in make_requests(T, cfg.vocab_size):
            engs[f].add_request(r)
        with logs[f]:
            while engs[f].has_unfinished():
                emitted[f].append(sorted((e.rid, e.index, e.token) for e in steps[f]()))
                logs[f].tick += 1
    first, differ = first_route_diff(logs[True], logs[False])
    tok_tick = next((i for i, (a, b) in enumerate(zip(emitted[True], emitted[False]))
                     if a != b), None)
    out.update(router_calls=len(logs[True].calls), router_calls_differ=differ,
               first_router_diff=first, first_token_diff_tick=tok_tick)
    log(f"parity {what}: {len(logs[True].calls)} router calls, {differ} differ; first router "
        f"difference (tick, call, relative top-k gap) {first}; first tick whose tokens "
        f"differ {tok_tick}")
    excused = 0
    if tok_tick is not None:
        if first is not None and first[0] <= tok_tick:
            check(first[2] < ROUTER_GAP, f"parity {what}: router call {first[1]} differs at "
                  f"a resolvable relative gap {first[2]:.3e}")
            why = f"after a router near tie (relative gap {first[2]:.3e})"
        else:
            diff = [(a, b) for a, b in zip(emitted[True][tok_tick], emitted[False][tok_tick])
                    if a != b]
            (rid, index, _), _ = diff[0]
            gap = gaps[(rid, index)]
            check(gap < ARGMAX_GAP, f"parity {what}: request {rid} token {index} differs at "
                  f"a resolvable logit gap {gap:.3e}")
            why = f"after a logit near tie (top-2 gap {gap:.3e})"
        streams = {f: {rid: res["tokens"] for rid, res in engs[f].results().items()}
                   for f in paths}
        excused = sum(not np.array_equal(streams[True][r], streams[False][r]) for r in streams[True])
        log(f"parity {what}: {excused} streams differ {why}")
    else:
        check(first is None, f"parity {what}: router calls differ ({first}) but no token does")
    stats = {f: engs[f].stats() for f in paths}
    for key, val in stats[True].items():
        if key not in ("wall_time_s", "tokens_per_s") and tok_tick is None:
            check(np.array_equal(np.asarray(val), np.asarray(stats[False][key])),
                  f"parity {what}: stats[{key}] {val} vs {stats[False][key]}")
    out["streams_identical"] = len(reqs) - excused
    out["streams_excused"] = excused
    log(f"parity {what}: greedy streams identical for {len(reqs) - excused}/{len(reqs)} "
        f"requests; counters {'identical' if tok_tick is None else 'not compared'}")
    del engs
    return out


def serve_deepseek(T, M, counted: list, routed: dict, static_routed: dict, fa_routes: dict,
                   serves: dict, report: dict, new_s: dict) -> None:
    """Phase 6: (k) deepseek-v2-lite at its published widths, 27 layers, in
    bf16 on ContinuousServeEngine (one-shot: a MoE stack), mode decomposed
    (MLA's latent: B8's prompt route per admission and layer, B3 on its
    tensor cores per decode tick and layer) and mode cpq (the latent in CPQ
    codes: B8 alone), and on the static ServeEngine (B8 once per layer, B9
    on its tensor cores per decode step and layer); its f32 parity at
    PARITY_DEPTH layers; (l) qwen1.5-0.5b at DCPQ_DEPTH layers in mode
    decomposed_cpq, chunked on (a)'s arena and static (no kernel but the
    static prefill's B8); (m)
    deepseek-moe-16b at MOE_DEPTH layers, dense, one-shot (B8's prompt
    route, B1's ring) and its f32 parity. Each serve's launch counts are
    set to 0 just before it and read just after."""
    from repro_torch.models import moe
    from repro_torch.params import init_params

    t_all = time.perf_counter()
    cfg = deepseek_config(T, "deepseek-v2-lite-16b")
    check(cfg.num_layers == 27 and cfg.mla.kv_lora_rank == 512 and cfg.d_ff == 10944,
          "deepseek-v2-lite: not the published config")
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, DEVICE)
    torch.cuda.synchronize()
    new_s["deepseek-v2-lite init"] = time.perf_counter() - t0
    log(f"deepseek-v2-lite: {device_bytes(params) / 1e9:.2f} GB of bf16 weights on the card "
        f"in {new_s['deepseek-v2-lite init']:.1f} s")
    serving = T.ServingCfg(**DEEPSEEK_SERVING)
    b3 = {"paged_decomposed_decode": routed["paged_decomposed_decode"]}
    for mode in ("decomposed", "cpq"):
        what = f"deepseek-v2-lite {mode}"
        t0 = time.perf_counter()
        eng = T.ContinuousServeEngine(cfg, params, rt=T.AttentionRuntime(mode=mode),
                                      serving=serving, device=DEVICE)
        run = make_requests(T, cfg.vocab_size)
        results, stats, ticks, wall, counts = serve_counted(eng, T, run, counted, fa_routes,
                                                            routed)
        check_finished(results, run, what)
        check(not stats["chunked_prefill"] and stats["admitted"] == len(run),
              f"{what}: chunked {stats['chunked_prefill']}, {stats['admitted']} admissions")
        want = {"flash_attention": L * stats["admitted"],
                "flash_attention/prompt": L * stats["admitted"]}
        if mode == "decomposed":
            want["paged_decomposed_decode"] = L * stats["decode_steps"]
        check_counts(what, counts, want)
        serves[what] = serve_metrics(stats, ticks, wall, what)
        serves[what].update(launches={k: n for k, n in counts.items() if n},
                            routes=check_routes(what, b3, counts))
        log(f"serve {what}: launches {serves[what]['launches']}, routes "
            f"{serves[what]['routes']}")
        del eng
        torch.cuda.empty_cache()
        new_s[what] = time.perf_counter() - t0
    what = "static deepseek-v2-lite"
    t0 = time.perf_counter()
    eng = T.ServeEngine(cfg, params, rt=T.AttentionRuntime(mode="decomposed"), device=DEVICE)
    prompts, n_new = static_prompts(cfg.vocab_size), 64
    zero_routes(static_routed)
    out, stats, timer, wall, counts = serve_static(eng, T, M, prompts, n_new, {}, counted,
                                                   fa_routes)
    steps = stats["decode_steps"]
    check(out.shape == (8, n_new) and steps == n_new - 1, f"{what}: {out.shape}")
    check_counts(what, counts, {"flash_attention": L, "flash_attention/prompt": L,
                                "decomposed_decode": L * steps})
    serves[what] = static_metrics(out, stats, timer, wall, "deepseek-v2-lite")
    serves[what].update(launches={k: n for k, n in counts.items() if n},
                        routes=check_routes(what, static_routed, counts))
    log(f"serve {what}: launches {serves[what]['launches']}")
    del eng, timer
    new_s[what] = time.perf_counter() - t0
    # free the 31 GB model, keeping its first layers in float32 for the parity
    params_p = head_layers(params, cfg, PARITY_DEPTH)
    del params
    torch.cuda.empty_cache()
    cfg_p = dataclasses.replace(cfg, dtype="float32",
                                num_blocks=PARITY_DEPTH - len(cfg.prefix_pattern))
    t0 = time.perf_counter()
    report["parity"]["deepseek-v2-lite"] = moe_parity(
        T, M, moe, cfg_p, params_p, make_requests(T, cfg.vocab_size),
        "deepseek-v2-lite decomposed", "decomposed")
    del params_p
    torch.cuda.empty_cache()
    new_s["parity deepseek-v2-lite"] = time.perf_counter() - t0
    log(f"[{time.perf_counter() - T0:.0f} s] deepseek-v2-lite served and checked")

    # (l) T1+T2 on qwen1.5-0.5b: chunked on (a)'s arena, then static
    cfg_q = dataclasses.replace(served_config(T), num_blocks=DCPQ_DEPTH)
    params_q = init_params(cfg_q, SEED, DEVICE)
    what = "decomposed_cpq"
    t0 = time.perf_counter()
    eng = T.ContinuousServeEngine(cfg_q, params_q, rt=T.AttentionRuntime(mode=what),
                                  serving=T.ServingCfg(num_slots=8, page_size=16, num_pages=513,
                                                       max_blocks_per_slot=64), device=DEVICE)
    run = make_requests(T, cfg_q.vocab_size)
    results, stats, ticks, wall, counts = serve_counted(eng, T, run, counted, fa_routes, routed)
    check_finished(results, run, what)
    check(stats["chunked_prefill"] and stats["cache_mode"] == what, f"{what}: {stats}")
    check_counts(what, counts, {})   # T1+T2 has no kernel in the reference
    serves[what] = serve_metrics(stats, ticks, wall, what)
    serves[what]["launches"] = {}
    del eng
    eng = T.ServeEngine(cfg_q, params_q, rt=T.AttentionRuntime(mode=what), device=DEVICE)
    out, stats, timer, wall, counts = serve_static(eng, T, M, static_prompts(cfg_q.vocab_size),
                                                   n_new, {}, counted, fa_routes)
    check(out.shape == (8, n_new), f"static {what}: {out.shape}")
    check_counts(f"static {what}", counts, {"flash_attention": cfg_q.num_layers,
                                            "flash_attention/prompt": cfg_q.num_layers})
    serves[f"static {what}"] = static_metrics(out, stats, timer, wall, what)
    serves[f"static {what}"]["launches"] = {k: n for k, n in counts.items() if n}
    del eng, timer, params_q
    torch.cuda.empty_cache()
    new_s[what] = time.perf_counter() - t0

    # (m) deepseek-moe-16b: attention with MoE MLPs, at MOE_DEPTH layers
    cfg_m = deepseek_config(T, "deepseek-moe-16b", MOE_DEPTH - 1)
    what = f"deepseek-moe-16b {MOE_DEPTH} layers"
    t0 = time.perf_counter()
    params_m = init_params(cfg_m, SEED, DEVICE)
    eng = T.ContinuousServeEngine(cfg_m, params_m, serving=T.ServingCfg(
        num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64), device=DEVICE)
    run = make_requests(T, cfg_m.vocab_size)
    results, stats, ticks, wall, counts = serve_counted(eng, T, run, counted, fa_routes, routed)
    check_finished(results, run, what)
    check(not stats["chunked_prefill"], f"{what}: a MoE stack admitted in chunks")
    check_counts(what, counts, {"flash_attention": MOE_DEPTH * stats["admitted"],
                                "flash_attention/prompt": MOE_DEPTH * stats["admitted"],
                                "paged_decode": MOE_DEPTH * stats["decode_steps"]})
    serves[what] = serve_metrics(stats, ticks, wall, what)
    serves[what].update(launches={k: n for k, n in counts.items() if n},
                        routes=check_routes(what, {"paged_decode": routed["paged_decode"]},
                                            counts))
    log(f"serve {what}: launches {serves[what]['launches']}")
    del eng
    new_s[what] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params_p = head_layers(params_m, cfg_m, MOE_DEPTH)
    del params_m
    torch.cuda.empty_cache()
    report["parity"]["deepseek-moe-16b"] = moe_parity(
        T, M, moe, dataclasses.replace(cfg_m, dtype="float32"), params_p,
        make_requests(T, cfg_m.vocab_size), "deepseek-moe-16b dense", "dense")
    del params_p
    torch.cuda.empty_cache()
    new_s["parity deepseek-moe-16b"] = time.perf_counter() - t0
    report["deepseek_phase_s"] = new_s
    log(f"[{time.perf_counter() - T0:.0f} s] phase 6 in {time.perf_counter() - t_all:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in new_s.items()))


# ------------------------------------------ phase 7: the recurrent stacks

RECURRENT_SERVING = dict(num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64,
                         prefill_chunk=16)  # (a)'s arena and chunks: admitted one-shot all the same
JAMBA_DEPTH = 5             # layers of serve (o): the first five of Jamba's block of eight
JAMBA_PARITY_EXPERTS = 8    # routed experts (of 16) of (o)'s float32 parity, top-2 kept
JAMBA_SWEPT = {             # phase 3's cases at jamba's attention (64 heads over 8, Dh 128)
    "paged_decode": "bfloat16 served rows KV=8 G=8 Dh=128",
    "flash_attention_prompt": "bfloat16 B=8 T=512 S=512 H=64 KV=8 D=128 causal=True",
    "flash_attention": "bfloat16 B=8 T=1 S=575 H=64 KV=8 D=128 causal=False"}


def xlstm_config(T):
    """xlstm-125m at its published widths, nothing cut: 12 layers (2 x [5
    mLSTM, 1 sLSTM]), d_model 768, 4 heads, proj_factor 2, vocab 50304."""
    cfg = T.ARCHS["xlstm-125m"]
    x = cfg.xlstm
    check(cfg.num_layers == 12 and cfg.d_model == 768 and cfg.num_heads == 4
          and cfg.vocab_size == 50304 and x.proj_factor == 2.0 and x.chunk == 256
          and x.conv_kernel == 4 and cfg.norm == "layernorm" and not cfg.tie_embeddings,
          "xlstm-125m: not the published widths")
    return cfg


def jamba_config(T):
    """jamba-1.5-large-398b at its published widths, its depth cut to the
    first JAMBA_DEPTH layers of its block of eight (mamba + dense, mamba +
    moe, mamba + dense, mamba + moe, attn + dense) as a prefix with no
    blocks: one block is 90.5 GB in bf16, more than the card holds."""
    cfg = T.ARCHS["jamba-1.5-large-398b"]
    m, e = cfg.mamba, cfg.moe
    check(cfg.d_model == 8192 and cfg.num_heads == 64 and cfg.num_kv_heads == 8
          and cfg.head_dim == 128 and cfg.d_ff == 24576 and cfg.vocab_size == 65536
          and (m.d_state, m.d_conv, m.expand) == (16, 4, 2) and e.num_experts == 16
          and e.top_k == 2 and e.d_ff_expert == 24576, "jamba: not the published widths")
    return dataclasses.replace(cfg, prefix_pattern=cfg.block_pattern[:JAMBA_DEPTH],
                               num_blocks=0)


def slot_state_bytes(cfg) -> int:
    """One slot's recurrent state over the stack, by the arithmetic of its
    shapes: Mamba the conv tail (d_conv - 1 inputs of d_in, model dtype) and
    the float32 SSM state (d_in x d_state); mLSTM C (H x dh x dh), n and m
    in float32 and the conv tail; sLSTM four float32 vectors of d_model."""
    elt = torch.empty((), dtype=cfg.param_dtype).element_size()
    total = 0
    for mixer, _ in cfg.layer_kinds:
        if mixer == "mamba":
            d_in = cfg.mamba.expand * cfg.d_model
            total += (cfg.mamba.d_conv - 1) * d_in * elt + d_in * cfg.mamba.d_state * 4
        elif mixer == "mlstm":
            d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
            H, dh = cfg.num_heads, d_in // cfg.num_heads
            total += (H * dh * dh + H * dh + H) * 4 + (cfg.xlstm.conv_kernel - 1) * d_in * elt
        elif mixer == "slstm":
            total += 4 * cfg.d_model * 4
    return total


def check_oneshot(what: str, stats: dict, n: int) -> None:
    """A recurrent stack asked for chunks is admitted one-shot, every request
    once, sharing and speculation off."""
    check(not stats["chunked_prefill"] and stats["prefill_chunks"] == 0
          and stats["admitted"] == n and not stats["prefix_sharing"] and not stats["spec_on"],
          f"{what}: chunked {stats['chunked_prefill']}, {stats['prefill_chunks']} chunks, "
          f"{stats['admitted']} admissions of {n}")


def device_parity(T, M, cfg, params, what: str) -> dict:
    """The same port code in float32 (TF32 off) on the card and on the CPU,
    on 2 of the 8 requests (the shortest and the longest prompt) through
    ContinuousServeEngine: each admission's prefill logits and the first
    decode step's within LOGIT_TOL, then the greedy streams identical but
    for a first divergence where the CPU's top-2 logit gap is below
    ARGMAX_GAP."""
    from repro_torch.params import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    serving = T.ServingCfg(num_slots=2, page_size=16, num_pages=80, max_blocks_per_slot=64)
    pre, dec = M.prefill, M.decode_step_rows
    got, streams, gaps = {}, {}, {}
    for dev in (DEVICE, "cpu"):
        eng = T.ContinuousServeEngine(cfg, to_device(params, dev), serving=serving, device=dev)
        eng.reset(T.GenerationConfig())
        for r in make_requests(T, cfg.vocab_size)[:2]:
            eng.add_request(r)
        seen = {"prefill": [], "decode": []}

        def keep_pre(*a, seen=seen, **kw):
            out = pre(*a, **kw)
            seen["prefill"].append(out[0].cpu())
            return out

        def keep_dec(*a, seen=seen):
            out = dec(*a)
            seen["decode"].append(out[0].cpu())
            return out

        M.prefill, M.decode_step_rows = keep_pre, keep_dec
        try:
            step = gather_gaps(M, eng, gaps) if dev == "cpu" else eng.step
            while eng.has_unfinished():
                step()
        finally:
            M.prefill, M.decode_step_rows = pre, dec
        got[dev] = (torch.cat(seen["prefill"][:2]), seen["decode"][0])
        streams[dev] = {rid: res["tokens"] for rid, res in eng.results().items()}
        del eng
    out = {}
    check_logits(f"{what} card vs CPU", (got[DEVICE], got["cpu"]), out)
    out["streams_identical"] = compare_streams(
        f"{what} card vs CPU", {True: streams[DEVICE], False: streams["cpu"]}, gaps,
        {r.rid: r.max_new_tokens for r in make_requests(T, cfg.vocab_size)[:2]},
        names=("card", "CPU"))
    return out


def teacher_forced(T, M, cfg, params, what: str, n_new: int = 64) -> dict:
    """The whole stack in float32 (TF32 off), the card's continuous decode
    against the CPU's static one, one step at a time from the CPU's own
    state: request i of 2 (the shortest and the longest prompt) is prefilled
    on the CPU and decoded greedily there (``decode_step``); before every
    step the CPU's state is written into row i of a 2-slot state tree on the
    card (``init_paged_caches``, ``pack_prefill_caches``), which takes the
    same step through ``decode_step_rows`` as ContinuousServeEngine does.
    Its logits must be within LOGIT_TOL of the CPU's, its argmax the CPU's
    but where the CPU's top-2 gap is below ARGMAX_GAP (counted), and the
    state it wrote in place into row i the CPU's new state within LOGIT_TOL
    (atol = rtol), every leaf of every layer. Also reported, no gate: the
    prefill logits of the card's own prefill against the CPU's, and the
    CPU's against its own prefill of embeddings scaled by 1 + 1e-7 (how far
    a last-ulp difference carries)."""
    from repro_torch.params import to_device
    from repro_torch.serving.paged_cache import RowState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rt = cfg.attention
    cpu = to_device(params, "cpu")
    nudged = {**cpu, "embed": {**cpu["embed"], "tok": cpu["embed"]["tok"] * (1 + 1e-7)}}
    serving = T.ServingCfg(num_slots=2, page_size=16, num_pages=80, max_blocks_per_slot=64)
    card = M.init_paged_caches(cfg, rt, serving, DEVICE)
    out = {"decode_steps": 0, "argmax_excused": 0, "logits_max_abs_diff": 0.0,
           "state_max_abs_diff": 0.0,
           "free_prefill_logits_max_abs_diff": [], "cpu_nudged_prefill_logits_max_abs_diff": []}
    for slot, r in enumerate(make_requests(T, cfg.vocab_size)[:2]):
        S = len(r.prompt)
        tok = torch.tensor(r.prompt[None])

        def prefill(p, dev):
            caches = M.init_caches(cfg, rt, 1, S + n_new, dev)
            return M.prefill(cfg, rt, p, {"tokens": tok.to(dev)}, caches)

        logits, caches = prefill(cpu, "cpu")
        free = prefill(params, DEVICE)[0].cpu()
        out["free_prefill_logits_max_abs_diff"].append((free - logits).abs().max().item())
        out["cpu_nudged_prefill_logits_max_abs_diff"].append(
            (prefill(nudged, "cpu")[0] - logits).abs().max().item())
        for t in range(n_new):
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            M.pack_prefill_caches(cfg, rt, card, caches, None, slot)
            tokens = torch.zeros((2, 1), dtype=torch.int32)
            tokens[slot] = nxt[0]
            rows = RowState(lengths=torch.full((2,), S + t, dtype=torch.int32, device=DEVICE),
                            block_table=torch.zeros((2, 64), dtype=torch.int32, device=DEVICE),
                            active=torch.arange(2, device=DEVICE) == slot,
                            tier=torch.zeros(2, dtype=torch.int32, device=DEVICE))
            got, _ = M.decode_step_rows(cfg, rt, params, tokens.to(DEVICE), rows, card)
            logits, caches = M.decode_step(cfg, rt, cpu, nxt, S + t, caches)
            got = got[slot:slot + 1].cpu()
            err = (got - logits).abs().max().item()
            out["logits_max_abs_diff"] = max(out["logits_max_abs_diff"], err)
            check(torch.allclose(got, logits, atol=LOGIT_TOL, rtol=LOGIT_TOL),
                  f"parity {what}: request {r.rid} step {t}: logits differ by {err:.3e}")
            if not torch.equal(got.argmax(-1), logits.argmax(-1)):
                gap = top2_gap(logits).item()
                check(gap < ARGMAX_GAP, f"parity {what}: request {r.rid} step {t}: argmax "
                      f"differs at a resolvable gap {gap:.3e}")
                out["argmax_excused"] += 1
            for i, (dst, src) in enumerate(zip(M.per_layer(cfg, card), M.per_layer(cfg, caches))):
                for name, d, c in zip(src._fields, dst, src):
                    d = d[slot].cpu()
                    err = (d - c[0]).abs().max().item()
                    out["state_max_abs_diff"] = max(out["state_max_abs_diff"], err)
                    check(torch.allclose(d, c[0], atol=LOGIT_TOL, rtol=LOGIT_TOL),
                          f"parity {what}: request {r.rid} step {t}: layer {i} state "
                          f"{name} differs by {err:.3e}")
            out["decode_steps"] += 1
    log(f"parity {what}: {out['decode_steps']} continuous decode steps (decode_step_rows, "
        f"request i in row i of 2) from the CPU's state, logits within "
        f"{out['logits_max_abs_diff']:.3e} and the states written in place within "
        f"{out['state_max_abs_diff']:.3e} (atol=rtol={LOGIT_TOL}), "
        f"{out['argmax_excused']} argmax near ties excused; free-running prefill logits "
        f"card vs CPU {out['free_prefill_logits_max_abs_diff']}, CPU vs its embeddings "
        f"scaled by 1 + 1e-7 {out['cpu_nudged_prefill_logits_max_abs_diff']} (no gate)")
    return out


def cut_float(tree, experts: int):
    """A parameter tree in float32, in place, each MoE layer's routed experts
    cut to the first ``experts`` (its router's columns too): every leaf is
    replaced by its copy as the copy is made, so the bf16 model and the
    float32 one are never both whole on the card."""
    if isinstance(tree, list):
        for t in tree:
            cut_float(t, experts)
        return tree
    moe = "router" in tree
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            cut_float(v, experts)
        elif moe and k == "router":
            tree[k] = v[:, :experts].float()
        elif moe and k in ("w_gate", "w_up", "w_down"):
            tree[k] = v[:experts].float()
        else:
            tree[k] = v.float()
    return tree


def serve_recurrent(T, M, ops, fa_ops, counted: list, routed: dict, fa_routes: dict,
                    serves: dict, report: dict, timing: dict, new_s: dict) -> None:
    """Phase 7: (n) xlstm-125m at its published widths, bf16, on
    ContinuousServeEngine over (a)'s arena and traffic, asked for chunks of
    16 but admitted one-shot at the exact prompt length (no attention
    kernel), and on the static ServeEngine (8 x 512, 64 new); its float32
    parity, card against CPU, on 2 of the 8 requests: the whole stack step
    by step from the CPU's state, the card's continuous decode against the
    CPU's static one (``teacher_forced``), its mLSTM layers
    alone free-running (``device_parity``). (o) jamba at its
    published widths cut to its first JAMBA_DEPTH layers, dense, one-shot
    (B8's prompt route once an admission, B1's ring once a decode tick, B1
    timed at the served shape) and static (B8's prompt route once, its
    single-query route once a step, both timed); its float32 parity,
    kernels on and off, with the routed experts cut to JAMBA_PARITY_EXPERTS
    (the bf16 model freed first). Each serve's launch counts are set to 0
    just before it and read just after."""
    from repro_torch.models import moe
    from repro_torch.params import init_params

    t_all = time.perf_counter()
    # (n) xlstm-125m
    cfg = xlstm_config(T)
    what = "xlstm-125m"
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, DEVICE)
    log(f"{what}: {device_bytes(params) / 1e9:.3f} GB of bf16 weights on the card")
    n_slots = RECURRENT_SERVING["num_slots"]
    per_slot = slot_state_bytes(cfg)
    eng = T.ContinuousServeEngine(cfg, params, serving=T.ServingCfg(**RECURRENT_SERVING),
                                  device=DEVICE)
    run = make_requests(T, cfg.vocab_size)
    results, stats, ticks, wall, counts = serve_counted(eng, T, run, counted, fa_routes, routed)
    check_finished(results, run, what)
    check_oneshot(what, stats, len(run))
    check_counts(what, counts, {})   # attention-free: no kernel
    check(stats["arena_bytes_total"] == n_slots * per_slot and stats["bytes_per_token_layer"] == 0,
          f"{what}: arena {stats['arena_bytes_total']} bytes, want {n_slots} x {per_slot}")
    serves[what] = serve_metrics(stats, ticks, wall, what)
    serves[what].update(launches={}, state_bytes_per_slot=per_slot)
    log(f"serve {what}: slot state {per_slot} bytes a slot ({n_slots} slots); no kernel "
        f"launched")
    del eng
    new_s[what] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = T.ServeEngine(cfg, params, device=DEVICE)
    out, stats, timer, wall, counts = serve_static(eng, T, M, static_prompts(cfg.vocab_size), 64,
                                                   {}, counted, fa_routes)
    check(out.shape == (8, 64) and stats["decode_steps"] == 63, f"static {what}: {out.shape}")
    check_counts(f"static {what}", counts, {})
    serves[f"static {what}"] = static_metrics(out, stats, timer, wall, what)
    serves[f"static {what}"]["launches"] = {}
    check(serves[f"static {what}"]["arena_bytes"] == 8 * per_slot, f"static {what}: arena")
    del eng, timer
    new_s[f"static {what}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = _tree_float(params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    # the sLSTM's recurrence is chaotic at these random weights (the
    # reference's fan-in init draws r with std 0.5 on 192-wide heads): a
    # last-ulp difference grows to O(1) over a prompt. So the whole stack is
    # held step by step from the CPU's state, and the stack of its 10 mLSTM
    # layers alone free-running through the engines
    report["parity"][what] = teacher_forced(T, M, cfg32, params, what)
    mlstm = [i for i, (m, _) in enumerate(cfg.block_pattern) if m == "mlstm"]
    report["parity"][f"{what} mLSTM layers"] = device_parity(
        T, M, dataclasses.replace(cfg32, block_pattern=tuple(cfg.block_pattern[i] for i in mlstm)),
        {**params, "blocks": [params["blocks"][i] for i in mlstm]}, f"{what} mLSTM layers")
    del params
    torch.cuda.empty_cache()
    new_s[f"parity {what}"] = time.perf_counter() - t0
    log(f"[{time.perf_counter() - T0:.0f} s] {what} served and checked")

    # (o) jamba, the first JAMBA_DEPTH layers
    cfg = jamba_config(T)
    what = f"jamba {JAMBA_DEPTH} layers"
    n_attn = sum(m == "attn" for m, _ in cfg.layer_kinds)
    scale = cfg.head_dim ** -0.5
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, DEVICE)
    torch.cuda.synchronize()
    log(f"{what}: {device_bytes(params) / 1e9:.2f} GB of bf16 weights on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = T.ContinuousServeEngine(cfg, params, serving=T.ServingCfg(**RECURRENT_SERVING),
                                  device=DEVICE)
    rec = Recorder(ops.paged_decode, n_attn, 10, lambda q, k, v, *r: (k, v),
                   lambda q, k, v, bt, ln, s: (q.clone(), bt.clone(), ln.clone()))
    ops.paged_decode = rec
    run = make_requests(T, cfg.vocab_size)
    try:
        results, stats, ticks, wall, counts = serve_counted(eng, T, run, counted, fa_routes,
                                                            routed)
    finally:
        ops.paged_decode = rec.fn
    check_finished(results, run, what)
    check_oneshot(what, stats, len(run))
    check_counts(what, counts, {"flash_attention": n_attn * stats["admitted"],
                                "flash_attention/prompt": n_attn * stats["admitted"],
                                "paged_decode": n_attn * stats["decode_steps"]})
    per_slot = slot_state_bytes(cfg)
    serves[what] = serve_metrics(stats, ticks, wall, what)
    serves[what].update(
        launches={k: n for k, n in counts.items() if n}, state_bytes_per_slot=per_slot,
        attention_arena_bytes=stats["arena_bytes_total"] - n_slots * per_slot,
        routes=check_routes(what, {"paged_decode": routed["paged_decode"]}, counts))
    log(f"serve {what}: launches {serves[what]['launches']}; slot state {per_slot} bytes a "
        f"slot, attention arena {serves[what]['attention_arena_bytes']} bytes")
    del eng
    timing["paged_decode"] = time_kernel(rec, decode_case(ops, scale))
    log_timing(f"paged_decode at {what}", timing["paged_decode"], counts["paged_decode"],
               counts["paged_decode"] / stats["decode_steps"])
    del rec
    new_s[what] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = T.ServeEngine(cfg, params, device=DEVICE)
    frec = FlashRecorder(fa_ops.flash_attention, n_attn)
    out, stats, timer, wall, counts = serve_static(
        eng, T, M, static_prompts(cfg.vocab_size), 64, {"flash_attention": (fa_ops, frec)},
        counted, fa_routes)
    steps = stats["decode_steps"]
    check(out.shape == (8, 64) and steps == 63, f"static {what}: {out.shape}")
    check_counts(f"static {what}", counts, {"flash_attention": n_attn * (1 + steps),
                                            "flash_attention/prompt": n_attn,
                                            "flash_attention/decode": n_attn * steps})
    serves[f"static {what}"] = static_metrics(out, stats, timer, wall, what)
    serves[f"static {what}"]["launches"] = {k: n for k, n in counts.items() if n}
    del eng, timer
    for name, r, case, n in (
            ("flash_attention_prompt", frec.pre, flash_prefill_case(fa_ops, scale), 1),
            ("flash_attention", frec.dec, flash_decode_case(fa_ops, scale), steps)):
        timing[name] = time_kernel(r, case)
        log_timing(f"{name} at static {what}", timing[name], n_attn * n, n_attn,
                   "prefill" if n == 1 else "step")
    del frec
    new_s[f"static {what}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    E = JAMBA_PARITY_EXPERTS
    params = cut_float(params, E)
    torch.cuda.empty_cache()
    cfg_p = dataclasses.replace(cfg, dtype="float32",
                                moe=dataclasses.replace(cfg.moe, num_experts=E))
    log(f"{what}: {device_bytes(params) / 1e9:.2f} GB in float32 with {E} routed experts")
    report["parity"]["jamba"] = moe_parity(T, M, moe, cfg_p, params,
                                           make_requests(T, cfg.vocab_size),
                                           f"{what} dense", "dense")
    del params
    torch.cuda.empty_cache()
    new_s[f"parity {what}"] = time.perf_counter() - t0
    report["recurrent_phase_s"] = new_s
    report["recurrent_timing"] = timing
    log(f"[{time.perf_counter() - T0:.0f} s] phase 7 in {time.perf_counter() - t_all:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in new_s.items()))


# ------------------------------------------------------ phase 8: multimodal

MUSICGEN_MODES = ("dense", "decomposed", "cpq", "retrieval")
STEP_KERNEL = {"dense": "flash_attention", "decomposed": "decomposed_decode",
               "cpq": "cpq_decode", "retrieval": "proxy_scores"}
XATTN_GATE = 1.0            # (p)'s cross-attention gates (the reference draws them at 0)
PATCH_MOVE = (3.0, 1.0)     # (p)'s parity repeated with the patches scaled by 3, shifted by 1
DECOMPOSED_TOL = 3e-4       # (q): T1 against dense logits, exact at absolute positions
# phase 3's cases at the shapes phase 8 times, by (kernel, shape label)
MULTIMODAL_SWEPT = {
    ("flash_attention_prompt", "llama-vision xattn"):
        "bfloat16 B=8 T=512 S=1600 H=32 KV=8 D=128 causal=False",
    ("flash_attention_prompt", "musicgen"):
        "bfloat16 B=8 T=512 S=512 H=32 KV=32 D=64 causal=True",
    ("flash_attention", "llama-vision xattn"):
        "bfloat16 B=8 T=1 S=1600 H=32 KV=8 D=128 causal=False",
    ("flash_attention", "musicgen"): "bfloat16 B=8 T=1 S=575 H=32 KV=32 D=64 causal=False",
    ("decomposed_decode", "musicgen"):
        "bfloat16 B=8 N=576 H=32 Dm=2048 kv_r=32 Rr=0 length=575",
    ("cpq_decode", "musicgen"):
        "float32 q=bfloat16 B=8 N=576 KV=32 G=1 Dh=64 bits=4 length=575 round=True",
    ("paged_proxy_scores", "musicgen"): "float32 KV=32 G=1 Dp=64",
}


def vision_config(T):
    """llama-3.2-vision-11b at its published widths, nothing cut: 40 layers,
    8 blocks of (attn, attn, attn, xattn, attn), d_model 4096, 32 heads over
    8 of 128, SwiGLU d_ff 14336, vocab 128256, untied, rope theta 500000,
    1600 patch tokens."""
    cfg = T.ARCHS["llama-3.2-vision-11b"]
    check(cfg.num_layers == 40 and cfg.num_blocks == 8 and cfg.d_model == 4096
          and [m for m, _ in cfg.block_pattern] == ["attn"] * 3 + ["xattn", "attn"]
          and (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (32, 8, 128)
          and cfg.d_ff == 14336 and cfg.mlp_act == "swiglu" and cfg.vocab_size == 128256
          and not cfg.tie_embeddings and cfg.rope_theta == 500000.0
          and cfg.input_kind == "text+patches" and cfg.num_patch_tokens == 1600,
          "llama-3.2-vision-11b: not the published widths")
    return cfg


def musicgen_config(T):
    """musicgen-large at its published widths, nothing cut: 48 layers,
    d_model 2048, 32 heads of 64 (MHA), GELU d_ff 8192, layernorm, absolute
    positions, vocab 2048, audio frames in."""
    cfg = T.ARCHS["musicgen-large"]
    check(cfg.num_layers == 48 and cfg.d_model == 2048
          and (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (32, 32, 64)
          and cfg.d_ff == 8192 and cfg.mlp_act == "gelu" and cfg.norm == "layernorm"
          and cfg.pos_embedding == "absolute" and cfg.vocab_size == 2048
          and cfg.input_kind == "audio_frames", "musicgen-large: not the published widths")
    return cfg


def multimodal_batch(cfg) -> dict:
    """A static serve's batch of 8 rows, float32 on the card, drawn as the
    reference's tests/test_models_smoke.py draws them: musicgen 512 frames
    of 0.3 N(0, 1) a row; llama-vision 512 seeded tokens and 1600 patches
    of N(0, 1) a row."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    if cfg.input_kind == "audio_frames":
        return {"frames": 0.3 * torch.randn((8, 512, cfg.d_model), generator=gen, device=DEVICE)}
    return {**static_prompts(cfg.vocab_size),
            "patches": torch.randn((8, cfg.num_patch_tokens, cfg.d_model), generator=gen,
                                   device=DEVICE)}


def set_gates(M, cfg, params, value: float) -> int:
    """Every cross-attention gate of ``params`` set to ``value``, in place.
    Returns how many."""
    n = 0
    for (mixer, _), p in zip(cfg.layer_kinds, M.per_layer(cfg, params)):
        if mixer == "xattn":
            p["mixer"]["gate"].fill_(value)
            n += 1
    return n


class XattnRecorder(StandIn):
    """B8's Recorder at serve (p): the self-attention layers' calls as a
    FlashRecorder samples them (``own``), the cross-attention layers' apart:
    their non-causal prompt over the patch keys (``xpre``) and their decode
    token over every patch key (``xdec``, told from a self-attention decode
    by its arena of ``n_patches`` keys)."""

    def __init__(self, fn, n_self: int, n_cross: int, n_patches: int):
        self.fn, self.n_patches = fn, n_patches
        self.own = FlashRecorder(fn, n_self)
        self.xpre = Recorder(fn, n_cross, 1, lambda q, k, v, *r: (k, v),
                             lambda q, k, v, *r: (q.clone(),))
        self.xdec = Recorder(fn, n_cross, 10, lambda q, k, v, *r: (arena_of(k), arena_of(v)),
                             lambda q, k, v, *r: (q.clone(), k.shape[1]))

    def __call__(self, q, k, v, scale, causal=True):
        if q.shape[1] > 1 and not causal:
            return self.xpre(q, k, v, scale, causal)
        if q.shape[1] == 1 and arena_of(k).shape[1] == self.n_patches:
            return self.xdec(q, k, v, scale, causal)
        return self.own(q, k, v, scale, causal)


def n_params(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    return sum(n_params(t) for t in (tree.values() if isinstance(tree, dict) else tree))


def serve_multimodal(T, M, kops: dict, counted: list, t3_cfg, serves: dict, report: dict,
                     timing: dict, new_s: dict) -> None:
    """Phase 8: (p) llama-3.2-vision-11b and (q) musicgen-large at their
    published widths, nothing cut, random bf16 weights from a seed, on the
    static ServeEngine (8 rows of 512, 64 new). (p): every cross-attention
    gate set to XATTN_GATE, each row its own patches; mode dense: B8's
    prompt route 40 times a prefill (32 causal, 8 non-causal over 1600 patch
    keys) and its decode route 40 times a step (8 over the patch keys).
    (q): audio frames in, modes dense (B8), decomposed (B9, every launch on
    its sweep: d_model 2048), cpq (B10) and retrieval (B7's contiguous
    form, top_k 256). The new shapes timed (``timing[kernel][shape]``); then
    each model's f32 parity over its first PARITY_DEPTH layers (the bf16
    model freed first): kernels on against off as phase 5 holds them, (p)
    again with its patches moved (PATCH_MOVE) and how far its logits moved,
    and (q)'s T1 logits against its dense ones within DECOMPOSED_TOL. Each
    serve's launch counts are set to 0 just before it and read just
    after."""
    from repro_torch.params import init_params

    fa_ops, t1_ops = kops["flash_attention"], kops["decomposed_decode"]
    cpq_ops, t3_ops = kops["cpq_decode"], kops["paged_proxy_scores"]
    routes = fa_ops.ROUTE_LAUNCHES
    t_all = time.perf_counter()

    # (p) llama-3.2-vision-11b
    cfg = vision_config(T)
    what = "llama-3.2-vision-11b"
    L = cfg.num_layers
    n_cross = sum(m == "xattn" for m, _ in cfg.layer_kinds)
    n_self = L - n_cross
    scale = cfg.head_dim ** -0.5
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, DEVICE)
    gates = set_gates(M, cfg, params, XATTN_GATE)
    torch.cuda.synchronize()
    log(f"{what}: {n_params(params) / 1e9:.3f} B parameters, {device_bytes(params) / 1e9:.2f} "
        f"GB of bf16 weights on the card in {time.perf_counter() - t0:.1f} s; all {gates} "
        f"cross-attention gates set to {XATTN_GATE} (the reference draws them at 0, where "
        "the layers add nothing)")
    batch = multimodal_batch(cfg)
    eng = T.ServeEngine(cfg, params, device=DEVICE)
    rec = XattnRecorder(fa_ops.flash_attention, n_self, n_cross, cfg.num_patch_tokens)
    out, stats, timer, wall, counts = serve_static(eng, T, M, batch, 64,
                                                   {"flash_attention": (fa_ops, rec)}, counted,
                                                   routes)
    steps = stats["decode_steps"]
    check(out.shape == (8, 64) and steps == 63, f"static {what}: {out.shape}")
    check_counts(f"static {what}", counts, {"flash_attention": L * (1 + steps),
                                            "flash_attention/prompt": L,
                                            "flash_attention/decode": L * steps})
    calls = {"causal prompt": rec.own.pre.calls, "xattn prompt": rec.xpre.calls,
             "decode": rec.own.dec.calls, "xattn decode": rec.xdec.calls}
    want = {"causal prompt": n_self, "xattn prompt": n_cross, "decode": n_self * steps,
            "xattn decode": n_cross * steps}
    check(calls == want, f"static {what}: B8 calls {calls}, want {want}")
    kv = 2 * 2 * cfg.num_kv_heads * cfg.head_dim       # K and V, bf16, a token
    arena = {"self-attention": n_self * 8 * (512 + 64) * kv,
             "cross-attention": n_cross * 8 * cfg.num_patch_tokens * kv}
    m = serves[f"static {what}"] = static_metrics(out, stats, timer, wall, what)
    m.update(launches={k: n for k, n in counts.items() if n}, b8_calls=calls,
             arena_by_kind=arena)
    check(m["arena_bytes"] == sum(arena.values()),
          f"static {what}: arena {m['arena_bytes']} bytes, want {arena}")
    log(f"serve static {what}: B8 calls {calls}; arena {arena}")
    del eng, timer
    for name, r, case, n, unit in (
            ("flash_attention_prompt", rec.xpre, flash_prefill_case(fa_ops, scale, False), 1,
             "prefill"),
            ("flash_attention", rec.xdec, flash_decode_case(fa_ops, scale), steps, "step")):
        t = timing.setdefault(name, {})["llama-vision xattn"] = time_kernel(r, case)
        log_timing(f"{name} at {what}'s cross-attention", t, n_cross * n, n_cross, unit)
    del rec
    new_s[what] = time.perf_counter() - t0

    t0 = time.perf_counter()
    depth = PARITY_DEPTH  # the first layers as a prefix: 3 self-attention and the xattn
    cfg_p = dataclasses.replace(cfg, dtype="float32", prefix_pattern=cfg.block_pattern[:depth],
                                num_blocks=0)
    check([m for m, _ in cfg_p.layer_kinds].count("xattn") == 1, f"{what}: parity depth")
    head = {**params, "prefix": [params["blocks"][j][0] for j in range(depth)],
            "blocks": [[] for _ in cfg.block_pattern]}
    del params
    params = _tree_float(head)
    del head
    torch.cuda.empty_cache()
    par = report["parity"]
    par[what] = static_parity(T, M, cfg_p, params, batch, "dense", 64, what=f"static {what}")
    moved = {**batch, "patches": PATCH_MOVE[0] * batch["patches"] + PATCH_MOVE[1]}
    par[f"{what} patches moved"] = static_parity(T, M, cfg_p, params, moved, "dense", 64,
                                                 what=f"static {what} patches moved")
    rt = T.AttentionRuntime()
    a, b = (static_first_logits(M, cfg_p, rt, params, x) for x in (batch, moved))
    shift = {"prefill": (a[0] - b[0]).abs().max().item(),
             "first_decode": (a[1] - b[1]).abs().max().item()}
    par[what]["logits_moved_by_patches"] = shift
    log(f"parity {what}: patches x {PATCH_MOVE[0]} + {PATCH_MOVE[1]} move the logits by "
        f"{shift['prefill']:.3e} (prefill) and {shift['first_decode']:.3e} (first decode): "
        "the cross-attention is live")
    check(min(shift.values()) > 10 * LOGIT_TOL, f"{what}: the patches do not move the logits")
    del params, batch, moved
    torch.cuda.empty_cache()
    new_s[f"parity {what}"] = time.perf_counter() - t0
    log(f"[{time.perf_counter() - T0:.0f} s] {what} served and checked")

    # (q) musicgen-large
    cfg = musicgen_config(T)
    what = "musicgen-large"
    L = cfg.num_layers
    scale = cfg.head_dim ** -0.5
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, DEVICE)
    torch.cuda.synchronize()
    log(f"{what}: {n_params(params) / 1e9:.3f} B parameters, {device_bytes(params) / 1e9:.2f} "
        f"GB of bf16 weights on the card")
    batch = multimodal_batch(cfg)
    rts = {mode: T.AttentionRuntime(mode=mode) for mode in MUSICGEN_MODES}
    rts["retrieval"] = T.AttentionRuntime(mode="retrieval", retrieval=t3_cfg)
    kv = 2 * cfg.num_kv_heads * cfg.head_dim           # K or V, bf16, a token
    arena_want = {"dense": L * 8 * (512 + 64) * 2 * kv,
                  "decomposed": L * 8 * (512 + 64) * 2 * cfg.d_model}
    t1_routed = {"decomposed_decode": (t1_ops.CONTIG_ROUTE_LAUNCHES, "sweep")}
    new_s[f"{what} init"] = time.perf_counter() - t0
    for mode in MUSICGEN_MODES:
        t0 = time.perf_counter()
        eng = T.ServeEngine(cfg, params, rt=rts[mode], device=DEVICE)
        recs = {"dense": lambda: {"flash_attention": (fa_ops, FlashRecorder(
                    fa_ops.flash_attention, L))},
                "decomposed": lambda: {"decomposed_decode": (t1_ops, t1c_recorder(t1_ops, L))},
                "cpq": lambda: {"cpq_decode": (cpq_ops, cpqc_recorder(cpq_ops, L))},
                "retrieval": lambda: {"proxy_scores_q": (t3_ops, t3c_recorder(t3_ops, L))}}[mode]()
        zero_routes(t1_routed)
        out, stats, timer, wall, counts = serve_static(eng, T, M, batch, 64, recs, counted,
                                                       routes)
        steps = stats["decode_steps"]
        tag = f"static {what} {mode}"
        check(out.shape == (8, 64) and steps == 63, f"{tag}: {out.shape}")
        want = {"flash_attention": L * (1 + steps * (mode == "dense")),
                "flash_attention/prompt": L}
        want[COUNT_KEY.get(STEP_KERNEL[mode], STEP_KERNEL[mode])] = L * steps
        check_counts(tag, counts, want)
        m = serves[tag] = static_metrics(out, stats, timer, wall, f"{what} {mode}")
        m["launches"] = {k: n for k, n in counts.items() if n}
        if mode == "decomposed":  # d_model 2048: every B9 launch on its sweep
            m["routes"] = check_routes(tag, t1_routed, counts)
            log(f"serve {tag}: B9 routes {m['routes']['decomposed_decode']}")
        if mode in arena_want:
            check(m["arena_bytes"] == arena_want[mode],
                  f"{tag}: arena {m['arena_bytes']} bytes, want {arena_want[mode]}")
        del eng, timer
        if mode == "dense":
            frec = recs["flash_attention"][1]
            cases = (("flash_attention_prompt", frec.pre, flash_prefill_case(fa_ops, scale), 1),
                     ("flash_attention", frec.dec, flash_decode_case(fa_ops, scale), steps))
        else:
            name = STEP_KERNEL[mode]
            case = {"decomposed": t1c_decode_case(t1_ops, scale),
                    "cpq": cpqc_decode_case(cpq_ops, scale),
                    "retrieval": t3c_decode_case(t3_ops)}[mode]
            cases = (("paged_proxy_scores" if mode == "retrieval" else name,
                      next(iter(recs.values()))[1], case, steps),)
        for name, r, case, n in cases:
            t = timing.setdefault(name, {})["musicgen"] = time_kernel(r, case)
            log_timing(f"{name} at {tag}", t, L * n, L, "prefill" if n == 1 else "step")
        del recs, cases
        torch.cuda.empty_cache()
        new_s[tag] = time.perf_counter() - t0
    log(f"serve static {what}: arena bytes " + ", ".join(
        f"{mode} {serves[f'static {what} {mode}']['arena_bytes']}" for mode in MUSICGEN_MODES))

    t0 = time.perf_counter()
    depth = min(PARITY_DEPTH, cfg.num_blocks)
    cfg_p = dataclasses.replace(cfg, dtype="float32", num_blocks=depth)
    params = head_layers(params, cfg, depth)
    torch.cuda.empty_cache()
    for mode in MUSICGEN_MODES:
        report["parity"][f"static {what} {mode}"] = static_parity(
            T, M, cfg_p, params, batch, mode, 64,
            dict(retrieval=t3_cfg) if mode == "retrieval" else None, f"static {what} {mode}")
    dense, t1 = (static_first_logits(M, cfg_p, T.AttentionRuntime(mode=mode), params, batch)
                 for mode in ("dense", "decomposed"))
    gap = {"prefill": (dense[0] - t1[0]).abs().max().item(),
           "first_decode": (dense[1] - t1[1]).abs().max().item()}
    report["parity"][f"static {what} decomposed"]["against_dense"] = gap
    log(f"parity {what}: decomposed against dense logits {gap} (atol {DECOMPOSED_TOL}: T1 is "
        "exact at absolute positions)")
    check(max(gap.values()) <= DECOMPOSED_TOL, f"{what}: decomposed against dense {gap}")
    del params, batch
    torch.cuda.empty_cache()
    new_s[f"parity {what}"] = time.perf_counter() - t0
    report["multimodal_phase_s"] = new_s
    report["multimodal_timing"] = timing
    log(f"[{time.perf_counter() - T0:.0f} s] phase 8 in {time.perf_counter() - t_all:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in new_s.items()))


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


# ------------------------------- phase 4: the rest of the continuous tick

TURNS = 3                   # make_templated_workload's turns per session (h)
COUNTERS = ("prefix_hits", "shared_prefix_tokens", "shared_prefix_pages", "cow_copies",
            "defrags", "spec_steps", "spec_drafted", "spec_accepted", "preemptions",
            "timeouts")
SAMPLE_GAP = 1e-6           # relative top-2 gap of perturbed logits below which a draw is a tie


def templated_requests(T, work):
    """(h)'s requests: the turns of sessions 0, 2, 4 and 6 sampled
    (temperature 0.8, top-k 50, top-p 0.9, seed 100 + rid), the others
    greedy. make_templated_workload numbers a session's turns in a row, so
    a request's session is rid // TURNS."""
    out = []
    for w in work:
        sess = w.rid // TURNS
        sp = (T.SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=100 + w.rid,
                               max_tokens=w.target) if sess % 2 == 0
              else T.SamplingParams(max_tokens=w.target))
        out.append(T.ServeRequest(prompt=w.prompt, rid=w.rid, sampling=sp, arrival=w.arrival,
                                  session_id=f"s{sess}"))
    return out


def loopy_requests(T, work):
    """(i)'s greedy requests."""
    return [T.Request(rid=w.rid, prompt=w.prompt, max_new_tokens=w.target, arrival=w.arrival)
            for w in work]


def cow_probe(T, eng, sys_prompt, vocab: int):
    """Two greedy requests behind (h)'s system prompt of 256 tokens: A, and
    B, which diverges from it 250 tokens in (10 tokens into its 16th page)
    and is added once A's 20 prompt chunks have landed. B mounts 15 pages
    and shares the 16th mid-page, and its first tail write splits that page
    (copy-on-write). (h)'s own prompts diverge at page boundaries only.
    Returns (results, stats)."""
    rng = np.random.default_rng(SEED + 1)
    a = np.concatenate([sys_prompt, rng.integers(1, vocab, 64)]).astype(np.int32)
    b = np.concatenate([sys_prompt[:250], rng.integers(1, vocab, 40)]).astype(np.int32)
    eng.reset(T.GenerationConfig())
    eng.add_request(T.Request(rid=0, prompt=a, max_new_tokens=16))
    for _ in range(22):
        eng.step()
    eng.add_request(T.Request(rid=1, prompt=b, max_new_tokens=16))
    while eng.has_unfinished():
        eng.step()
    return eng.results(), eng.stats()


def check_targets(results, targets: dict, what: str) -> None:
    for rid, n in targets.items():
        got = results[rid]
        check(got["finish_reason"] == "max_tokens" and len(got["tokens"]) == n,
              f"{what}: request {rid}: {got['finish_reason']}, {len(got['tokens'])} of {n}")


def check_tick_launches(what: str, counts: dict, stats: dict, L: int) -> None:
    """B1 and B2 alone launched, L times a decode step and a chunk or
    verify chunk; a verify chunk counts as a decode step in ``stats``."""
    spec = stats["spec_steps"]
    want = {name: 0 for name in counts}
    want.update(paged_decode=L * (stats["decode_steps"] - spec),
                paged_prefill=L * (stats["prefill_chunks"] + spec))
    check(counts == want and want["paged_decode"] > 0 and want["paged_prefill"] > 0,
          f"{what}: launch counts {counts}, want {want}")
    check(stats["dense_pages_leaked"] == 0, f"{what}: {stats['dense_pages_leaked']} pages leaked")


def log_counters(what: str, stats: dict) -> dict:
    out = {k: stats[k] for k in COUNTERS}
    log(f"serve {what}: " + ", ".join(f"{k} {v}" for k, v in out.items()))
    return out


def watch_gaps(eng, gaps: dict) -> None:
    """File the top-2 logit gap of every greedy draw of ``eng`` under (rid,
    stream index): first tokens, the decode step's rows and every position
    of a verify chunk. A row's later draw of the same index overwrites an
    earlier filing (a row that was not active in that decode step)."""
    one, active, verify = eng._sample_one, eng._sample_active, eng._verify_draws

    def greedy(req):
        return req.sampling is None or req.sampling.temperature <= 0

    def sample_one(req, logits):
        if greedy(req):
            gaps[(req.rid, req.num_generated)] = top2_gap(logits[0]).item()
        return one(req, logits)

    def sample_active(st, logits):
        g = top2_gap(logits).tolist()
        for slot, req in enumerate(st.sched.slots):
            if req is not None and greedy(req):
                gaps[(req.rid, req.num_generated)] = g[slot]
        return active(st, logits)

    def verify_draws(req, logits):
        if greedy(req):
            for j, x in enumerate(top2_gap(logits).tolist()):
                gaps[(req.rid, req.num_generated + j)] = x
        return verify(req, logits)

    eng._sample_one, eng._sample_active, eng._verify_draws = sample_one, sample_active, verify_draws


def tick_parity(T, cfg, params, what: str, serving, off: dict, drive) -> dict:
    """Float32, TF32 off: ``drive(eng) -> (results, stats)`` on the kernel
    path and on the plain path with ``serving``, and on the kernel path with
    the feature off (``serving`` updated by ``off``). The paths' streams
    (greedy and sampled) identical but for a greedy first divergence below
    ARGMAX_GAP of the plain path's top-2 gap, and then their counters too;
    the feature on and off give identical streams the same way."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for key, fused, sv in (("kernels", True, serving), ("plain", False, serving),
                           ("off", True, dataclasses.replace(serving, **off))):
        eng = T.ContinuousServeEngine(cfg, params, rt=T.AttentionRuntime(paged_kernels=fused),
                                      serving=sv, device=DEVICE)
        gaps = {}
        watch_gaps(eng, gaps)
        results, stats = drive(eng)
        runs[key] = ({rid: r["tokens"] for rid, r in results.items()}, stats, gaps)
        del eng
        torch.cuda.empty_cache()
    lengths = {rid: len(t) for rid, t in runs["plain"][0].items()}
    out = {"counters": {k: runs["kernels"][1][k] for k in COUNTERS}}
    same = compare_streams(what, {True: runs["kernels"][0], False: runs["plain"][0]},
                           runs["plain"][2], lengths)
    out["streams_identical"] = same
    keys = COUNTERS + ("decode_steps", "prefill_chunks", "generated_tokens")
    if same == len(lengths):
        differ = {k: (runs["kernels"][1][k], runs["plain"][1][k]) for k in keys
                  if runs["kernels"][1][k] != runs["plain"][1][k]}
        check(not differ, f"parity {what}: counters differ, kernels vs plain: {differ}")
        log(f"parity {what}: counters identical, kernels vs plain: {out['counters']}")
    out["on_off_identical"] = compare_streams(
        f"{what} on vs off", {True: runs["kernels"][0], False: runs["off"][0]},
        runs["off"][2], lengths)
    return out


def sampler_parity(teng, prng) -> dict:
    """The sampler on the card against itself on the CPU, on the same
    float32 logits (32 rows of 151936), temperatures, top-k, top-p, seeds
    and stream indices: the Threefry bits and uniforms bit for bit, and the
    same draws but where the CPU's top-2 perturbed logits lie within
    SAMPLE_GAP (relative) and the two draws are those two (excused,
    counted). Gumbel noise: its largest difference in ulps at the scale of
    max(|g|, 1) (no gate). Also the card's time of one 8-row call."""
    rng = np.random.default_rng(SEED)
    B, V = 32, 151936
    host = [torch.tensor(a) for a in (
        (rng.normal(size=(B, V)) * 3).astype(np.float32),
        rng.choice([0.0, 0.5, 0.8, 1.0, 1.3], size=B).astype(np.float32),
        rng.choice([0, 50, 1000], size=B).astype(np.int32),
        rng.choice([1.0, 0.9, 0.6], size=B).astype(np.float32),
        rng.integers(0, 2**31 - 1, size=B).astype(np.int32),
        rng.integers(0, 4096, size=B).astype(np.int32))]
    card = [t.to(DEVICE) for t in host]
    keys = [prng.fold_in(prng.PRNGKey(a[4]), a[5]) for a in (host, card)]
    check(torch.equal(prng.random_bits(keys[1], (V,)).cpu(), prng.random_bits(keys[0], (V,))),
          "sampler: the card's Threefry bits differ from the CPU's")
    check(torch.equal(prng.uniform(keys[1], (V,)).cpu(), prng.uniform(keys[0], (V,))),
          "sampler: the card's uniforms differ from the CPU's")
    g = [prng.gumbel(k, (V,)).double().cpu() for k in keys]
    ulps = ((g[1] - g[0]).abs() / torch.from_numpy(np.spacing(
        np.maximum(g[0].abs().numpy(), 1.0).astype(np.float32))).double()).max().item()
    got = [teng.sample_token_rows(*a).cpu() for a in (host, card)]
    pert = teng.perturbed_logits(*host)
    diff = torch.nonzero(got[1] != got[0])[:, 0].tolist()
    for b in diff:
        top2 = pert[b].topk(2)
        a0, a1 = top2.values.tolist()
        tie = abs(a0 - a1) <= SAMPLE_GAP * max(abs(a0), abs(a1), 1.0)
        check(host[1][b] > 0 and tie and {int(got[0][b]), int(got[1][b])}
              == set(top2.indices.tolist()),
              f"sampler: row {b} draws {int(got[1][b])} on the card, {int(got[0][b])} on "
              f"the CPU, top-2 perturbed {a0!r} {a1!r}")
    ms = cuda_ms(lambda: teng.sample_token_rows(*[t[:8] for t in card]), 20)
    out = {"draws": B, "excused": len(diff), "gumbel_max_ulps": ulps,
           "sample_token_rows_8_rows_ms": ms}
    log(f"sampler, card vs CPU: bits and uniforms identical; {B} draws, {len(diff)} excused "
        f"(top-2 perturbed within {SAMPLE_GAP} relative); gumbel within {ulps:.1f} ulp of "
        f"max(|g|, 1) (no gate); sample_token_rows over 8 rows of {V}: {ms:.3f} ms on the card")
    return out


def serve_rest(T, cfg, params, serving, counted: list, routed: dict, fa_routes: dict,
               serves: dict, new_s: dict) -> dict:
    """Phase 4's serves of the rest of the continuous engine's tick, on
    serve (a)'s arena (``serving``), each with every launch and route count
    set to 0 just before and read just after; B1 and B2 alone launch, once
    a layer a decode step and a prompt or verify chunk, every chunk on B2's
    tensor cores, every decode on B1's ring. Fills ``serves`` and the
    seconds ``new_s``; returns the traffic phase 5 replays."""
    # 4h) prefix sharing with copy-on-write and defrag: multi-turn sessions
    #     behind one system prompt, sessions 0, 2, 4, 6 sampled, the others
    #     greedy; then the copy-on-write probe behind the same prompt
    # 4i) speculative decoding on self-similar prompts, greedy
    # 4j) mixed interactive and batch traffic through run_trace, under the
    #     slo policy and under fifo
    from repro_torch.serving import trace

    L = cfg.num_layers
    t0 = time.perf_counter()
    work_h = trace.make_templated_workload(seed=0, n_sessions=8, vocab=cfg.vocab_size,
                                           rate=0.5, sys_tokens=256, turns=TURNS,
                                           turn_step=64)
    work_i = trace.make_loopy_workload(seed=0, n_requests=8, vocab=cfg.vocab_size, motif=32,
                                       reps=4, target=64)
    shared = dataclasses.replace(serving, share_prefix=True, defrag_every=4)
    spec = dataclasses.replace(serving, spec_len=4, spec_ngram=3)
    sys_prompt = work_h[0].prompt[:256]
    for what, sv, run, targets in (
            ("shared", shared, templated_requests(T, work_h), {w.rid: w.target for w in work_h}),
            ("shared cow", dataclasses.replace(shared, defrag_every=0), None, {0: 16, 1: 16}),
            ("speculative", spec, loopy_requests(T, work_i), {w.rid: w.target for w in work_i})):
        eng = T.ContinuousServeEngine(cfg, params, serving=sv, device=DEVICE)
        zero_launches(counted, fa_routes)
        zero_routes(routed)
        t1 = time.perf_counter()
        if run is None:
            results, stats = cow_probe(T, eng, sys_prompt, cfg.vocab_size)
            torch.cuda.synchronize()
            wall, ticks = time.perf_counter() - t1, None
        else:
            results, stats, ticks, wall = serve_timed(eng, T, run)
        counts = counted_launches(counted, fa_routes)
        routes = check_routes(what, routed, counts)
        check_targets(results, targets, what)
        check_tick_launches(what, counts, stats, L)
        serves[what] = (serve_metrics(stats, ticks, wall, what) if ticks else
                        {"serve_wall_s": wall, "generated_tokens": stats["generated_tokens"],
                         "end_to_end_tokens_per_s": stats["generated_tokens"] / wall,
                         "arena_bytes": stats["arena_bytes_total"]})
        serves[what].update(launches={k: n for k, n in counts.items() if n}, routes=routes,
                            counters=log_counters(what, stats))
        new_s[what] = time.perf_counter() - t1
        del eng
        torch.cuda.empty_cache()
        log(f"[{time.perf_counter() - T0:.0f} s] served {what} in {new_s[what]:.1f} s")
    h, c, i = serves["shared"]["counters"], serves["shared cow"]["counters"], \
        serves["speculative"]["counters"]
    check(h["prefix_hits"] > 0 and h["defrags"] > 0, f"shared: counters {h}")
    check(c["cow_copies"] >= 1 and c["shared_prefix_tokens"] == 250,
          f"shared cow: counters {c}")
    check(i["spec_steps"] > 0 and i["spec_accepted"] > 0, f"speculative: counters {i}")
    work_j, slos_j = trace.make_slo_workload(seed=0, n_requests=24, vocab=cfg.vocab_size,
                                             rate=0.5)
    kept = []

    class Kept(T.ContinuousServeEngine):  # run_trace's engine, for its leak count
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    made = trace.ContinuousServeEngine
    for pol in ("slo", "fifo"):
        what = f"slo workload, policy {pol}"
        zero_launches(counted, fa_routes)
        zero_routes(routed)
        t1 = time.perf_counter()
        trace.ContinuousServeEngine = Kept
        try:
            m = trace.run_trace(cfg, params, work_j, serving, policy=pol, slos=slos_j)
        finally:
            trace.ContinuousServeEngine = made
        counts = counted_launches(counted, fa_routes)
        routes = check_routes(what, routed, counts)
        stats = kept.pop().stats()
        check(stats["policy"] == pol, f"{what}: policy {stats['policy']}")
        check_targets(m["results"], {w.rid: w.target for w in work_j}, what)
        check_tick_launches(what, counts, stats, L)
        tails = trace.class_tails(m, work_j, slos_j)
        serves[what] = {k: m[k] for k in ("wall_time_s", "tokens_per_s", "decode_steps",
                                          "tokens_per_step", "latency_mean", "latency_p90",
                                          "ttft_p50", "ttft_p95", "itl_p50", "itl_p95")}
        serves[what].update(class_tails=tails, launches={k: n for k, n in counts.items() if n},
                            routes=routes, counters=log_counters(what, stats))
        new_s[what] = time.perf_counter() - t1
        log(f"serve {what}: wall {m['wall_time_s']:.2f} s, {m['tokens_per_s']:.1f} tokens/s "
            f"end to end, {m['decode_steps']} decode steps; ticks: ttft p50 "
            f"{m['ttft_p50']:.2f} p95 {m['ttft_p95']:.2f}, itl p50 {m['itl_p50']:.2f} p95 "
            f"{m['itl_p95']:.2f}; class tails {tails}")
        torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - T0:.0f} s] served (h)-(j) in {time.perf_counter() - t0:.1f} s")
    return {"work_h": work_h, "work_i": work_i, "sys_prompt": sys_prompt}


def parity_rest(T, cfg, params, rest: dict, vocab: int, report: dict, new_s: dict) -> None:
    """Phase 5's checks of the rest of the tick: (h), its copy-on-write
    probe and (i) in float32 through ``tick_parity`` (``cfg``, ``params``:
    the parity depth), then the sampler on the card against the CPU."""
    from repro_torch.serving import engine as teng, prng

    work_h, work_i, sys_prompt = rest["work_h"], rest["work_i"], rest["sys_prompt"]
    serving_p = T.ServingCfg(num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64)
    for what, sv, off, drive in (
            ("shared", dataclasses.replace(serving_p, share_prefix=True, defrag_every=4),
             dict(share_prefix=False, defrag_every=0),
             lambda eng: serve_timed(eng, T, templated_requests(T, work_h))[:2]),
            ("shared cow", dataclasses.replace(serving_p, share_prefix=True),
             dict(share_prefix=False),
             lambda eng: cow_probe(T, eng, sys_prompt, vocab)),
            ("speculative", dataclasses.replace(serving_p, spec_len=4, spec_ngram=3),
             dict(spec_len=0), lambda eng: serve_timed(eng, T, loopy_requests(T, work_i))[:2])):
        t1 = time.perf_counter()
        report["parity"][what] = tick_parity(T, cfg, params, what, sv, off, drive)
        new_s[f"parity {what}"] = time.perf_counter() - t1
        log(f"[{time.perf_counter() - T0:.0f} s] parity {what} in "
            f"{new_s[f'parity {what}']:.1f} s")
    t1 = time.perf_counter()
    report["sampler"] = sampler_parity(teng, prng)
    new_s["sampler"] = time.perf_counter() - t1
    report["new_phase_s"] = new_s
    log(f"[{time.perf_counter() - T0:.0f} s] the rest of the tick checked; seconds of the "
        f"added phases: " + ", ".join(f"{k} {v:.1f}" for k, v in new_s.items()))


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
    new_s = {}  # seconds of the phases added with the rest of the tick (h-j)
    errs = {name: {} for name in kmods}
    report["prefill_routes"] = {}
    # B8's bf16 cases: the kernel's, the plain version's largest distance
    # from exact attention, and the kernel's from the plain version
    report["flash_bf16_exact"] = flash_exact = {}
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
        t0 = time.perf_counter()
        for G in (1, 2):  # B2 at the speculative verify chunk's shapes
            tag = f"{dname} verify KV={16 // G} G={G} Dh=64"
            errs["paged_prefill"][tag] = sweep_verify(ops, dtype, G)
            log(f"sweep {tag}: paged_prefill {errs['paged_prefill'][tag]:.3e} over "
                f"{5 * len(VERIFY_CHUNKS)} verify chunks (C, valid) in {VERIFY_CHUNKS} at "
                f"offsets 0, 1, 15, 17 and 1024 - C ({ops.prefill_route(dtype, 64, 64)} "
                f"route; tol {TOL[dtype]})")
        new_s["verify sweep"] = new_s.get("verify sweep", 0.0) + time.perf_counter() - t0
        for shape, err in sweep_decode_served(ops, dtype).items():
            errs["paged_decode"][f"{dname} served rows {shape}"] = err
            log(f"sweep {dname} served rows {shape}: paged_decode {err:.3e} over "
                f"{len(SERVED_DECODE)} layouts, planned and most ranks "
                f"({ops.decode_route(dtype, 64, 64, 64)} route; tol {TOL[dtype]})")
        # B3 at the served rows: qwen1.5-0.5b's T1 shape and deepseek-v2-lite's
        # MLA (the latent of 512, one roped key of 64 shared by 16 heads)
        for H, Dm, kv_r, Rr in ((16, 1024, 16, 32), (16, 512, 1, 64)):
            tag = f"{dname} served rows H={H} Dm={Dm} kv_r={kv_r} Rr={Rr}"
            errs["paged_decomposed_decode"][tag] = sweep_t1_served(t1_ops, dtype, H, Dm, kv_r,
                                                                   Rr)
            log(f"sweep {tag}: paged_decomposed_decode "
                f"{errs['paged_decomposed_decode'][tag]:.3e} over {len(T1_SERVED_DECODE)} "
                f"layouts, planned and most splits "
                f"({t1_ops.t1_decode_route(dtype, H, Dm, kv_r, Rr)} route; tol {TOL[dtype]})")
        for case, err in sweep_flash(fa_ops, dtype, MLA_FLASH_SWEEP, flash_exact).items():
            errs["flash_attention"][f"{dname} {case}"] = err
        log(f"sweep {dname} MLA prompts: flash_attention "
            + ", ".join(f"{e:.3e}" for k, e in errs["flash_attention"].items()
                        if "Dh=192" in k and k.startswith(dname))
            + f" over {len(MLA_FLASH_SWEEP)} cases (Dh 192, Dv 128; tol {TOL[dtype]})")
        for case, err in sweep_flash(fa_ops, dtype, exact=flash_exact).items():
            errs["flash_attention"][f"{dname} {case}"] = err
        for case, err in sweep_t1c(t1_ops, dtype).items():
            errs["decomposed_decode"][f"{dname} {case}"] = err
        for case, err in sweep_cpqc(cpq_ops, dtype).items():  # float32 output
            errs["cpq_decode"][f"float32 q={dname} {case}"] = err
        log(f"sweep {dname}: flash_attention {max(errs['flash_attention'].values()):.3e} over "
            f"{len(FLASH_SWEEP)} cases, decomposed_decode "
            f"{max(errs['decomposed_decode'].values()):.3e} over {len(T1C_SWEEP)}, cpq_decode "
            f"{max(errs['cpq_decode'].values()):.3e} over {2 * len(CPQC_SWEEP)} (tol "
            f"{TOL[dtype]}, cpq_decode {TOL[torch.float32]})")
        if dtype == torch.bfloat16:
            top = {k: max(e[k] for e in flash_exact.values())
                   for k in ("kernel", "plain", "kernel_vs_plain")}
            log(f"sweep bfloat16: flash_attention against exact attention (float64) over "
                f"{len(flash_exact)} cases: kernel {top['kernel']:.4e}, plain version "
                f"{top['plain']:.4e}, kernel against plain {top['kernel_vs_plain']:.4e} (the "
                f"kernel within tol {TOL[dtype]} of exact, and no farther than the plain "
                "version, in every case)")
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
    for mode in ("dense", "decomposed", "cpq", "retrieval"):
        eng = T.ServeEngine(cfg, params, rt=rts[mode], device=DEVICE)
        recs = {"flash_attention": (fa_ops, FlashRecorder(fa_ops.flash_attention, L))}
        if mode == "decomposed":
            recs["decomposed_decode"] = (t1_ops, t1c_recorder(t1_ops, L))
        if mode == "cpq":
            recs["cpq_decode"] = (cpq_ops, cpqc_recorder(cpq_ops, L))
        zero_routes(static_routed)
        out, stats, timer, wall, counts = serve_static(eng, T, M, prompts, n_new, recs, counted,
                                                       fa_ops.ROUTE_LAUNCHES)
        static_routes = check_routes(f"static {mode}", static_routed, counts)
        steps = stats["decode_steps"]
        check(out.shape == (8, n_new) and steps == n_new - 1
              and stats["generated_tokens"] == out.size, f"static {mode}: {out.shape}, {stats}")
        want = {name: 0 for name in counts}
        want["flash_attention"] = L * (1 + steps if mode == "dense" else 1)
        want["flash_attention/prompt"] = L         # the bf16 prefill: tensor cores
        if mode == "dense":
            want["flash_attention/decode"] = L * steps
        else:
            want[STEP_KERNEL[mode]] = L * steps
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
            name = STEP_KERNEL[mode]
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

    # 4h-4j) the rest of the continuous engine's tick
    rest = serve_rest(T, dataclasses.replace(cfg, num_blocks=REST_DEPTH),
                      {**params, "blocks": [b[:REST_DEPTH] for b in params["blocks"]]},
                      serving, counted, routed, fa_ops.ROUTE_LAUNCHES, serves,
                      new_s)

    # C3: the T2 (HQE) and T3 (proxy) encoders on the card and on the CPU, on
    #     layer 0's K/V of the static prompts (448 at once, 64 appended)
    report["encode_parity"] = encode_parity(*history, rts["cpq"].cpq, t3_cfg, 448)
    for what, r in report["encode_parity"].items():
        log(f"encode parity {what} (card vs CPU, no gate): {r}")
    del history

    # 5) f32 parity, kernels on and off, dense, CPQ, T1 and T3
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = to_device(_tree_float(params), DEVICE)
    # every serve's parity runs the first PARITY_DEPTH layers, to keep the
    # script (with phases 6 and 7) inside its time limit
    depth = min(PARITY_DEPTH, cfg32.num_blocks)
    cfg_p = dataclasses.replace(cfg32, num_blocks=depth)
    params_p = {**params32, "blocks": [b[:depth] for b in params32["blocks"]]}
    del params, params32
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
    # the rest of the tick: (h), its copy-on-write probe and (i), kernels on
    # and off, the feature on and off; then the sampler, card against CPU
    parity_rest(T, cfg_p, params_p, rest, cfg.vocab_size, report, new_s)
    report["parity"]["oneshot"] = parity(T, M, cfg_p, params_p, reqs, "dense",
                                         serving_kw=dict(prefill_chunk=0))
    for mode in ("dense", "decomposed", "cpq", "retrieval"):
        report["parity"][f"static {mode}"] = static_parity(
            T, M, cfg_p, params_p, prompts, mode, n_new,
            dict(retrieval=t3_cfg) if mode == "retrieval" else None)
    log(f"[{time.perf_counter() - T0:.0f} s] parity checked (contiguous)")
    del params_p
    torch.cuda.empty_cache()

    # 6) the DeepSeek stacks (MLA and MoE) and T1+T2
    serve_deepseek(T, M, counted, routed, static_routed, fa_ops.ROUTE_LAUNCHES, serves,
                   report, {})

    # 7) the recurrent stacks: xlstm-125m and jamba's hybrid block
    at_jamba = {}
    serve_recurrent(T, M, ops, fa_ops, counted, routed, fa_ops.ROUTE_LAUNCHES, serves, report,
                    at_jamba, {})

    # 8) the multimodal stacks: llama-vision's cross-attention, musicgen's frames
    at_multimodal = {}
    serve_multimodal(T, M, kmods, counted, t3_cfg, serves, report, at_multimodal, {})

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
        if name == "paged_proxy_scores":  # B7's contiguous wrapper, the static T3 decodes
            for mode in ("static retrieval", "static musicgen-large retrieval"):
                by_serve[mode] = serves[mode]["launches"]["proxy_scores"]
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
        if name in at_jamba:  # B1 and B8 at jamba's attention: 64 heads over 8, Dh 128
            kernels[-1]["at_jamba"] = {
                "max_abs_err": errs[name][JAMBA_SWEPT[name]], "swept": JAMBA_SWEPT[name],
                **{k: at_jamba[name][k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms", "samples")}}
        if name in at_multimodal:  # the shapes of phase 8's serves (p) and (q)
            swept = {shape: MULTIMODAL_SWEPT[name, shape] for shape in at_multimodal[name]}
            kernels[-1]["at_multimodal"] = {
                shape: {"max_abs_err": errs[name][swept[shape]], "swept": swept[shape],
                        **{k: t[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "samples")}}
                for shape, t in at_multimodal[name].items()}
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
    report["log"] = LOG
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
