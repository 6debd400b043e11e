"""Device time per launch of seven of the port's kernels at fixed shapes, on
one NVIDIA GPU, for comparing two checkouts (or two settings of a kernel
module's constants) in one machine:

  b1      paged_decode (B1) on a served dense decode: 8 rows of 64-576 keys
          over 64 pages of 16, KV = H = 16, Dh = 64, bf16, and on rows of
          16-200 keys (801 in all, about the live keys of chip_smoke.py's
          sampled dense decode calls)
  b7      paged_proxy_scores (B7) on a served T3 decode: the two row sets of
          b1, KV = H = 16, Dp = 64, int8 codes over 64 pages of 16, n = 1024
          positions, a bf16 query; form "wrapper" times the wrapper on a pre-scaled query
          (the factors and the kernel), form "served" the served call with
          the query's scale (an eager multiply and the wrapper where the
          wrapper takes no scale)
  b4      paged_decomposed_prefill (B4) on qwen1.5-0.5b's T1 chunks: C = 16
          over pages of 16, H = 16, Dm = 1024, 16 roped groups of 32, bf16,
          chunks ending at 16, 128, 256 and 512 keys
  b5      paged_cpq_decode (B5) on a served CPQ decode: 8 rows of 64-576
          keys over 64 pages of 16, KV = 16, Dh = 64, 4-bit codes, bf16
  b8_f32  flash_attention's decode route (B8) in float32 at 8 query heads a
          kv head (KV = 2, G = 8), Dh 32 and 64: the two instantiations of
          single_query.cuh whose registers moved when B5 came to share it
  b3      paged_decomposed_decode (B3) on a served T1 decode: the rows of b5
          over 64 pages of 16, H = 16, Dm = 1024, 16 roped groups of 32, bf16
  b9      decomposed_decode (B9) on the static T1 decode: 8 rows, N = 576,
          lengths 128, 320 and 575, the widths of b3

Each case is timed as the model runs it: one launch per layer over 24
layer arenas (the next layer's pages cold in L2), captured in a CUDA graph
and replayed; the time is the graph's device time over 24.

    PYTHONPATH=src python benchmarks/torch_kernel_times.py [--cases b1,b3,b4,b5,b7,b8_f32,b9]
        [--set decomposed_attn.MAX_CHUNK_SPLITS=8 ...]

``--set`` overrides an integer constant of a kernel family's ``ops`` module
(split sizes: ``decomposed_attn.CHUNK_SPLIT_KEYS``, ``MAX_CHUNK_SPLITS``,
``TOKEN_SPLIT_KEYS``, ``TOKEN_KEYS``, ``cpq_attn.DECODE_SPLIT_KEYS``) for this
run. With PYTHONPATH at another
checkout's ``src`` it times that checkout's kernels. Prints one JSON object
per line: the case, its shape, the settings and ``us`` per launch.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import subprocess

import torch

LAYERS = 24


def graph_us(fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` in microseconds: replays of a CUDA graph
    that captured it, so host launch cost stays out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def b4():
    from repro_torch.kernels.decomposed_attn import ops as t1_ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, Dm, kv_r, Rr, page, C, nb = 16, 1024, 16, 32, 16, 16, 32
    x = [torch.randn((nb + 1, page, Dm), generator=gen, device="cuda").bfloat16()
         for _ in range(LAYERS)]
    kr = [torch.randn((nb + 1, page, kv_r, Rr), generator=gen, device="cuda").bfloat16()
          for _ in range(LAYERS)]
    row = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")
    r = torch.randn((C, H, Dm), generator=gen, device="cuda").bfloat16()
    qr = torch.randn((C, H, Rr), generator=gen, device="cuda").bfloat16()
    for end in (16, 128, 256, 512):
        def run():
            for layer in range(LAYERS):
                t1_ops.paged_decomposed_prefill_fwd(r, qr, x[layer], kr[layer], row, end - C,
                                                    C, (Dm + Rr) ** -0.5)
        yield {"case": "b4", "end": end, "us": graph_us(run) / LAYERS}


def b5():
    from repro_torch.kernels.cpq_attn import ops as cpq_ops
    from repro_torch.serving.paged_cache import PagedCPQTensor

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, KV, Dh, page, nb, L = 8, 16, 64, 16, 64, 4
    lengths = torch.tensor(B5_LENGTHS, dtype=torch.int32, device="cuda")
    bt = torch.zeros((B, nb), dtype=torch.int32, device="cuda")
    perm = torch.randperm(B * nb, generator=gen, device="cuda").int() + 1
    for b in range(B):
        n = -(-int(lengths[b]) // page)
        bt[b, :n] = perm[b * nb:b * nb + n]

    def arena():
        codes = (torch.randint(0, 16, (1 + B * nb, page, KV, Dh), generator=gen,
                               device="cuda") - 128).to(torch.int8)
        level = torch.randint(0, L, (1 + B * nb, page, KV), generator=gen,
                              device="cuda").int()
        scale = 0.1 + torch.rand((B, L, KV, Dh), generator=gen, device="cuda")
        return PagedCPQTensor(codes, level, scale, -scale * 7,
                              torch.ones((B, KV), dtype=torch.int32, device="cuda"),
                              torch.zeros((B, KV, Dh), device="cuda"))

    arenas = [(arena(), arena()) for _ in range(LAYERS)]
    q = torch.randn((B, 1, KV, Dh), generator=gen, device="cuda").bfloat16()

    def run():
        for kt, vt in arenas:
            cpq_ops.paged_cpq_decode(q, kt, vt, bt, lengths, Dh ** -0.5)
    yield {"case": "b5", "B": B, "KV": KV, "Dh": Dh, "us": graph_us(run) / LAYERS}


B5_LENGTHS = (64, 576, 300, 151, 420, 97, 512, 233)
B1_LIGHT_LENGTHS = (16, 64, 200, 33, 150, 96, 180, 62)


def _served_rows(gen, B, nb, page, rows=None):
    """Block table (permuted pages, unmapped entries at the null page 0) and
    lengths of ``rows`` (B5_LENGTHS) over nb pages of ``page``."""
    lengths = torch.tensor(rows or B5_LENGTHS, dtype=torch.int32, device="cuda")
    bt = torch.zeros((B, nb), dtype=torch.int32, device="cuda")
    perm = torch.randperm(B * nb, generator=gen, device="cuda").int() + 1
    for b in range(B):
        n = -(-int(lengths[b]) // page)
        bt[b, :n] = perm[b * nb:b * nb + n]
    return bt, lengths


def b1():
    from repro_torch.kernels.paged_attn import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, KV, Dh, page, nb = 8, 16, 64, 16, 64
    kv = [(torch.randn((1 + B * nb, page, KV, Dh), generator=gen, device="cuda").bfloat16(),
           torch.randn((1 + B * nb, page, KV, Dh), generator=gen, device="cuda").bfloat16())
          for _ in range(LAYERS)]
    q = torch.randn((B, 1, KV, Dh), generator=gen, device="cuda").bfloat16()
    for rows in (B5_LENGTHS, B1_LIGHT_LENGTHS):
        bt, lengths = _served_rows(gen, B, nb, page, rows)

        def run():
            for k, v in kv:
                ops.paged_decode(q, k, v, bt, lengths, Dh ** -0.5)
        yield {"case": "b1", "B": B, "KV": KV, "Dh": Dh, "lengths": list(rows),
               "us": graph_us(run) / LAYERS}


def b7():
    from repro_torch.kernels.topk_retrieval import ops as t3_ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, KV, Dp, page, nb = 8, 16, 64, 16, 64
    codes = [torch.randint(-128, 128, (1 + B * nb, page, KV, Dp), generator=gen,
                           device="cuda").to(torch.int8) for _ in range(LAYERS)]
    scale = 0.005 + 0.025 * torch.rand((B, KV, Dp), generator=gen, device="cuda")
    zero = -1.5 + 0.3 * torch.randn((B, KV, Dp), generator=gen, device="cuda")
    q = torch.randn((B, 1, KV, Dp), generator=gen, device="cuda").bfloat16()
    takes_scale = "q_scale" in inspect.signature(t3_ops.paged_proxy_scores).parameters
    n, qscale = nb * page, Dp ** -0.5

    for rows in (B5_LENGTHS, B1_LIGHT_LENGTHS):
        bt, lengths = _served_rows(gen, B, nb, page, rows)

        def wrapper():
            for c in codes:
                t3_ops.paged_proxy_scores(q[:, 0], scale, zero, c, bt, lengths, n)

        def served():
            for c in codes:
                if takes_scale:
                    t3_ops.paged_proxy_scores(q[:, 0], scale, zero, c, bt, lengths, n,
                                              q_scale=qscale)
                else:
                    t3_ops.paged_proxy_scores(q[:, 0] * qscale, scale, zero, c, bt, lengths, n)
        for form, fn in (("wrapper", wrapper), ("served", served)):
            yield {"case": "b7", "form": form, "B": B, "KV": KV, "Dp": Dp, "n": n,
                   "lengths": list(rows), "us": graph_us(fn) / LAYERS}


def b3():
    from repro_torch.kernels.decomposed_attn import ops as t1_ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, Dm, kv_r, Rr, page, nb = 8, 16, 1024, 16, 32, 16, 64
    lengths = torch.tensor(B5_LENGTHS, dtype=torch.int32, device="cuda")
    bt = torch.zeros((B, nb), dtype=torch.int32, device="cuda")
    perm = torch.randperm(B * nb, generator=gen, device="cuda").int() + 1
    for b in range(B):
        n = -(-int(lengths[b]) // page)
        bt[b, :n] = perm[b * nb:b * nb + n]
    x = [torch.randn((1 + B * nb, page, Dm), generator=gen, device="cuda").bfloat16()
         for _ in range(LAYERS)]
    kr = [torch.randn((1 + B * nb, page, kv_r, Rr), generator=gen, device="cuda").bfloat16()
          for _ in range(LAYERS)]
    r = torch.randn((B, H, Dm), generator=gen, device="cuda").bfloat16()
    qr = torch.randn((B, H, Rr), generator=gen, device="cuda").bfloat16()

    def run():
        for layer in range(LAYERS):
            t1_ops.paged_decomposed_decode_fwd(r, qr, x[layer], kr[layer], bt, lengths,
                                               (Dm + Rr) ** -0.5)
    yield {"case": "b3", "B": B, "lengths": list(B5_LENGTHS), "us": graph_us(run) / LAYERS}


def b9():
    from repro_torch.kernels.decomposed_attn import ops as t1_ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, N, H, Dm, kv_r, Rr = 8, 576, 16, 1024, 16, 32
    x = [torch.randn((B, N, Dm), generator=gen, device="cuda").bfloat16()
         for _ in range(LAYERS)]
    kr = [torch.randn((B, N, kv_r, Rr), generator=gen, device="cuda").bfloat16()
          for _ in range(LAYERS)]
    r = torch.randn((B, H, Dm), generator=gen, device="cuda").bfloat16()
    qr = torch.randn((B, H, Rr), generator=gen, device="cuda").bfloat16()
    for length in (128, 320, 575):
        def run():
            for layer in range(LAYERS):
                t1_ops.decomposed_decode_fwd(r, qr, x[layer], kr[layer], length,
                                             (Dm + Rr) ** -0.5)
        yield {"case": "b9", "B": B, "length": length, "us": graph_us(run) / LAYERS}


def b8_f32():
    from repro_torch.kernels.flash_attn import ops as fa_ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, KV, G = 8, 575, 2, 8
    for D in (32, 64):
        q = torch.randn((B, 1, KV * G, D), generator=gen, device="cuda")
        kv = [(torch.randn((B, S, KV, D), generator=gen, device="cuda"),
               torch.randn((B, S, KV, D), generator=gen, device="cuda")) for _ in range(LAYERS)]

        def run():
            for k, v in kv:
                fa_ops.flash_attention(q, k, v, D ** -0.5, causal=False)
        yield {"case": "b8_f32", "B": B, "S": S, "KV": KV, "G": G, "D": D,
               "us": graph_us(run) / LAYERS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default="b1,b3,b4,b5,b7,b8_f32,b9",
                    help="comma-separated cases to time")
    ap.add_argument("--set", action="append", default=[], metavar="FAMILY.NAME=VALUE",
                    help="override an integer constant of repro_torch.kernels.FAMILY.ops")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    settings = {}
    for item in args.set:
        name, value = item.split("=")
        family, const = name.rsplit(".", 1)
        mod = importlib.import_module(f"repro_torch.kernels.{family}.ops")
        if not hasattr(mod, const):
            raise SystemExit(f"torch_kernel_times: {family}.ops has no {const}")
        setattr(mod, const, int(value))
        settings[name] = int(value)
    cases = {"b1": b1, "b3": b3, "b4": b4, "b5": b5, "b7": b7, "b8_f32": b8_f32, "b9": b9}
    for name in args.cases.split(","):
        for rec in cases[name]():
            print(json.dumps({**rec, "set": settings, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
