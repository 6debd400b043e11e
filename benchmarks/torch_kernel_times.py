"""Device time per launch of the port's kernels at fixed shapes, on
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
  b3_mla, b4_mla, b9_mla  B3, B4 and B9 at deepseek-v2-lite's MLA shape (H = 16,
          the latent Dm = 512, one roped key of 64 shared by every head),
          the rows of b3, the chunks of b4 and the lengths of b9, over 27
          layer arenas
  b8_mla  flash_attention's prompt route (B8) at MLA's Dh 192 / Dv 128,
          16 heads, causal: one-shot admissions of 512 and 128 tokens and
          the static batch of 8 x 512
  (the _mla cases also report their bound, their plain version's and one
  PyTorch call's device time)

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


# ------------------------------------------- deepseek-v2-lite's MLA shapes
#
# The latent of 512 and one roped key of 64 shared by 16 heads (T1's kernels
# at KV = H = 16, kv_r = 1), over 27 layer arenas; B8 at the MLA prompt's
# Dh 192 / Dv 128. Each case also reports its bound (the bytes of every
# input and output once over 3.35 TB/s, or the operations over the bf16
# tensor-core peak, the larger), its plain version's and one PyTorch call's
# device time (scaled_dot_product_attention: for T1 on q = [R | q_rope],
# k = [X | roped key], v = X gathered beforehand; a yardstick only).

MLA_LAYERS = 27
MLA = dict(H=16, Dm=512, kv_r=1, Rr=64)
HBM, BF16 = 3.35e12, 989e12


def _bound(nbytes: float, flops: float) -> dict:
    t_bytes, t_ops = nbytes / HBM * 1e6, flops / BF16 * 1e6
    return {"bound_us": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations"}


def _t1_sdpa(r, qr, xg, krg, mask):
    """scaled_dot_product_attention on T1's operands (r (N, T, H, Dm), xg
    (N, n, Dm), krg (N, n, kv_r, Rr)): the same scores and P."""
    N, T_, H, _ = r.shape
    n = xg.shape[1]
    kr = krg.repeat_interleave(H // krg.shape[2], dim=2).transpose(1, 2)
    x = xg[:, None].expand(N, H, n, xg.shape[2])
    q = torch.cat([r, qr], -1).transpose(1, 2)
    k, v = torch.cat([x, kr], -1).contiguous(), x.contiguous()
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=(r.shape[-1] + qr.shape[-1]) ** -0.5)


def b3_mla():
    from repro_torch.kernels.decomposed_attn import ops as t1_ops
    from repro_torch.serving.paged_cache import gather_pages

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, page, nb = 8, 16, 64
    H, Dm, kv_r, Rr = MLA["H"], MLA["Dm"], MLA["kv_r"], MLA["Rr"]
    bt, lengths = _served_rows(gen, B, nb, page)
    x = [torch.randn((1 + B * nb, page, Dm), generator=gen, device="cuda").bfloat16()
         for _ in range(MLA_LAYERS)]
    kr = [torch.randn((1 + B * nb, page, kv_r, Rr), generator=gen, device="cuda").bfloat16()
          for _ in range(MLA_LAYERS)]
    r = torch.randn((B, H, Dm), generator=gen, device="cuda").bfloat16()
    qr = torch.randn((B, H, Rr), generator=gen, device="cuda").bfloat16()
    scale = (Dm + Rr) ** -0.5

    def run():
        for layer in range(MLA_LAYERS):
            t1_ops.paged_decomposed_decode_fwd(r, qr, x[layer], kr[layer], bt, lengths, scale)
    live = int(lengths.sum())
    nbytes = (live * (Dm + kv_r * Rr) * 2 + (B * H * (Dm + Rr) + r.numel()) * 2
              + bt.numel() * 4 + lengths.numel() * 4)
    mask = (torch.arange(nb * page, device="cuda")[None, :] < lengths[:, None])[:, None, None]
    lib = _t1_sdpa(r[:, None], qr[:, None], gather_pages(x[0], bt), gather_pages(kr[0], bt),
                   mask)
    yield {"case": "b3_mla", "B": B, **MLA, "lengths": list(B5_LENGTHS),
           "route": t1_ops.t1_decode_route(torch.bfloat16, H, Dm, kv_r, Rr),
           "us": graph_us(run) / MLA_LAYERS,
           "plain_us": graph_us(lambda: t1_ops.paged_decomposed_decode_plain(
               r, qr, x[0], kr[0], bt, lengths, scale)),
           "library_us": graph_us(lib), **_bound(nbytes, 2.0 * live * H * (2 * Dm + Rr))}


def b4_mla():
    from repro_torch.kernels.decomposed_attn import ops as t1_ops
    from repro_torch.serving.paged_cache import gather_pages

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, Dm, kv_r, Rr = MLA["H"], MLA["Dm"], MLA["kv_r"], MLA["Rr"]
    page, C, nb = 16, 16, 32
    x = [torch.randn((nb + 1, page, Dm), generator=gen, device="cuda").bfloat16()
         for _ in range(MLA_LAYERS)]
    kr = [torch.randn((nb + 1, page, kv_r, Rr), generator=gen, device="cuda").bfloat16()
          for _ in range(MLA_LAYERS)]
    row = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")
    r = torch.randn((C, H, Dm), generator=gen, device="cuda").bfloat16()
    qr = torch.randn((C, H, Rr), generator=gen, device="cuda").bfloat16()
    scale = (Dm + Rr) ** -0.5
    for end in (16, 128, 256, 512):
        off = end - C

        def run():
            for layer in range(MLA_LAYERS):
                t1_ops.paged_decomposed_prefill_fwd(r, qr, x[layer], kr[layer], row, off, C,
                                                    scale)
        pairs = sum(off + i + 1 for i in range(C))
        nbytes = end * (Dm + kv_r * Rr) * 2 + C * H * (2 * Dm + Rr) * 2 + -(-end // page) * 4
        pos = torch.arange(end, device="cuda")
        mask = (pos[None, :] <= off + torch.arange(C, device="cuda")[:, None])[None, None]
        lib = _t1_sdpa(r[None], qr[None], gather_pages(x[0], row[None])[:, :end],
                       gather_pages(kr[0], row[None])[:, :end], mask)
        yield {"case": "b4_mla", "C": C, **MLA, "end": end,
               "route": t1_ops.t1_prefill_route(torch.bfloat16, Dm, Rr),
               "us": graph_us(run) / MLA_LAYERS,
               "plain_us": graph_us(lambda: t1_ops.paged_decomposed_prefill_plain(
                   r, qr, x[0], kr[0], row, off, C, scale)),
               "library_us": graph_us(lib), **_bound(nbytes, 2.0 * pairs * H * (2 * Dm + Rr))}


def b8_mla():
    from repro_torch.kernels.flash_attn import ops as fa_ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, Dh, Dv = 16, 192, 128
    for B, T_ in ((1, 512), (1, 128), (8, 512)):   # one-shot admissions; the static batch
        q = torch.randn((B, T_, H, Dh), generator=gen, device="cuda").bfloat16()
        kv = [(torch.randn((B, T_, H, Dh), generator=gen, device="cuda").bfloat16(),
               torch.randn((B, T_, H, Dv), generator=gen, device="cuda").bfloat16())
              for _ in range(MLA_LAYERS)]

        def run():
            for k, v in kv:
                fa_ops.flash_attention(q, k, v, Dh ** -0.5, causal=True)
        k0, v0 = kv[0]
        qq, kk, vv = q.transpose(1, 2), k0.transpose(1, 2), v0.transpose(1, 2)
        pairs = B * H * T_ * (T_ + 1) / 2
        nbytes = (q.numel() + k0.numel() + v0.numel() + B * T_ * H * Dv) * 2
        yield {"case": "b8_mla", "B": B, "T": T_, "H": H, "Dh": Dh, "Dv": Dv, "causal": True,
               "us": graph_us(run) / MLA_LAYERS,
               "plain_us": graph_us(lambda: fa_ops.flash_attention_plain(q, k0, v0, Dh ** -0.5)),
               "library_us": graph_us(lambda: torch.nn.functional.scaled_dot_product_attention(
                   qq, kk, vv, is_causal=True, scale=Dh ** -0.5)),
               **_bound(nbytes, 2.0 * pairs * (Dh + Dv))}


def b9_mla():
    from repro_torch.kernels.decomposed_attn import ops as t1_ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, Dm, kv_r, Rr = MLA["H"], MLA["Dm"], MLA["kv_r"], MLA["Rr"]
    B, N = 8, 576
    x = [torch.randn((B, N, Dm), generator=gen, device="cuda").bfloat16()
         for _ in range(MLA_LAYERS)]
    kr = [torch.randn((B, N, kv_r, Rr), generator=gen, device="cuda").bfloat16()
          for _ in range(MLA_LAYERS)]
    r = torch.randn((B, H, Dm), generator=gen, device="cuda").bfloat16()
    qr = torch.randn((B, H, Rr), generator=gen, device="cuda").bfloat16()
    scale = (Dm + Rr) ** -0.5
    for length in (128, 320, 575):
        def run():
            for layer in range(MLA_LAYERS):
                t1_ops.decomposed_decode_fwd(r, qr, x[layer], kr[layer], length, scale)
        nbytes = B * length * (Dm + kv_r * Rr) * 2 + (B * H * (Dm + Rr) + r.numel()) * 2
        lib = _t1_sdpa(r[:, None], qr[:, None], x[0][:, :length], kr[0][:, :length], None)
        yield {"case": "b9_mla", "B": B, **MLA, "N": N, "length": length,
               "route": t1_ops.t1_decode_route(torch.bfloat16, H, Dm, kv_r, Rr),
               "us": graph_us(run) / MLA_LAYERS,
               "plain_us": graph_us(lambda: t1_ops.decomposed_decode_plain(
                   r, qr, x[0], kr[0], length, scale)),
               "library_us": graph_us(lib),
               **_bound(nbytes, 2.0 * B * length * H * (2 * Dm + Rr))}


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
    cases = {"b1": b1, "b3": b3, "b4": b4, "b5": b5, "b7": b7, "b8_f32": b8_f32, "b9": b9,
             "b3_mla": b3_mla, "b4_mla": b4_mla, "b8_mla": b8_mla, "b9_mla": b9_mla}
    for name in args.cases.split(","):
        for rec in cases[name]():
            print(json.dumps({**rec, "set": settings, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
