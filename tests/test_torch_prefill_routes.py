"""The route a kernel with two routes takes on the card, chosen before the
launch from dtype and widths (and, for B6, the tables' levels): B1
``paged_decode`` runs bf16 and float32 whose Dh and Dv are multiples of 16
up to 256 (over at most RING_MAX_PAGES pages a row) on its ring of
asynchronous copies (``paged_attn/csrc/paged_token.cuh``), other widths on
the sweep; B2
``paged_prefill`` and B6 ``paged_cpq_prefill`` run bf16 chunks whose Dh and
Dv are multiples of 8 up to 256 on the tensor-core kernel
(``paged_attn/csrc/paged_chunk.cuh``), B4 ``paged_decomposed_prefill`` bf16
chunks with d_model a multiple of 8 up to 1024 and a roped slice of 0 or a
multiple of 8 up to 64 on its own (``decomposed_attn/csrc/
paged_decomposed_chunk.cuh``), and everything else on the CUDA-core sweep;
B5 ``paged_cpq_decode`` runs Dh and Dv multiples of 16 up to 256 on the
single-query decode (``flash_attn/csrc/single_query.cuh``), either dtype,
and other widths on the sweep; B3 ``paged_decomposed_decode`` and B9
``decomposed_decode`` run bf16 with d_model a multiple of 8 up to 1024 and
a roped slice of 0 or a multiple of 8 (as many roped groups as a cluster's
rope steps hold) on their tensor-core kernel
(``decomposed_attn/csrc/t1_token.cuh``), everything else on the sweep. The
choices, the split plans of B1's, B3's, B4's, B5's and B9's new routes and
how B7's wrappers pass a length are plain functions, so they are tested
here without a card; ``test_torch_kernels_cuda.py`` checks on the card that each call moves
its route's counter."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import single_query
from repro_torch.kernels.cpq_attn import ops as cpq_ops
from repro_torch.kernels.decomposed_attn import ops as t1_ops
from repro_torch.kernels.paged_attn import ops
from repro_torch.kernels.topk_retrieval import ops as t3_ops
from torch_paged_cases import cpq_arena, cpq_pool

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype, Dh, Dv, route", [
    (BF16, 64, 64, "tensor_core"),    # qwen1.5-0.5b, as served
    (BF16, 128, 128, "tensor_core"),
    (BF16, 8, 8, "tensor_core"),      # the narrowest: padded to 16
    (BF16, 256, 256, "tensor_core"),  # gemma-2b's head dim
    (BF16, 64, 128, "tensor_core"),   # Dv apart from Dh
    (BF16, 24, 24, "tensor_core"),    # a multiple of 8, not of 16
    (F32, 64, 64, "sweep"),           # float32: TF32 would miss the float32 gate
    (F32, 8, 8, "sweep"),
    (BF16, 12, 12, "sweep"),          # no multiple of 8
    (BF16, 64, 20, "sweep"),
    (BF16, 264, 264, "sweep"),        # past 256
    (torch.float16, 64, 64, "sweep"),
])
def test_prefill_route(dtype, Dh, Dv, route):
    assert ops.prefill_route(dtype, Dh, Dv) == route


@pytest.mark.parametrize("dtype, Dh, Dv, nb, route", [
    (BF16, 64, 64, 64, "ring"),         # qwen1.5-0.5b, as served
    (F32, 64, 64, 64, "ring"),          # float32: the same float32 arithmetic
    (BF16, 128, 128, 64, "ring"),       # the GQA shape of chip_smoke.py
    (BF16, 16, 16, 1, "ring"),          # the narrowest: one 16-byte chunk in bf16
    (F32, 256, 256, 64, "ring"),        # gemma-2b's head dim, the widest tile
    (BF16, 64, 128, 64, "ring"),        # Dv apart from Dh
    (BF16, 48, 48, 64, "ring"),         # a multiple of 16, not a power of two
    (BF16, 64, 64, ops.RING_MAX_PAGES, "ring"),
    (BF16, 64, 64, ops.RING_MAX_PAGES + 1, "sweep"),  # the block table past shared memory's share
    (BF16, 24, 24, 64, "sweep"),        # a multiple of 8, not of 16
    (F32, 8, 8, 4, "sweep"),
    (BF16, 64, 40, 64, "sweep"),
    (BF16, 272, 272, 64, "sweep"),      # past 256
    (torch.float16, 64, 64, 64, "sweep"),
])
def test_decode_route(dtype, Dh, Dv, nb, route):
    assert ops.decode_route(dtype, Dh, Dv, nb) == route


@pytest.mark.parametrize("B, KV, G, capacity, want", [
    (8, 16, 1, 1024, 1),     # B1 as served: 128 units fill the card, one block each
    (8, 8, 4, 1024, 2),      # the GQA shape: 64 units, two ranks each
    (1, 16, 1, 1024, 8),     # one row: the most ranks
    (1, 16, 1, 512, 4),      # ... while each keeps RING_MIN_KEYS of the capacity
    (1, 2, 1, 100, 1),       # a short arena: one block
    (4, 8, 8, 2048, 2),      # G 8: two head groups of 4 a kv head
    (64, 16, 1, 1024, 1),    # more units than SMs
])
def test_decode_plan(monkeypatch, B, KV, G, capacity, want):
    """B1's ranks a unit: planned from the units and the capacity (not the
    lengths, which live on the card), 1, 2, 4 or 8, the blocks at most one
    an SM where there are ranks to spare, at least RING_MIN_KEYS keys of
    the capacity each."""
    monkeypatch.setattr(single_query, "_sm_count", lambda device: 132)
    cs = ops.decode_plan(B, KV, G, capacity, torch.device("cpu"))
    assert cs == want and cs in (1, 2, 4, 8) and cs <= ops.RING_MAX_CLUSTER
    units = B * KV * (1 if G == 1 else -(-G // 4))
    assert cs == 1 or (cs * units <= 132 and capacity >= cs * ops.RING_MIN_KEYS)


@pytest.mark.parametrize("length, by_value", [
    (77, 77),                                          # an int: by value
    (torch.tensor(77, dtype=torch.int32), 77),         # the static engine's () host length
    (torch.tensor([77], dtype=torch.int64), 77),       # one element, any integer type
    (torch.tensor([5, 9], dtype=torch.int32), None),   # a length a row: by pointer
])
def test_proxy_scores_lengths(length, by_value):
    """How B7's wrappers hand a length to the kernel: a host scalar by
    value (no copy to the card, no sync), a length a row by pointer, with
    the stride that reads row b's."""
    lens, stride, host = t3_ops._lengths(length)
    if by_value is None:
        assert torch.equal(lens, length) and stride == 1 and host == 0
    else:
        assert lens is None and stride == 0 and host == by_value


@pytest.mark.parametrize("dtype, D, levels, route", [
    (BF16, 64, 4, "tensor_core"),     # the default CPQCfg: 4 HQE levels
    (BF16, 8, 1, "tensor_core"),
    (BF16, 64, cpq_ops.MAX_CHUNK_LEVELS, "tensor_core"),
    (BF16, 64, cpq_ops.MAX_CHUNK_LEVELS + 1, "sweep"),  # tables past shared memory's share
    (F32, 64, 4, "sweep"),
    (BF16, 12, 4, "sweep"),
])
def test_cpq_prefill_route(dtype, D, levels, route):
    assert cpq_ops.cpq_prefill_route(dtype, D, D, levels) == route


@pytest.mark.parametrize("dtype, Dm, Rr, route", [
    (BF16, 1024, 32, "tensor_core"),  # qwen1.5-0.5b, as served
    (BF16, 512, 64, "tensor_core"),   # MLA-like: one shared roped key of 64
    (BF16, 256, 0, "tensor_core"),    # no roped term
    (BF16, 8, 8, "tensor_core"),      # the narrowest
    (BF16, 1000, 16, "tensor_core"),  # a multiple of 8, not of the warps' slice
    (F32, 1024, 32, "sweep"),         # float32: TF32 would miss the float32 gate
    (F32, 256, 0, "sweep"),
    (BF16, 2560, 32, "sweep"),        # past MAX_CHUNK_DM: qwen3-4b ...
    (BF16, 3072, 32, "sweep"),        # phi4-mini
    (BF16, 4096, 32, "sweep"),        # opt-6.7b
    (BF16, 8192, 64, "sweep"),        # jamba
    (BF16, 1032, 32, "sweep"),        # just past MAX_CHUNK_DM
    (BF16, 1020, 32, "sweep"),        # d_model no multiple of 8
    (BF16, 1024, 4, "sweep"),         # a roped slice no multiple of 8
    (BF16, 1024, 72, "sweep"),        # a roped slice past MAX_CHUNK_RR
    (torch.float16, 1024, 32, "sweep"),
])
def test_t1_prefill_route(dtype, Dm, Rr, route):
    assert t1_ops.t1_prefill_route(dtype, Dm, Rr) == route


@pytest.mark.parametrize("Dh, Dv, route", [
    (64, 64, "single_query"),         # qwen1.5-0.5b, as served
    (128, 128, "single_query"),
    (16, 16, "single_query"),
    (256, 256, "single_query"),       # gemma-2b's head dim
    (64, 128, "single_query"),
    (24, 24, "sweep"),                # no multiple of the code loader's 16-byte chunk
    (8, 8, "sweep"),
    (12, 12, "sweep"),
    (272, 272, "sweep"),              # past 256
])
def test_cpq_decode_route(Dh, Dv, route):
    assert cpq_ops.cpq_decode_route(Dh, Dv) == route


@pytest.mark.parametrize("dtype, H, Dm, kv_r, Rr, route", [
    (BF16, 16, 1024, 16, 32, "tensor_core"),  # qwen1.5-0.5b, as served: 16 groups of 32
    (BF16, 16, 512, 1, 64, "tensor_core"),    # MLA-like: one shared roped key of 64
    (BF16, 8, 256, 1, 0, "tensor_core"),      # no roped term, 8 heads (a padded tile)
    (BF16, 32, 512, 8, 16, "tensor_core"),    # two head tiles
    (BF16, 4, 16, 2, 8, "tensor_core"),       # one block, no cluster
    (BF16, 16, 1000, 16, 32, "tensor_core"),  # a multiple of 8, not of the 128-column slice
    (F32, 16, 1024, 16, 32, "sweep"),         # float32: TF32 would miss the float32 gate
    (F32, 8, 256, 1, 0, "sweep"),
    (BF16, 32, 2560, 8, 32, "sweep"),         # past TOKEN_SLICE * TOKEN_MAX_CLUSTER: qwen3-4b ...
    (BF16, 24, 3072, 8, 32, "sweep"),         # phi4-mini
    (BF16, 32, 4096, 32, 32, "sweep"),        # opt-6.7b
    (BF16, 64, 8192, 8, 64, "sweep"),         # jamba
    (BF16, 16, 1032, 16, 32, "sweep"),        # just past 1024
    (BF16, 16, 1020, 16, 32, "sweep"),        # d_model no multiple of 8
    (BF16, 16, 1024, 16, 4, "sweep"),         # a roped slice no multiple of 8
    (BF16, 16, 256, 16, 32, "sweep"),         # 32 roped steps over a cluster of 2
    (torch.float16, 16, 1024, 16, 32, "sweep"),
])
def test_t1_decode_route(dtype, H, Dm, kv_r, Rr, route):
    assert t1_ops.t1_decode_route(dtype, H, Dm, kv_r, Rr) == route


@pytest.mark.parametrize("B, H, Dm, capacity, of, want", [
    (8, 16, 1024, 1024, "capacity", (8, 128)),  # B3 as served: 64 pages of 16, 4 blocks an SM
    (8, 16, 1024, 575, "length", (3, 192)),     # B9 as served: the fewest splits
    (8, 16, 1024, 320, "length", (2, 160)),
    (3, 16, 1024, 40, "length", (1, 48)),       # short: one split
    (8, 16, 1024, 0, "length", (1, 16)),        # length 0: one split without keys
    (8, 16, 1024, 4096, "length", (22, 192)),   # long: splits of at most TOKEN_KEYS
    (64, 16, 1024, 1024, "capacity", (6, 176)),  # many rows fill the card with few splits
    (3, 16, 1024, 128, "capacity", (1, 128)),  # the served cases' capacity: one split
    (1, 16, 128, 8192, "length", (43, 192)),    # one block a split
    (4, 32, 512, 300, "length", (2, 160)),      # two head tiles over a cluster of 4
])
def test_t1_decode_plan(monkeypatch, B, H, Dm, capacity, of, want):
    """B3's and B9's tensor-core splits: B9 the fewest of at most TOKEN_KEYS
    keys; B3, from the capacity, at least TOKEN_SPLIT_KEYS keys and at most
    TOKEN_MAX_SPLITS splits where they fill the card, and never more than
    TOKEN_KEYS keys a split; both covering the capacity."""
    monkeypatch.setattr(single_query, "_sm_count", lambda device: 132)
    splits, keys = t1_ops.t1_decode_plan(B, H, Dm, capacity, torch.device("cpu"), of)
    assert (splits, keys) == want
    assert splits * keys >= capacity > (splits - 1) * keys or capacity == 0
    assert keys <= t1_ops.TOKEN_KEYS and keys % 16 == 0
    assert splits <= t1_ops.TOKEN_MAX_SPLITS or keys > t1_ops.TOKEN_KEYS - 16


def test_route_counters_name_both_routes():
    assert (set(ops.ROUTE_LAUNCHES) == set(cpq_ops.ROUTE_LAUNCHES)
            == set(t1_ops.ROUTE_LAUNCHES) == set(t1_ops.DECODE_ROUTE_LAUNCHES)
            == set(t1_ops.CONTIG_ROUTE_LAUNCHES) == {"tensor_core", "sweep"})
    assert set(cpq_ops.DECODE_ROUTE_LAUNCHES) == {"single_query", "sweep"}
    assert set(ops.DECODE_ROUTE_LAUNCHES) == {"ring", "sweep"}


@pytest.mark.parametrize("capacity, want", [
    (1024, (8, 128)),    # the served decode: 64 pages of 16
    (128, (1, 128)),
    (40, (1, 128)),      # a short arena: one split
    (2048, (16, 128)),   # the most splits of DECODE_SPLIT_KEYS
    (4096, (16, 256)),   # past them: longer splits
    (5000, (16, 320)),   # a multiple of 16 keys
])
def test_cpq_decode_plan(capacity, want):
    """B5's splits, planned from the capacity nb * page without reading the
    lengths: they cover the capacity, at most DECODE_MAX_SPLITS of them."""
    splits, keys = cpq_ops.decode_plan(capacity)
    assert (splits, keys) == want
    assert splits * keys >= capacity > (splits - 1) * keys and keys % 16 == 0
    assert splits <= cpq_ops.DECODE_MAX_SPLITS


@pytest.mark.parametrize("C, H, kv_r, end, want", [
    (16, 16, 16, 16, (1, 32)),       # a first chunk: one split of one 32-key tile
    (16, 16, 16, 128, (2, 64)),      # 16 row tiles (one a head): two splits of 64 keys
    (16, 16, 16, 528, (4, 160)),     # past 512 keys: at most MAX_CHUNK_SPLITS splits
    (8, 16, 16, 300, (4, 96)),       # a chunk of 8: still one tile a head (half padding)
    (16, 16, 1, 200, (4, 64)),       # one shared roped key: tiles of one head each
    (16, 8, 1, 4000, (4, 1024)),     # long: longer splits
])
def test_t1_chunk_plan(monkeypatch, C, H, kv_r, end, want):
    """B4's tensor-core splits: whole 32-key tiles, at least CHUNK_SPLIT_KEYS
    keys and at most MAX_CHUNK_SPLITS splits (a cluster) covering [0, end)."""
    monkeypatch.setattr(single_query, "_sm_count", lambda device: 132)
    splits, keys = t1_ops.t1_chunk_plan(C, H, kv_r, end, torch.device("cpu"))
    assert (splits, keys) == want
    assert splits * keys >= end > (splits - 1) * keys and keys % t1_ops.CHUNK_KEYS == 0
    assert splits <= t1_ops.MAX_CHUNK_SPLITS


def test_cpu_tensors_take_no_route():
    """On the CPU the wrappers run their plain versions: no route counter
    moves, whatever the dtype (B1, B2, B3, B4, B5, B9)."""
    counters = (ops.ROUTE_LAUNCHES, cpq_ops.ROUTE_LAUNCHES, t1_ops.ROUTE_LAUNCHES,
                cpq_ops.DECODE_ROUTE_LAUNCHES, t1_ops.DECODE_ROUTE_LAUNCHES,
                t1_ops.CONTIG_ROUTE_LAUNCHES, ops.DECODE_ROUTE_LAUNCHES)
    before = [dict(c) for c in counters]
    q = torch.randn(1, 4, 2, 16, dtype=BF16)
    kp = torch.randn(3, 4, 2, 16, dtype=BF16)
    row = torch.tensor([1, 2], dtype=torch.int32)
    ops.paged_prefill(q, kp, kp, row, 2, 3, 0.25)
    ops.paged_decode(q[:, :1], kp, kp, row[None], torch.tensor([5], dtype=torch.int32), 0.25)
    r, qr = torch.randn(4, 2, 64, dtype=BF16), torch.randn(4, 2, 8, dtype=BF16)
    x, kr = torch.randn(3, 4, 64, dtype=BF16), torch.randn(3, 4, 2, 8, dtype=BF16)
    t1_ops.paged_decomposed_prefill_fwd(r, qr, x, kr, row, 2, 3, 0.25)
    t1_ops.paged_decomposed_decode_fwd(r[:1], qr[:1], x, kr, row[None],
                                       torch.tensor([5], dtype=torch.int32), 0.25)
    t1_ops.decomposed_decode_fwd(r[:1], qr[:1], x[:1], kr[:1], 3, 0.25)
    kt = cpq_arena(cpq_pool(np.random.default_rng(0), 3, 4, 2, 16, 1, 4, 4))
    cpq_ops.paged_cpq_decode(q[:, :1], kt, kt, row[None], torch.tensor([5], dtype=torch.int32),
                             0.25)
    assert [dict(c) for c in counters] == before
