"""The port's CUDA paged-attention kernels against their plain PyTorch
versions, on the layouts of the CPU tests, in float32 and bfloat16. Needs an
NVIDIA GPU and nvcc; skips elsewhere. JAX-free, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances (max abs): 1e-5 in float32 (both compute in float32 and differ in
summation order only), 2e-2 in bfloat16 (one bf16 rounding step of an output
below 4 in magnitude). The T2 (CPQ) kernels B5/B6 dequantize to the same
bf16 values as their plain versions and are held to 5e-5 in float32 (the
outputs reach 3 in magnitude) and 2e-2 in bfloat16. The T1 kernels B3/B4
return P, a weighted mean of X rows, and are held to 1e-5 / 2e-2, also at
the widths they are built for (``T1_WIDE``). The T3 proxy-scoring kernel B7
takes float32 query factors and int8 codes only; its scores are held to
1e-5 x max |score| (float32 sums of 16-64 terms in another order) and its
masked scores must be exactly -1e30; it takes any number G of query heads
per kv head (G = 3 is phi4-mini's, G = 12 runs its runtime-G kernel). The
contiguous kernels: B8 (flash attention, causal or not, k and v possibly a
prefix of a longer arena) and B9 (contiguous T1 decode) at 1e-5 / 2e-2, B10
(contiguous T2 decode, float32 output, tiles rounded or not) at 5e-5. B8 has
three routes, and each test checks that its call took the one it must: a
bf16 prompt the tensor-core kernel, a float32 prompt the CUDA-core sweep, a
decode token (either dtype) the single-query kernel. The T1 kernels B3, B4
and B9 take d_model up to 8192 (the cases at 3072 and 4096, and the sweep of
``T1_WIDE_DM``). B2 and B6 have two routes each: bf16 chunks whose widths
are multiples of 8 up to 256 take the tensor-core kernel, float32 chunks
(and other bf16 widths) the CUDA-core sweep; each prefill test checks that
its call took the route it must, on the layouts of the CPU tests and on
``SERVED_PREFILL_CASES``. B4 has two routes as well: bf16 chunks with
d_model a multiple of 8 up to 1024 and a roped slice of 0 or a multiple of
8 up to 64 take its tensor-core kernel, float32 chunks and other widths the
sweep (``SERVED_T1_PREFILL_CASES``: qwen1.5-0.5b's chunks; the tensor-core
route's cluster merge forced with small splits). B5 runs Dh and Dv
multiples of 16 on the single-query decode, either dtype, and other widths
on the sweep (``SERVED_CPQ_DECODE_CASES`` and ``CARD_CPQ_DECODE_CASES``:
lengths on split boundaries, empty rows, a live row over an all-null block
row, at the served shape and at GQA; two launches back to back leave the
shared split counters at zero). B3 and B9 have two routes the same way:
bf16 calls with d_model a multiple of 8 up to 1024 and a roped slice of 0
or a multiple of 8 (as many roped groups as a cluster's rope steps hold)
take their tensor-core kernel, float32 calls and other widths the sweep
(``SERVED_T1_DECODE_CASES`` and the card's cases: the served shapes, empty
and full rows, 8 and 32 heads; splits forced small so that the last block
of each rank merges many partials; B3 and B9 back to back leave the split
counters at zero). B1 runs head widths that are multiples of 16, bf16 or
float32, on its ring kernel and other widths on the sweep
(``SERVED_DECODE_CASES`` and ``CARD_DECODE_CASES``: lengths 0 and 1, on
tile boundaries and at the full capacity, at the served shape and at GQA,
with the planned cluster and with the most ranks). The served B7 call forms
the query factors in its kernel from q in bf16 or float32, rows at any
stride, its scale given or not (``SERVED_PROXY_CASES``), held to its plain
version on the pre-scaled query at 1e-5 x max |score|. B2 also runs the
speculative verify chunk (``VERIFY_CASES``: C = 2, 5, 9 query rows at offsets
0, 1, 15, 17 and the block ceiling less C, over a draft's block row) on the
same routes and tolerances. The sampler (``serving/prng.py``,
``sample_token_rows``) on the card draws the CPU's Threefry bits exactly,
and the CPU's tokens but where the top-2 perturbed logits lie within 1e-6
(relative).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import single_query
from repro_torch.kernels.cpq_attn import ops as cpq_ops
from repro_torch.kernels.decomposed_attn import ops as t1_ops
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.paged_attn import ops
from repro_torch.kernels.topk_retrieval import ops as t3_ops
from repro_torch.serving import engine as teng, prng
from torch_paged_cases import (VERIFY_CASES, verify_inputs, CARD_CPQ_DECODE_CASES, CARD_DECODE_CASES, CONTIG_CPQ_CASES,
                               CONTIG_PROXY_CASES, CONTIG_T1_CASES, CPQ_DECODE_CASES,
                               CPQ_PREFILL_CASES, DECODE_CASES, FLASH_CASES, PREFILL_CASES,
                               PROXY_CASES, SERVED_CPQ_DECODE_CASES, SERVED_DECODE_CASES,
                               SERVED_PREFILL_CASES, SERVED_PROXY_CASES,
                               SERVED_T1_DECODE_CASES, SERVED_T1_PREFILL_CASES,
                               T1_DECODE_CASES, T1_PREFILL_CASES,
                               T1_WIDE, contig_cpq_inputs, contig_proxy_inputs,
                               contig_t1_inputs, cpq_arena, cpq_decode_inputs,
                               cpq_prefill_inputs, decode_inputs, flash_inputs,
                               prefill_inputs, proxy_inputs, proxy_tables,
                               served_cpq_decode_inputs,
                               served_cpq_prefill_inputs, served_decode_inputs,
                               served_prefill_inputs, served_proxy_inputs,
                               served_t1_decode_inputs, served_t1_prefill_inputs,
                               t1_decode_inputs, t1_prefill_inputs, tensors)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
CPQ_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, case, dtype):
    q, kp, vp, bt, lengths, scale = decode_inputs(*case)
    args = tensors(q, kp, vp, bt, lengths, device="cuda", dtype=dtype)
    before, routes = ops.paged_decode.launches, dict(ops.DECODE_ROUTE_LAUNCHES)
    out = ops.paged_decode(*args, scale)
    torch.cuda.synchronize()
    assert ops.paged_decode.launches == before + 1
    route = ops.decode_route(dtype, kp.shape[-1], vp.shape[-1], bt.shape[1])
    assert _route_moved(ops.DECODE_ROUTE_LAUNCHES, routes) == {
        r: int(r == route) for r in routes}
    ref = ops.paged_decode_plain(*args, scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)
    assert not out[args[4] == 0].any()  # empty rows -> zeros


def _check_ring_decode(case, dtype):
    q, kp, vp, bt, lengths, scale = served_decode_inputs(*case)
    args = tensors(q, kp, vp, bt, lengths, device="cuda", dtype=dtype)
    routes = dict(ops.DECODE_ROUTE_LAUNCHES)
    out = ops.paged_decode(*args, scale)
    torch.cuda.synchronize()
    assert _route_moved(ops.DECODE_ROUTE_LAUNCHES, routes) == {"ring": 1, "sweep": 0}
    ref = ops.paged_decode_plain(*args, scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)
    assert not out[args[4] == 0].any()
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SERVED_DECODE_CASES + CARD_DECODE_CASES)
def test_decode_ring_served_rows(cuda, case, dtype):
    """B1 on the ring route at the served page size and head dims, the
    cluster planned from the units and the capacity (one block a unit at
    the served shape, two ranks at its GQA shape): lengths 0 and 1, on tile
    and rank boundaries, at the full capacity of 1024 keys."""
    _check_ring_decode(case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SERVED_DECODE_CASES + CARD_DECODE_CASES)
def test_decode_ring_most_ranks(cuda, case, dtype, monkeypatch):
    """B1 with every unit cut over the most ranks a cluster takes (8): the
    ranks' merge through distributed shared memory, short rows leaving
    ranks without a tile."""
    monkeypatch.setattr(ops, "decode_plan", lambda *a: ops.RING_MAX_CLUSTER)
    _check_ring_decode(case, dtype)


@pytest.mark.cuda
def test_decode_ring_back_to_back(cuda):
    """B1 launches in a row on one stream, of other shapes and clusters,
    with one synchronization at the end: each matches its plain version
    (the ring route keeps no state between launches)."""
    outs, refs = [], []
    for case in SERVED_DECODE_CASES + CARD_DECODE_CASES:
        q, kp, vp, bt, lengths, scale = served_decode_inputs(*case)
        args = tensors(q, kp, vp, bt, lengths, device="cuda", dtype=torch.bfloat16)
        outs.append(ops.paged_decode(*args, scale))
        refs.append(ops.paged_decode_plain(*args, scale))
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[torch.bfloat16], rtol=0)


@pytest.mark.cuda
def test_decode_route_by_width(cuda):
    """B1's route counter: bf16 and float32 at Dh 64 and 16 take the ring,
    Dh 8 and 24 (no multiple of 16) the sweep; each matches its plain
    version."""
    for dtype, Dh, route in ((torch.bfloat16, 64, "ring"), (torch.float32, 64, "ring"),
                             (torch.float32, 16, "ring"), (torch.bfloat16, 24, "sweep"),
                             (torch.float32, 8, "sweep")):
        q, kp, vp, bt, lengths, scale = decode_inputs(3, 5, 4, 4, 2, 4, Dh)
        args = tensors(q, kp, vp, bt, lengths, device="cuda", dtype=dtype)
        before = dict(ops.DECODE_ROUTE_LAUNCHES)
        out = ops.paged_decode(*args, scale)
        torch.cuda.synchronize()
        assert _route_moved(ops.DECODE_ROUTE_LAUNCHES, before) == {
            r: int(r == route) for r in before}
        ref = ops.paged_decode_plain(*args, scale)
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)


def _route_moved(routes: dict, before: dict) -> dict:
    return {r: n - before[r] for r, n in routes.items()}


def _chunk_route(dtype) -> str:
    return "tensor_core" if dtype == torch.bfloat16 else "sweep"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PREFILL_CASES + SERVED_PREFILL_CASES)
def test_prefill_kernel_matches_plain(cuda, case, dtype):
    make = prefill_inputs if case in PREFILL_CASES else served_prefill_inputs
    q, kp, vp, row, offset, valid, scale = make(*case)
    args = tensors(q, kp, vp, row, device="cuda", dtype=dtype)
    before, routes = ops.paged_prefill.launches, dict(ops.ROUTE_LAUNCHES)
    out = ops.paged_prefill(*args, offset, valid, scale)
    torch.cuda.synchronize()
    assert ops.paged_prefill.launches == before + 1
    assert _route_moved(ops.ROUTE_LAUNCHES, routes) == {
        r: int(r == _chunk_route(dtype)) for r in routes}
    ref = ops.paged_prefill_plain(*args, offset, valid, scale)
    torch.testing.assert_close(out[0, :valid].float(), ref[0, :valid].float(),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", VERIFY_CASES)
def test_prefill_kernel_at_verify_shapes(cuda, case, dtype):
    """B2 on the speculative verify chunk: padded rows of a 16-row tile, an
    offset inside a page and the block ceiling."""
    q, kp, vp, row, offset, valid, scale = verify_inputs(*case)
    args = tensors(q, kp, vp, row, device="cuda", dtype=dtype)
    routes = dict(ops.ROUTE_LAUNCHES)
    out = ops.paged_prefill(*args, offset, valid, scale)
    torch.cuda.synchronize()
    assert _route_moved(ops.ROUTE_LAUNCHES, routes) == {
        r: int(r == _chunk_route(dtype)) for r in routes}
    ref = ops.paged_prefill_plain(*args, offset, valid, scale)
    torch.testing.assert_close(out[0, :valid].float(), ref[0, :valid].float(),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
def test_sampler_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(0)
    B, V = 32, 151936
    host = [torch.tensor(a) for a in (
        (rng.normal(size=(B, V)) * 3).astype(np.float32),
        rng.choice([0.0, 0.7, 1.0, 1.3], size=B).astype(np.float32),
        rng.choice([0, 50, 1000], size=B).astype(np.int32),
        rng.choice([1.0, 0.9, 0.6], size=B).astype(np.float32),
        rng.integers(0, 2**31 - 1, size=B).astype(np.int32),
        rng.integers(0, 4096, size=B).astype(np.int32))]
    card = [t.cuda() for t in host]
    keys = [prng.fold_in(prng.PRNGKey(a[4]), a[5]) for a in (host, card)]
    assert torch.equal(prng.random_bits(keys[1], (V,)).cpu(), prng.random_bits(keys[0], (V,)))
    assert torch.equal(prng.uniform(keys[1], (V,)).cpu(), prng.uniform(keys[0], (V,)))
    got = [teng.sample_token_rows(*a).cpu() for a in (host, card)]
    pert = teng.perturbed_logits(*host)
    for b in torch.nonzero(got[1] != got[0])[:, 0].tolist():
        top2 = pert[b].topk(2)
        a0, a1 = top2.values.tolist()
        assert abs(a0 - a1) <= 1e-6 * max(abs(a0), abs(a1), 1.0)
        assert {int(got[0][b]), int(got[1][b])} == set(top2.indices.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("case", SERVED_PREFILL_CASES)
def test_prefill_kernels_merge_many_splits(cuda, case, monkeypatch):
    """B2 and B6 on the tensor-core route with splits of 16 keys (up to the
    kernel's 32 splits): the last block's merge of the splits' partials,
    which served chunks of up to 512 keys never need."""
    monkeypatch.setattr(ops, "CHUNK_SPLIT_KEYS", 16)
    q, kp, vp, row, offset, valid, scale = served_prefill_inputs(*case)
    args = tensors(q, kp, vp, row, device="cuda", dtype=torch.bfloat16)
    out = ops.paged_prefill(*args, offset, valid, scale)
    torch.cuda.synchronize()
    ref = ops.paged_prefill_plain(*args, offset, valid, scale)
    torch.testing.assert_close(out[0, :valid].float(), ref[0, :valid].float(),
                               atol=TOL[torch.bfloat16], rtol=0)
    q, kp, vp, k_raw, v_raw, slot, row, offset, valid, scale = served_cpq_prefill_inputs(*case)
    q, k_raw, v_raw = _cpq_tensors(torch.bfloat16, q, k_raw, v_raw)
    kt, vt = cpq_arena(kp, "cuda"), cpq_arena(vp, "cuda")
    row = torch.tensor(row, device="cuda")
    out = cpq_ops.paged_cpq_prefill(q, kt, vt, k_raw, v_raw, slot, row, offset, valid, scale)
    torch.cuda.synchronize()
    ref = cpq_ops.paged_cpq_prefill_plain(q, kt, vt, k_raw, v_raw, slot, row, offset, valid,
                                          scale)
    torch.testing.assert_close(out[0, :valid].float(), ref[0, :valid].float(),
                               atol=CPQ_TOL[torch.bfloat16], rtol=0)


@pytest.mark.cuda
def test_prefill_route_by_dtype(cuda):
    """B2 and B6 at Dh 64: a bf16 chunk moves the tensor-core route's
    counter, a float32 chunk the sweep's; a bf16 chunk at Dh 12 (no multiple
    of 8) takes the sweep and matches its plain version."""
    case = SERVED_PREFILL_CASES[1]
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, row, offset, valid, scale = served_prefill_inputs(*case)
        before = dict(ops.ROUTE_LAUNCHES)
        ops.paged_prefill(*tensors(q, kp, vp, row, device="cuda", dtype=dtype), offset,
                          valid, scale)
        q, kp, vp, k_raw, v_raw, slot, row, offset, valid, scale = \
            served_cpq_prefill_inputs(*case)
        cpq_before = dict(cpq_ops.ROUTE_LAUNCHES)
        cpq_ops.paged_cpq_prefill(*_cpq_tensors(dtype, q), cpq_arena(kp, "cuda"),
                                  cpq_arena(vp, "cuda"), *_cpq_tensors(dtype, k_raw, v_raw),
                                  slot, torch.tensor(row, device="cuda"), offset, valid,
                                  scale)
        torch.cuda.synchronize()
        want = {r: int(r == _chunk_route(dtype)) for r in before}
        assert _route_moved(ops.ROUTE_LAUNCHES, before) == want
        assert _route_moved(cpq_ops.ROUTE_LAUNCHES, cpq_before) == want
    q, kp, vp, row, offset, valid, scale = prefill_inputs(3, 9, 6, 2, 2, Dh=12)
    args = tensors(q, kp, vp, row, device="cuda", dtype=torch.bfloat16)
    before = dict(ops.ROUTE_LAUNCHES)
    out = ops.paged_prefill(*args, offset, valid, scale)
    torch.cuda.synchronize()
    assert _route_moved(ops.ROUTE_LAUNCHES, before) == {"tensor_core": 0, "sweep": 1}
    ref = ops.paged_prefill_plain(*args, offset, valid, scale)
    torch.testing.assert_close(out[0, :valid].float(), ref[0, :valid].float(),
                               atol=TOL[torch.bfloat16], rtol=0)


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(cuda):
    q, kp, vp, bt, lengths, scale = decode_inputs(*DECODE_CASES[0])
    args = tensors(q, kp, vp, bt, lengths, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        ops.paged_decode(*args[:3], args[3].long(), args[4], scale)
    strided_q = torch.cat([args[0], args[0]], dim=-1)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_decode(strided_q, *args[1:], scale)
    with pytest.raises(ValueError, match="tensors on"):
        ops.paged_decode(args[0], args[1].cpu(), *args[2:], scale)
    assert ops.decode_route(torch.float32, 16, 16, args[3].shape[1]) == "ring"
    shifted = torch.empty(args[1].numel() + 1, device="cuda")[1:].view(args[1].shape)
    shifted.copy_(args[1])                                # contiguous, 4 bytes off 16
    with pytest.raises(ValueError, match="aligned"):
        ops.paged_decode(args[0], shifted, *args[2:], scale)
    with pytest.raises(ValueError, match="shapes"):       # lengths of another batch
        ops.paged_decode(*args[:4], args[4][:-1], scale)


# ---------------------------------------------------------------- T2 / CPQ


def _cpq_tensors(dtype, *arrays):
    return [torch.tensor(a, device="cuda", dtype=dtype) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CPQ_DECODE_CASES)
def test_cpq_decode_kernel_matches_plain(cuda, case, dtype):
    q, kp, vp, bt, lengths, scale = cpq_decode_inputs(*case)
    q, = _cpq_tensors(dtype, q)
    kt, vt = cpq_arena(kp, "cuda"), cpq_arena(vp, "cuda")
    bt, lengths = torch.tensor(bt, device="cuda"), torch.tensor(lengths, device="cuda")
    before, routes = cpq_ops.paged_cpq_decode.launches, dict(cpq_ops.DECODE_ROUTE_LAUNCHES)
    out = cpq_ops.paged_cpq_decode(q, kt, vt, bt, lengths, scale)
    torch.cuda.synchronize()
    assert cpq_ops.paged_cpq_decode.launches == before + 1
    route = cpq_ops.cpq_decode_route(q.shape[-1], vt.codes.shape[-1])
    assert _route_moved(cpq_ops.DECODE_ROUTE_LAUNCHES, routes) == {
        r: int(r == route) for r in routes}
    ref = cpq_ops.paged_cpq_decode_plain(q, kt, vt, bt, lengths, scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=CPQ_TOL[dtype], rtol=0)
    assert not out[lengths == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SERVED_CPQ_DECODE_CASES + CARD_CPQ_DECODE_CASES)
def test_cpq_decode_single_query_route(cuda, case, dtype, monkeypatch):
    """B5 on the single-query route at the served page size and head dims:
    lengths on split boundaries, an empty row, a live row over an all-null
    block row (its codes' levels out of range: zeros, read in bounds). The
    8-page cases take splits of 64 keys, so that their rows span two."""
    if case in SERVED_CPQ_DECODE_CASES:
        monkeypatch.setattr(cpq_ops, "DECODE_SPLIT_KEYS", 64)
    q, kp, vp, bt, lengths, scale = served_cpq_decode_inputs(*case)
    q, = _cpq_tensors(dtype, q)
    kt, vt = cpq_arena(kp, "cuda"), cpq_arena(vp, "cuda")
    bt, lengths = torch.tensor(bt, device="cuda"), torch.tensor(lengths, device="cuda")
    routes = dict(cpq_ops.DECODE_ROUTE_LAUNCHES)
    out = cpq_ops.paged_cpq_decode(q, kt, vt, bt, lengths, scale)
    torch.cuda.synchronize()
    assert _route_moved(cpq_ops.DECODE_ROUTE_LAUNCHES, routes) == {"single_query": 1, "sweep": 0}
    ref = cpq_ops.paged_cpq_decode_plain(q, kt, vt, bt, lengths, scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=CPQ_TOL[dtype], rtol=0)
    assert not out[lengths == 0].any()


@pytest.mark.cuda
def test_cpq_decode_back_to_back_leaves_counters_at_zero(cuda):
    """Two B5 launches in a row share the split counters (as the tiered tick
    runs B1 and B5, and as a CUDA graph replays them): each merges its own
    rows, and the counters are back at zero after them."""
    outs, refs = [], []
    for case in CARD_CPQ_DECODE_CASES:
        q, kp, vp, bt, lengths, scale = served_cpq_decode_inputs(*case)
        q, = _cpq_tensors(torch.bfloat16, q)
        kt, vt = cpq_arena(kp, "cuda"), cpq_arena(vp, "cuda")
        bt, lengths = torch.tensor(bt, device="cuda"), torch.tensor(lengths, device="cuda")
        outs.append(cpq_ops.paged_cpq_decode(q, kt, vt, bt, lengths, scale))
        refs.append(cpq_ops.paged_cpq_decode_plain(q, kt, vt, bt, lengths, scale))
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        torch.testing.assert_close(out.float(), ref.float(), atol=CPQ_TOL[torch.bfloat16],
                                   rtol=0)
    assert not single_query.counters(1, torch.device("cuda")).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CPQ_PREFILL_CASES + SERVED_PREFILL_CASES)
def test_cpq_prefill_kernel_matches_plain(cuda, case, dtype):
    make = cpq_prefill_inputs if case in CPQ_PREFILL_CASES else served_cpq_prefill_inputs
    q, kp, vp, k_raw, v_raw, slot, row, offset, valid, scale = make(*case)
    q, k_raw, v_raw = _cpq_tensors(dtype, q, k_raw, v_raw)
    kt, vt = cpq_arena(kp, "cuda"), cpq_arena(vp, "cuda")
    row = torch.tensor(row, device="cuda")
    before, routes = cpq_ops.paged_cpq_prefill.launches, dict(cpq_ops.ROUTE_LAUNCHES)
    out = cpq_ops.paged_cpq_prefill(q, kt, vt, k_raw, v_raw, slot, row, offset, valid, scale)
    torch.cuda.synchronize()
    assert cpq_ops.paged_cpq_prefill.launches == before + 1
    assert _route_moved(cpq_ops.ROUTE_LAUNCHES, routes) == {
        r: int(r == _chunk_route(dtype)) for r in routes}
    ref = cpq_ops.paged_cpq_prefill_plain(q, kt, vt, k_raw, v_raw, slot, row, offset,
                                          valid, scale)
    torch.testing.assert_close(out[0, :valid].float(), ref[0, :valid].float(),
                               atol=CPQ_TOL[dtype], rtol=0)


# ---------------------------------------------------------------- T1 / X

T1_DECODE_ALL = T1_DECODE_CASES + [(6 + i, 16, 8, 3, *w) for i, w in enumerate(T1_WIDE)]
T1_PREFILL_ALL = T1_PREFILL_CASES + [
    (6 + i, off, val, *w) for i, (w, (off, val)) in
    enumerate(zip(T1_WIDE, ((0, 16), (37, 16), (70, 9))))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", T1_DECODE_ALL)
def test_decomposed_decode_kernel_matches_plain(cuda, case, dtype):
    _check_t1_decode(dtype, *t1_decode_inputs(*case))


def _check_t1_decode(dtype, r, qr, xp, krp, bt, lengths, scale, route=None):
    """B3 on the card against its plain version; the call must move the
    route t1_decode_route picks (and ``route`` if given)."""
    args = tensors(r, qr, xp, krp, bt, lengths, device="cuda", dtype=dtype)
    before = t1_ops.paged_decomposed_decode.launches
    routes = dict(t1_ops.DECODE_ROUTE_LAUNCHES)
    out = t1_ops.paged_decomposed_decode_fwd(*args, scale)
    torch.cuda.synchronize()
    assert t1_ops.paged_decomposed_decode.launches == before + 1
    want = t1_ops.t1_decode_route(dtype, *r.shape[1:], krp.shape[2], qr.shape[-1])
    assert route in (None, want)
    assert _route_moved(t1_ops.DECODE_ROUTE_LAUNCHES, routes) == {
        r_: int(r_ == want) for r_ in routes}
    ref = t1_ops.paged_decomposed_decode_plain(*args, scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)
    assert not out[args[5] == 0].any()  # empty rows -> zeros


# the card only: B3 at the served decode's shape (8 rows over 64 pages of 16:
# 8 key splits of 128 on the tensor-core route), lengths on split
# boundaries, 0 and the full capacity; an MLA-like shape; 8 heads without a
# roped term (a padded head tile); 32 heads in groups of 4 (two head tiles)
CARD_T1_DECODE_CASES = [  # seed, page, nb, B, H, Dm, kv_r, Rr, lengths
    (43, 16, 64, 8, 16, 1024, 16, 32, (0, 1024, 576, 77, 300, 129, 64, 1)),
    (44, 16, 16, 3, 16, 512, 1, 64, (200, 0, 256)),
    (45, 16, 16, 3, 8, 256, 1, 0, (256, 33, 0)),
    (46, 16, 16, 2, 32, 512, 8, 16, (150, 256)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SERVED_T1_DECODE_CASES + CARD_T1_DECODE_CASES)
def test_decomposed_decode_served_rows(cuda, case, dtype, monkeypatch):
    """B3 at the served T1 shape and the route's other shapes: bf16 on the
    tensor cores, float32 on the sweep. The 8-page cases take splits of 64
    keys, so that their rows span two."""
    if case in SERVED_T1_DECODE_CASES:
        monkeypatch.setattr(t1_ops, "TOKEN_SPLIT_KEYS", 64)
    _check_t1_decode(dtype, *served_t1_decode_inputs(*case),
                     route="tensor_core" if dtype == torch.bfloat16 else "sweep")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SERVED_T1_DECODE_CASES + CARD_T1_DECODE_CASES)
def test_decomposed_decode_merge_many_splits(cuda, case, monkeypatch):
    """B3's tensor-core route with splits of 16 keys: the last block of each
    rank merges many partials (64 at the served capacity), and most clusters
    of the short rows lie past their length."""
    monkeypatch.setattr(t1_ops, "TOKEN_KEYS", 16)
    _check_t1_decode(torch.bfloat16, *served_t1_decode_inputs(*case), route="tensor_core")


@pytest.mark.cuda
def test_decomposed_decode_back_to_back_leaves_counters_at_zero(cuda):
    """B3 and B9 launched in a row with split merges, sharing the split
    counters (as consecutive layers, and a CUDA graph of them, run): each
    merges its own rows, and the counters are back at zero after them."""
    outs, refs = [], []
    for case in CARD_T1_DECODE_CASES[:2]:
        r, qr, xp, krp, bt, lengths, scale = served_t1_decode_inputs(*case)
        args = tensors(r, qr, xp, krp, bt, lengths, device="cuda", dtype=torch.bfloat16)
        outs.append(t1_ops.paged_decomposed_decode_fwd(*args, scale))
        refs.append(t1_ops.paged_decomposed_decode_plain(*args, scale))
    for case in (CONTIG_T1_CASES[-1], CONTIG_T1_CASES[3]):
        r, qr, x, kr, length, scale = contig_t1_inputs(*case)
        args = tensors(r, qr, x, kr, device="cuda", dtype=torch.bfloat16)
        outs.append(t1_ops.decomposed_decode_fwd(*args, length, scale))
        refs.append(t1_ops.decomposed_decode_plain(*args, length, scale))
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[torch.bfloat16], rtol=0)
    assert not single_query.counters(1, torch.device("cuda")).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", T1_PREFILL_ALL)
def test_decomposed_prefill_kernel_matches_plain(cuda, case, dtype):
    C = 8 if case in T1_PREFILL_CASES else 16
    kw = {} if C == 8 else dict(page=16, nb=8, C=16)
    r, qr, xp, krp, row, offset, valid, scale = t1_prefill_inputs(*case, **kw)
    _check_t1_prefill(dtype, r, qr, xp, krp, row, offset, valid, scale)


def _check_t1_prefill(dtype, r, qr, xp, krp, row, offset, valid, scale, route=None):
    """B4 on the card against its plain version; the call must move the
    route t1_prefill_route picks (and ``route`` if given)."""
    args = tensors(r, qr, xp, krp, row, device="cuda", dtype=dtype)
    before, routes = t1_ops.paged_decomposed_prefill.launches, dict(t1_ops.ROUTE_LAUNCHES)
    out = t1_ops.paged_decomposed_prefill_fwd(*args, offset, valid, scale)
    torch.cuda.synchronize()
    assert t1_ops.paged_decomposed_prefill.launches == before + 1
    want = t1_ops.t1_prefill_route(dtype, r.shape[-1], qr.shape[-1])
    assert route in (None, want)
    assert _route_moved(t1_ops.ROUTE_LAUNCHES, routes) == {r_: int(r_ == want) for r_ in routes}
    ref = t1_ops.paged_decomposed_prefill_plain(*args, offset, valid, scale)
    torch.testing.assert_close(out[:valid].float(), ref[:valid].float(),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SERVED_T1_PREFILL_CASES)
def test_decomposed_prefill_served_chunks(cuda, case, dtype):
    """B4 on qwen1.5-0.5b's chunks: bf16 on the tensor cores, float32 on the
    sweep."""
    _check_t1_prefill(dtype, *served_t1_prefill_inputs(*case),
                      route="tensor_core" if dtype == torch.bfloat16 else "sweep")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SERVED_T1_PREFILL_CASES)
def test_decomposed_prefill_merge_many_splits(cuda, case, monkeypatch):
    """B4's tensor-core route with splits of one 32-key tile (up to its 8
    splits): the cluster's merge of its splits through distributed shared
    memory, and splits past a tile's keys."""
    monkeypatch.setattr(t1_ops, "CHUNK_SPLIT_KEYS", t1_ops.CHUNK_KEYS)
    _check_t1_prefill(torch.bfloat16, *served_t1_prefill_inputs(*case), route="tensor_core")


T1_WIDE_DM = [(8, 2560, 8, 32), (24, 3072, 8, 32), (32, 4096, 32, 32),
              (64, 8192, 8, 64)]  # H, Dm, kv_r, Rr: qwen3-4b, phi4-mini, opt-6.7b, jamba
# float32 scores over up to 8192 products summed in another order than the
# plain version's: chip_smoke.py's float32 gate, 5e-5 (bf16 as elsewhere)
WIDE_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", T1_WIDE_DM)
def test_decomposed_kernels_take_wide_d_model(cuda, width, dtype):
    """B3, B4 and B9 past d_model 2048, where a block holds fewer rows (held
    to WIDE_TOL)."""
    H, Dm, kv_r, Rr = width
    r, qr, xp, krp, bt, lengths, scale = t1_decode_inputs(11, 16, 4, 2, H, Dm, kv_r, Rr)
    args = tensors(r, qr, xp, krp, bt, lengths, device="cuda", dtype=dtype)
    out = t1_ops.paged_decomposed_decode_fwd(*args, scale)
    torch.cuda.synchronize()
    ref = t1_ops.paged_decomposed_decode_plain(*args, scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=WIDE_TOL[dtype], rtol=0)
    r, qr, xp, krp, row, offset, valid, scale = t1_prefill_inputs(12, 9, 6, H, Dm, kv_r, Rr)
    args = tensors(r, qr, xp, krp, row, device="cuda", dtype=dtype)
    out = t1_ops.paged_decomposed_prefill_fwd(*args, offset, valid, scale)
    torch.cuda.synchronize()
    ref = t1_ops.paged_decomposed_prefill_plain(*args, offset, valid, scale)
    torch.testing.assert_close(out[:valid].float(), ref[:valid].float(), atol=WIDE_TOL[dtype],
                               rtol=0)
    r, qr, x, kr, length, scale = contig_t1_inputs(13, 2, 40, H, Dm, kv_r, Rr, 37)
    args = tensors(r, qr, x, kr, device="cuda", dtype=dtype)
    out = t1_ops.decomposed_decode_fwd(*args, length, scale)
    torch.cuda.synchronize()
    ref = t1_ops.decomposed_decode_plain(*args, length, scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=WIDE_TOL[dtype], rtol=0)


@pytest.mark.cuda
def test_decomposed_wrappers_refuse_bad_inputs(cuda):
    r, qr, xp, krp, bt, lengths, scale = t1_decode_inputs(*T1_DECODE_CASES[0])
    args = tensors(r, qr, xp, krp, bt, lengths, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        t1_ops.paged_decomposed_decode_fwd(*args[:4], args[4].long(), args[5], scale)
    with pytest.raises(ValueError, match="tensors on"):
        t1_ops.paged_decomposed_decode_fwd(*args[:3], args[3].cpu(), *args[4:], scale)
    wide = torch.zeros((1, 4, 16384), device="cuda")
    with pytest.raises(RuntimeError, match="kernel launch failed"):  # Dm > 8192
        t1_ops.paged_decomposed_decode_fwd(wide, args[1][:1], torch.zeros(
            (3, 4, 16384), device="cuda"), args[3][:3], args[4][:1], args[5][:1], scale)


# ---------------------------------------------------------------- T3 / B7


def _scores_close(got, want):
    live = want > -1e29
    assert torch.equal(got[~live], want[~live])
    if live.any():
        err = (got[live] - want[live]).abs().max().item()
        assert err <= 1e-5 * want[live].abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("case", PROXY_CASES)
def test_paged_proxy_scores_kernel_matches_plain(cuda, case):
    q, scale, zero, codes, bt, lengths = (torch.tensor(a, device="cuda")
                                          for a in proxy_inputs(*case))
    n = bt.shape[1] * codes.shape[1]
    before = t3_ops.paged_proxy_scores.launches
    out = t3_ops.paged_proxy_scores(q, scale, zero, codes, bt, lengths, n)
    torch.cuda.synchronize()
    assert t3_ops.paged_proxy_scores.launches == before + 1
    _scores_close(out, t3_ops.paged_proxy_scores_plain(q, scale, zero, codes, bt, lengths, n))
    assert (out[lengths == 0] == -1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONTIG_PROXY_CASES)
def test_contiguous_proxy_scores_kernel_matches_plain(cuda, case):
    seed, B, N, KV, g, Dp, length, _ = case
    qs, qz, codes, length = contig_proxy_inputs(seed, B, N, KV, g, Dp, length)
    qs, qz, codes = (torch.tensor(a, device="cuda") for a in (qs, qz, codes))
    before = t3_ops.proxy_scores.launches
    out = t3_ops.proxy_scores(qs, qz, codes, length)
    torch.cuda.synchronize()
    assert t3_ops.proxy_scores.launches == before + 1
    _scores_close(out, t3_ops.proxy_scores_plain(qs, qz, codes, length))


@pytest.mark.cuda
@pytest.mark.parametrize("q_scale", [None, 0.125])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SERVED_PROXY_CASES)
def test_paged_proxy_scores_fused_matches_plain(cuda, case, dtype, q_scale):
    """The served B7 call, one launch forming the query factors from q in
    its type (as rows of a wider (B, 1, H, 2 Dp) query, the served slice's
    strides) and the slot's tables: against its plain version, at G 1, 3
    and 4, Dp 64 and 128, empty rows and n short of the capacity."""
    q, scale, zero, codes, bt, lengths, n = served_proxy_inputs(*case)
    wide = torch.tensor(np.concatenate([q, q[..., ::-1]], -1)[:, None], device="cuda",
                        dtype=dtype)
    qv = wide[:, 0, :, :q.shape[-1]]                      # rows at the wide stride
    scale, zero, codes, bt, lengths = (torch.tensor(a, device="cuda")
                                       for a in (scale, zero, codes, bt, lengths))
    before = t3_ops.paged_proxy_scores.launches
    out = t3_ops.paged_proxy_scores(qv, scale, zero, codes, bt, lengths, n, q_scale=q_scale)
    torch.cuda.synchronize()
    assert t3_ops.paged_proxy_scores.launches == before + 1
    q_eff = qv if q_scale is None else qv * q_scale
    _scores_close(out, t3_ops.paged_proxy_scores_plain(q_eff, scale, zero, codes, bt,
                                                       lengths, n))
    assert (out[lengths == 0] == -1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONTIG_PROXY_CASES)
def test_proxy_scores_q_fused_matches_plain(cuda, case):
    """The static T3 decode's ``proxy_scores_q``: one launch forming the
    factors over contiguous codes, counted under ``proxy_scores``, with the
    length on the host and on the card."""
    seed, B, N, KV, g, Dp, length, _ = case
    rng = np.random.default_rng(seed)
    q = torch.tensor((rng.normal(size=(B, KV * g, Dp)) * 0.1).astype(np.float32),
                     device="cuda")
    scale, zero = (torch.tensor(a, device="cuda") for a in proxy_tables(rng, B, KV, Dp))
    codes = torch.tensor(rng.integers(-128, 128, size=(B, N, KV, Dp)).astype(np.int8),
                         device="cuda")
    qs, qz = t3_ops.query_factors(q, scale, zero)
    want = t3_ops.proxy_scores_plain(qs, qz, codes, length).reshape(B, KV * g, N)
    for ln in (length, torch.tensor(length, dtype=torch.int32),
               torch.tensor(length, device="cuda")):
        before = t3_ops.proxy_scores.launches
        out = t3_ops.proxy_scores_q(q, scale, zero, codes, ln)
        torch.cuda.synchronize()
        assert t3_ops.proxy_scores.launches == before + 1
        _scores_close(out, want)


@pytest.mark.cuda
def test_proxy_scores_wrappers_refuse_bad_inputs(cuda):
    q, scale, zero, codes, bt, lengths = (torch.tensor(a, device="cuda")
                                          for a in proxy_inputs(*PROXY_CASES[0]))
    n = bt.shape[1] * codes.shape[1]
    with pytest.raises(ValueError, match="Dp"):            # 8 proxy channels
        t3_ops.paged_proxy_scores(q[..., :8].contiguous(), scale[..., :8].contiguous(),
                                  zero[..., :8].contiguous(), codes[..., :8].contiguous(),
                                  bt, lengths, n)
    with pytest.raises(TypeError):                        # int32 codes
        t3_ops.paged_proxy_scores(q, scale, zero, codes.int(), bt, lengths, n)
    with pytest.raises(TypeError):                        # int64 block table
        t3_ops.paged_proxy_scores(q, scale, zero, codes, bt.long(), lengths, n)
    with pytest.raises(ValueError):                       # a CPU block table
        t3_ops.paged_proxy_scores(q, scale, zero, codes, bt.cpu(), lengths, n)
    with pytest.raises(ValueError):                       # n past the table
        t3_ops.paged_proxy_scores(q, scale, zero, codes, bt, lengths, n + 1)
    with pytest.raises(TypeError):                        # bf16 proxy tables
        t3_ops.paged_proxy_scores(q, scale.bfloat16(), zero, codes, bt, lengths, n)
    with pytest.raises(ValueError):                       # lengths of another batch
        t3_ops.paged_proxy_scores(q, scale, zero, codes, bt, lengths[:-1], n)
    with pytest.raises(ValueError):                       # lengths on the host
        t3_ops.paged_proxy_scores(q, scale, zero, codes, bt, lengths.cpu(), n)
    with pytest.raises(ValueError):                       # q of other channels than the codes
        t3_ops.paged_proxy_scores(q[..., :8].contiguous(), scale, zero, codes, bt, lengths, n)
    qs, qz, cont, length = contig_proxy_inputs(*CONTIG_PROXY_CASES[0][:-1])
    qs, qz, cont = (torch.tensor(a, device="cuda") for a in (qs, qz, cont))
    with pytest.raises(ValueError):                       # qz without its trailing 1
        t3_ops.proxy_scores(qs, qz[..., 0], cont, length)
    with pytest.raises(TypeError):                        # float64 factors
        t3_ops.proxy_scores(qs.double(), qz, cont, length)
    for g in (3, 12):            # served: G = 3 (phi4-mini) and a runtime G past 8
        qs, qz, codes, length = contig_proxy_inputs(5, 2, 70, 2, g, 32, 61)
        qs, qz, codes = (torch.tensor(a, device="cuda") for a in (qs, qz, codes))
        out = t3_ops.proxy_scores(qs, qz, codes, length)
        torch.cuda.synchronize()
        _scores_close(out, t3_ops.proxy_scores_plain(qs, qz, codes, length))


# ------------------------------------------------- contiguous: B8, B9, B10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    """B8, causal or not, on k and v that are a prefix of a longer arena."""
    q, k, v, scale = flash_inputs(*case)
    S, causal = case[3], case[7]
    q, k, v = tensors(q, k, v, device="cuda", dtype=dtype)
    k, v = k[:, :S], v[:, :S]
    before = fa_ops.flash_attention.launches
    routes = dict(fa_ops.ROUTE_LAUNCHES)
    out = fa_ops.flash_attention(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    route = ("decode" if q.shape[1] == 1 else "prompt" if dtype == torch.bfloat16
             else "prompt_f32")
    assert {r: n - routes[r] for r, n in fa_ops.ROUTE_LAUNCHES.items()} == {
        r: int(r == route) for r in routes}
    ref = fa_ops.flash_attention_plain(q, k, v, scale, causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
def test_flash_attention_prompt_route_by_dtype(cuda):
    """A bf16 prompt moves the tensor-core route's counter and not the
    float32 sweep's; a float32 prompt the other way round."""
    q, k, v, scale = flash_inputs(*FLASH_CASES[0])
    for dtype, route, other in ((torch.bfloat16, "prompt", "prompt_f32"),
                                (torch.float32, "prompt_f32", "prompt")):
        before = dict(fa_ops.ROUTE_LAUNCHES)
        fa_ops.flash_attention(*tensors(q, k, v, device="cuda", dtype=dtype), scale, True)
        torch.cuda.synchronize()
        assert fa_ops.ROUTE_LAUNCHES[route] == before[route] + 1
        assert fa_ops.ROUTE_LAUNCHES[other] == before[other]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONTIG_T1_CASES)
def test_contiguous_decomposed_decode_kernel_matches_plain(cuda, case, dtype):
    _check_t1_contig(dtype, *contig_t1_inputs(*case))


def _check_t1_contig(dtype, r, qr, x, kr, length, scale, route=None):
    """B9 on the card against its plain version; the call must move the
    route t1_decode_route picks (and ``route`` if given)."""
    args = tensors(r, qr, x, kr, device="cuda", dtype=dtype)
    before, routes = t1_ops.decomposed_decode.launches, dict(t1_ops.CONTIG_ROUTE_LAUNCHES)
    out = t1_ops.decomposed_decode_fwd(*args, length, scale)
    torch.cuda.synchronize()
    assert t1_ops.decomposed_decode.launches == before + 1
    want = t1_ops.t1_decode_route(dtype, *r.shape[1:], kr.shape[2], qr.shape[-1])
    assert route in (None, want)
    assert _route_moved(t1_ops.CONTIG_ROUTE_LAUNCHES, routes) == {
        r_: int(r_ == want) for r_ in routes}
    ref = t1_ops.decomposed_decode_plain(*args, length, scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)


# the card only: B9 at the static decode's shape (8 rows, N 576, length
# 575), 8 heads without a roped term (a padded head tile), 32 heads in
# groups of 4 (two head tiles), length 0
CARD_CONTIG_T1_CASES = [  # seed, B, N, H, Dm, kv_r, Rr, length
    (8, 8, 576, 16, 1024, 16, 32, 575),
    (9, 3, 200, 8, 256, 1, 0, 150),
    (10, 2, 300, 32, 512, 8, 16, 257),
    (11, 2, 40, 16, 1024, 16, 32, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CONTIG_T1_CASES + CONTIG_T1_CASES[-1:])
def test_contiguous_decomposed_decode_route(cuda, case, dtype, monkeypatch):
    """B9 at the static decode's shape and the route's other shapes: bf16 on
    the tensor cores, float32 on the sweep; then, in bf16, with splits of
    16 keys (many partials merged by the last block of each rank)."""
    route = "tensor_core" if dtype == torch.bfloat16 else "sweep"
    _check_t1_contig(dtype, *contig_t1_inputs(*case), route=route)
    if dtype == torch.bfloat16:
        monkeypatch.setattr(t1_ops, "TOKEN_KEYS", 16)
        _check_t1_contig(dtype, *contig_t1_inputs(*case), route=route)


@pytest.mark.cuda
@pytest.mark.parametrize("round_tiles", [False, True])
@pytest.mark.parametrize("case", CONTIG_CPQ_CASES)
def test_contiguous_cpq_decode_kernel_matches_plain(cuda, case, round_tiles):
    """B10 with dequantized tiles in float32 (the TPU kernel's function) and
    rounded to bf16 (the static engine's); pruned codes dequantize to 0."""
    q, kt, vt, length, scale = contig_cpq_inputs(*case)
    (ck, lk, sk, zk), (cv, lv, sv, zv) = ([torch.tensor(a, device="cuda") for a in t]
                                          for t in (kt, vt))
    args = (torch.tensor(q, device="cuda"), ck, cv, sk, zk, sv, zv, lk, lv)
    before = cpq_ops.cpq_decode.launches
    out = cpq_ops.cpq_decode_fwd(*args, length, scale, round_tiles)
    torch.cuda.synchronize()
    assert cpq_ops.cpq_decode.launches == before + 1
    ref = cpq_ops.cpq_decode_plain(*args, length, scale, round_tiles)
    torch.testing.assert_close(out, ref, atol=CPQ_TOL[torch.float32], rtol=0)


@pytest.mark.cuda
def test_contiguous_cpq_decode_contract(cuda):
    """B10's contract beyond the cases: a level outside [0, L) reads 0, a
    stored -128 everywhere gives exactly 0, a length of 0 gives zeros, and
    G past the kernel's 4 heads per block (gemma-2b: 8 over one kv head at
    Dh 256) runs in head groups."""
    q, kt, vt, length, scale = contig_cpq_inputs(3, 2, 90, 1, 8, 256, 4, 77)
    kt[1][0] = np.where(np.arange(90)[:, None] % 3 == 0, 9, kt[1][0])  # levels past L
    (ck, lk, sk, zk), (cv, lv, sv, zv) = ([torch.tensor(a, device="cuda") for a in t]
                                          for t in (kt, vt))
    qt = torch.tensor(q, device="cuda")
    for n in (length, 0):
        out = cpq_ops.cpq_decode_fwd(qt, ck, cv, sk, zk, sv, zv, lk, lv, n, scale, True)
        torch.cuda.synchronize()
        ref = cpq_ops.cpq_decode_plain(qt, ck, cv, sk, zk, sv, zv, lk, lv, n, scale, True)
        torch.testing.assert_close(out, ref, atol=CPQ_TOL[torch.float32], rtol=0)
    assert not out.any()
    pruned = cpq_ops.cpq_decode_fwd(qt, ck, torch.full_like(cv, -128), sk, zk, sv, zv, lk, lv,
                                    length, scale, True)
    torch.cuda.synchronize()
    assert not pruned.any()


@pytest.mark.cuda
def test_contiguous_wrappers_refuse_bad_inputs(cuda):
    q, k, v, scale = (torch.tensor(a, device="cuda") if isinstance(a, np.ndarray) else a
                      for a in flash_inputs(*FLASH_CASES[5]))
    heads_outer = k.transpose(1, 2).contiguous().transpose(1, 2)  # (B, S, KV, D), KV outer
    with pytest.raises(ValueError, match="dense"):
        fa_ops.flash_attention(q, heads_outer, v, scale, False)
    with pytest.raises(TypeError, match="mixed"):
        fa_ops.flash_attention(q, k.to(torch.bfloat16), v, scale, False)
    r, qr, x, kr, length, scale = (torch.tensor(a, device="cuda") if isinstance(a, np.ndarray)
                                   else a for a in contig_t1_inputs(*CONTIG_T1_CASES[0]))
    with pytest.raises(ValueError, match="length"):
        t1_ops.decomposed_decode_fwd(r, qr, x, kr, x.shape[1] + 1, scale)
    q, kt, vt, length, scale = contig_cpq_inputs(*CONTIG_CPQ_CASES[0])
    (ck, lk, sk, zk), (cv, lv, sv, zv) = ([torch.tensor(a, device="cuda") for a in t]
                                          for t in (kt, vt))
    with pytest.raises(TypeError):                       # int32 codes
        cpq_ops.cpq_decode_fwd(torch.tensor(q, device="cuda"), ck.int(), cv, sk, zk, sv, zv,
                               lk, lv, length, scale)
