"""The route a chunked prefill takes on the card, chosen before the launch
from dtype and widths (and, for B6, the tables' levels): B2
``paged_prefill`` and B6 ``paged_cpq_prefill`` run bf16 chunks whose Dh and
Dv are multiples of 8 up to 256 on the tensor-core kernel
(``paged_attn/csrc/paged_chunk.cuh``) and everything else on the CUDA-core
sweep. The choice is a plain function, so it is tested here without a card;
``test_torch_kernels_cuda.py`` checks on the card that each call moves its
route's counter."""
import pytest
import torch

from repro_torch.kernels.cpq_attn import ops as cpq_ops
from repro_torch.kernels.paged_attn import ops

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


def test_route_counters_name_both_routes():
    assert set(ops.ROUTE_LAUNCHES) == set(cpq_ops.ROUTE_LAUNCHES) == {"tensor_core", "sweep"}


def test_cpu_tensors_take_no_route():
    """On the CPU the wrappers run their plain versions: no route counter
    moves, whatever the dtype."""
    before, cpq_before = dict(ops.ROUTE_LAUNCHES), dict(cpq_ops.ROUTE_LAUNCHES)
    q = torch.randn(1, 4, 2, 16, dtype=BF16)
    kp = torch.randn(3, 4, 2, 16, dtype=BF16)
    ops.paged_prefill(q, kp, kp, torch.tensor([1, 2], dtype=torch.int32), 2, 3, 0.25)
    assert ops.ROUTE_LAUNCHES == before and cpq_ops.ROUTE_LAUNCHES == cpq_before
