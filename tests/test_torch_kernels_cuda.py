"""The port's CUDA paged-attention kernels against their plain PyTorch
versions, on the layouts of the CPU tests, in float32 and bfloat16. Needs an
NVIDIA GPU and nvcc; skips elsewhere. JAX-free, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances (max abs): 1e-5 in float32 (both compute in float32 and differ in
summation order only), 2e-2 in bfloat16 (one bf16 rounding step of an output
below 4 in magnitude).
"""
import pytest
import torch

from repro_torch.kernels.paged_attn import ops
from torch_paged_cases import DECODE_CASES, PREFILL_CASES, decode_inputs, prefill_inputs, tensors

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


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
    before = ops.paged_decode.launches
    out = ops.paged_decode(*args, scale)
    torch.cuda.synchronize()
    assert ops.paged_decode.launches == before + 1
    ref = ops.paged_decode_plain(*args, scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)
    assert not out[args[4] == 0].any()  # empty rows -> zeros


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_kernel_matches_plain(cuda, case, dtype):
    q, kp, vp, row, offset, valid, scale = prefill_inputs(*case)
    args = tensors(q, kp, vp, row, device="cuda", dtype=dtype)
    before = ops.paged_prefill.launches
    out = ops.paged_prefill(*args, offset, valid, scale)
    torch.cuda.synchronize()
    assert ops.paged_prefill.launches == before + 1
    ref = ops.paged_prefill_plain(*args, offset, valid, scale)
    torch.testing.assert_close(out[0, :valid].float(), ref[0, :valid].float(),
                               atol=TOL[dtype], rtol=0)


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
