"""T1 decomposed-attention kernels: B3 ``paged_decomposed_decode`` and B4
``paged_decomposed_prefill``."""
from repro_torch.kernels.decomposed_attn.ops import (
    paged_decomposed_decode, paged_decomposed_decode_fwd, paged_decomposed_decode_plain,
    paged_decomposed_prefill, paged_decomposed_prefill_fwd, paged_decomposed_prefill_plain)

__all__ = ["paged_decomposed_decode", "paged_decomposed_decode_fwd",
           "paged_decomposed_decode_plain", "paged_decomposed_prefill",
           "paged_decomposed_prefill_fwd", "paged_decomposed_prefill_plain"]
