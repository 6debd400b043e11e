"""T1 decomposed-attention kernels: B3 ``paged_decomposed_decode``, B4
``paged_decomposed_prefill`` and B9 ``decomposed_decode``."""
from repro_torch.kernels.decomposed_attn.ops import (
    decomposed_decode, decomposed_decode_fwd, decomposed_decode_plain,
    paged_decomposed_decode, paged_decomposed_decode_fwd, paged_decomposed_decode_plain,
    paged_decomposed_prefill, paged_decomposed_prefill_fwd, paged_decomposed_prefill_plain)

__all__ = ["decomposed_decode", "decomposed_decode_fwd", "decomposed_decode_plain",
           "paged_decomposed_decode", "paged_decomposed_decode_fwd",
           "paged_decomposed_decode_plain", "paged_decomposed_prefill",
           "paged_decomposed_prefill_fwd", "paged_decomposed_prefill_plain"]
