"""Paged-attention kernels: B1 ``paged_decode`` and B2 ``paged_prefill``."""
from repro_torch.kernels.paged_attn.ops import (paged_decode, paged_decode_plain,
                                                paged_prefill, paged_prefill_plain)

__all__ = ["paged_decode", "paged_decode_plain", "paged_prefill",
           "paged_prefill_plain"]
