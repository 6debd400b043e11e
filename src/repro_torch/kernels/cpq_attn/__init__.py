"""T2 attention over CPQ code pages: B5 ``paged_cpq_decode`` and B6
``paged_cpq_prefill``."""
from repro_torch.kernels.cpq_attn.ops import (paged_cpq_decode, paged_cpq_decode_plain,
                                              paged_cpq_prefill, paged_cpq_prefill_plain)

__all__ = ["paged_cpq_decode", "paged_cpq_decode_plain", "paged_cpq_prefill",
           "paged_cpq_prefill_plain"]
