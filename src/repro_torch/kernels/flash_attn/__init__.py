"""Contiguous flash-attention kernel: B8 ``flash_attention``."""
from repro_torch.kernels.flash_attn.ops import flash_attention, flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain"]
