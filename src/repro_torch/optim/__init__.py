from repro_torch.optim.compression import compress_int8, decompress_int8  # noqa: F401
from repro_torch.optim.optimizers import (  # noqa: F401
    AdafactorState, AdamWState, Optimizer, adafactor, adamw, apply_updates,
    clip_by_global_norm)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
