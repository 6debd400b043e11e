from repro_torch.optim.compression import (  # noqa: F401
    compress_int8, compressed_psum, decompress_int8)
from repro_torch.optim.optimizers import (  # noqa: F401
    AdafactorState, AdamWState, Optimizer, adafactor, adamw, apply_updates,
    clip_by_global_norm)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
