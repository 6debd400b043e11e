"""PyTorch/CUDA port of the JAX package ``repro``.

The port serves qwen-style decoders on an NVIDIA GPU through two engines:
the continuous-batching ``ContinuousServeEngine`` over paged arenas
(chunked or one-shot admission; dense, T1 decomposed, T2 CPQ, T3 retrieval
and tiered) and the static ``ServeEngine`` over contiguous arenas (dense,
T1, T2, T3). Their attention runs in hand-written CUDA kernels
(``kernels/paged_attn`` and ``kernels/flash_attn``, ``kernels/decomposed_attn``,
``kernels/cpq_attn``, ``kernels/topk_retrieval``); every module keeps the
name of its JAX counterpart. It imports nothing of ``repro`` or ``jax``: the JAX package is
the reference the port's tests hold it against.
"""
from repro_torch.configs import (ARCHS, AttentionRuntime, ModelConfig, ServingCfg,
                                 get_config, smoke_config)
from repro_torch.params import from_jax, init_params
from repro_torch.serving.engine import ContinuousServeEngine, GenerationConfig, ServeEngine
from repro_torch.serving.request import RequestOutput, SamplingParams, ServeRequest
from repro_torch.serving.scheduler import Request, SchedulerConfigError

__all__ = [
    "ARCHS", "AttentionRuntime", "ContinuousServeEngine", "GenerationConfig",
    "ModelConfig", "Request", "RequestOutput", "SamplingParams",
    "SchedulerConfigError", "ServeEngine", "ServeRequest", "ServingCfg", "from_jax",
    "get_config", "init_params", "smoke_config",
]
