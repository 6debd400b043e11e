"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. ``build.py`` compiles the sources in ``*/csrc`` with ``nvcc`` on
first use; ``paged_attn/`` holds the paged-attention kernels of the dense
tier, ``flash_attn/`` the contiguous flash kernel of every contiguous prefill
and of the static dense decode (a tensor-core route for bf16 prompts, a
CUDA-core sweep for float32 ones, and the single-query decode whose header
``single_query.cuh`` B10 shares; ``single_query.py`` plans its splits),
``decomposed_attn/`` the T1 kernels, which
sweep X pages or a contiguous X arena, ``cpq_attn/`` those that attend
straight over the T2 tier's int8 CPQ codes (paged or contiguous), and
``topk_retrieval/`` the T3 proxy-scoring sweep over int8 key codes."""
