"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. ``build.py`` compiles the sources in ``*/csrc`` with ``nvcc`` on
first use; ``paged_attn/`` holds the paged-attention kernels of the dense
tier, ``decomposed_attn/`` those of the T1 tier, which sweep its X pages,
``cpq_attn/`` those that attend straight over the T2 tier's int8 CPQ code
pages, and ``topk_retrieval/`` the T3 proxy-scoring sweep over int8 key-code
pages."""
