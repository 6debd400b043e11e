"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. ``build.py`` compiles the sources in ``*/csrc`` with ``nvcc`` on
first use; ``paged_attn/`` holds the paged-attention kernels of the main
serving path."""
