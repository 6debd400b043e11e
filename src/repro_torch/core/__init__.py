"""Reference (plain PyTorch) attention and the T2 CPQ compression."""
