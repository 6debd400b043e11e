"""Reference (plain PyTorch) attention."""
