"""Model layers, attention layer, layer dispatch and the full model."""
