"""Paged KV arenas, scheduler, policies, seeded sampling, speculative
decoding, serving traces and the engines."""
