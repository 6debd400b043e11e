"""Paged KV arenas, scheduler, policies and the continuous engine."""
