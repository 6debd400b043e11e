"""Deterministic, stateless-seekable synthetic LM data (the JAX package's
``data/pipeline.py``, numpy only, so that it runs where JAX is absent).

``batch(step)`` is a pure function of (seed, step, data config) and gives
the reference's arrays for the same seed: no iterator state to checkpoint,
and a resumed run replays the batches k, k+1, ... exactly. A background
thread prefetches ``prefetch`` steps ahead.

The token stream is a Zipf-ish categorical over the vocab with a repeating
bigram structure, so next-token loss is learnable with no corpus.
``make_batch_specs`` gives a batch's PartitionSpecs over a mesh (its rows
over the batch axes), which the training mesh splits it by.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.configs import ModelConfig, ShapeCfg


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    ngram: int = 8          # repeated-structure period (learnability)
    zipf_a: float = 1.2     # token frequency skew
    prefetch: int = 2


class SyntheticLMData:
    def __init__(self, cfg: ModelConfig, shape: ShapeCfg, dcfg: DataConfig = DataConfig()):
        self.cfg, self.shape, self.dcfg = cfg, shape, dcfg
        v = cfg.vocab_size
        rng = np.random.default_rng(dcfg.seed)
        # fixed Zipf-ish unigram table + deterministic bigram successor table:
        # token t is followed by succ[t] with prob .6, else unigram sample
        p = 1.0 / np.arange(1, v + 1) ** dcfg.zipf_a
        self._p = (p / p.sum()).astype(np.float64)
        self._succ = rng.permutation(v).astype(np.int64)

    def batch(self, step: int) -> dict:
        """Pure function of step -> {'tokens','labels'[, 'frames'|'patches']}."""
        cfg, shape = self.cfg, self.shape
        B, S = shape.global_batch, shape.seq_len
        rng = np.random.default_rng((self.dcfg.seed, step))
        v = cfg.vocab_size
        base = rng.choice(v, size=(B, S), p=self._p)
        follow = rng.random((B, S)) < 0.6
        toks = base.copy()
        for t in range(1, S):
            toks[:, t] = np.where(follow[:, t], self._succ[toks[:, t - 1]], base[:, t])
        out = {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}
        if cfg.input_kind == "audio_frames":
            # EnCodec frontend stub: frame embedding = code-conditioned noise
            emb = rng.standard_normal((v, 8)).astype(np.float32)
            proj = rng.standard_normal((8, cfg.d_model)).astype(np.float32) * 0.1
            out["frames"] = (emb[toks] @ proj).astype(np.float32)
            del out["tokens"]
        if cfg.input_kind == "text+patches":
            out["patches"] = rng.standard_normal(
                (B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32) * 0.02
        return out

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, step: int) -> Iterator[dict]:
        """Prefetching iterator starting at ``step`` (resume point)."""
        q: queue.Queue = queue.Queue(maxsize=max(self.dcfg.prefetch, 1))
        stop = threading.Event()

        def producer():
            s = step
            while not stop.is_set():
                try:
                    q.put(self.batch(s), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def make_batch_specs(cfg: ModelConfig, batch: dict, batch_axes: tuple):
    """PartitionSpecs matching a concrete batch dict: rows over
    ``batch_axes``, the other dimensions whole."""
    from repro_torch.distributed.sharding import PartitionSpec as P
    b = batch_axes if batch_axes else None
    return {k: P(b, *([None] * (a.ndim - 1))) for k, a in batch.items()}
