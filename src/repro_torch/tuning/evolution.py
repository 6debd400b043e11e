"""Seeded, resumable μ+λ evolutionary Pareto search over a ``KnobSpace``
(the JAX package's ``tuning/evolution.py``: the same proposals from the
same seed, and the same JSON checkpoint, so a checkpoint written by either
package resumes in the other).

Shape of the loop (budget counted in EVALUATIONS, not generations):

  * seeding: evaluation 0 is always the hand-tuned default genome — the
    frontier therefore dominates-or-ties the baseline on every axis by
    construction, which is what lets presets claim "no worse than the
    hand-tuned default on its own objective". Evaluations 1..μ-1 are
    uniform random samples.
  * generations: λ offspring per generation, each bred from the μ
    survivors of all evaluations before the generation boundary
    (non-dominated sort, lexicographic tie-break) by crossover of two
    distinct survivors (prob ``crossover_p``, needs >= 2) or mutation of
    one. Duplicate genomes are skipped via the evaluation memo (re-used,
    never re-evaluated) so a tiny space cannot stall the loop.

Determinism and resume: the only randomness is ``np.random.default_rng
(seed)``, proposals depend solely on (records-so-far, rng state), and the
JSON checkpoint stores both after EVERY evaluation — so resuming from a
checkpoint continues bit-identically with a fresh process, and re-running
the same seed reproduces the identical record sequence and frontier.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np

from repro_torch.tuning.frontier import hypervolume, non_dominated_sort, pareto_front
from repro_torch.tuning.space import Knob, KnobSpace

CHECKPOINT_VERSION = 1


@dataclasses.dataclass
class EvalRecord:
    genome: dict
    objectives: tuple[float, ...]
    metrics: dict


def _space_signature(space: KnobSpace) -> dict:
    return {
        "max_len": space.max_len,
        "budget_slots": space.budget_slots,
        "budget_page": space.budget_page,
        "knobs": [[k.name, list(k.choices)] for k in space.knobs],
    }


class ParetoSearch:
    """``search = ParetoSearch(space, evaluate, seed=0); front =
    search.run(budget)``. ``evaluate(genome) -> (objectives, metrics)``
    must be deterministic (same genome -> same objectives) for the memo,
    checkpoint, and reproducibility contracts to hold."""

    def __init__(self, space: KnobSpace,
                 evaluate: Callable[[dict], tuple],
                 *, seed: int = 0, mu: int = 6, lam: int = 6,
                 mutate_p: float = 0.35, crossover_p: float = 0.5,
                 checkpoint: Optional[str] = None):
        assert mu >= 1 and lam >= 1
        self.space = space
        self.evaluate = evaluate
        self.seed = int(seed)
        self.mu, self.lam = int(mu), int(lam)
        self.mutate_p, self.crossover_p = float(mutate_p), float(crossover_p)
        self.checkpoint = checkpoint
        self.rng = np.random.default_rng(self.seed)
        self.records: list[EvalRecord] = []
        self.seen: dict[tuple, EvalRecord] = {}
        if checkpoint and os.path.exists(checkpoint):
            self.load(checkpoint)

    # ------------------------------------------------------------ the loop

    def run(self, budget: int) -> list[EvalRecord]:
        """Evaluate until ``len(records) == budget``; returns the frontier.
        Safe to call again with a larger budget (continues), or after
        constructing with an existing checkpoint (resumes)."""
        while len(self.records) < budget:
            genome = self._propose()
            key = self.space.genome_key(genome)
            if key in self.seen:
                # memo hit (space smaller than the budget): record the
                # cached result — budget still advances, nothing re-runs
                prev = self.seen[key]
                rec = EvalRecord(dict(genome), tuple(prev.objectives),
                                 dict(prev.metrics))
            else:
                objectives, metrics = self.evaluate(genome)
                rec = EvalRecord(dict(genome),
                                 tuple(float(x) for x in objectives),
                                 dict(metrics))
                self.seen[key] = rec
            self.records.append(rec)
            if self.checkpoint:
                self.save(self.checkpoint)
        return self.frontier()

    def _propose(self) -> dict:
        n = len(self.records)
        if n == 0:
            return self.space.default_genome()
        if n < self.mu:
            return self._fresh()
        # generation boundary: parents are the μ survivors of everything
        # evaluated before it (deterministic from the records list, so a
        # resumed process re-derives the same parent set)
        boundary = self.mu + ((n - self.mu) // self.lam) * self.lam
        parents = self.survivors(self.records[:boundary])
        for _ in range(64):
            if len(parents) >= 2 and self.rng.random() < self.crossover_p:
                i = int(self.rng.integers(len(parents)))
                j = int(self.rng.integers(len(parents) - 1))
                j += j >= i
                child = self.space.crossover(parents[i].genome,
                                             parents[j].genome, self.rng)
            else:
                p = parents[int(self.rng.integers(len(parents)))]
                child = self.space.mutate(p.genome, self.rng, self.mutate_p)
            if self.space.genome_key(child) not in self.seen:
                return child
        return self._fresh()

    def _fresh(self) -> dict:
        for _ in range(256):
            g = self.space.sample(self.rng)
            if self.space.genome_key(g) not in self.seen:
                return g
        return g  # space exhausted: duplicate, resolved via the memo

    # ------------------------------------------------------------ selection

    def survivors(self, records: list[EvalRecord]) -> list[EvalRecord]:
        """μ+λ survivor selection: flatten the non-dominated fronts, order
        within a front by (objectives, genome key) — fully deterministic —
        and keep the first μ distinct genomes."""
        objs = [r.objectives for r in records]
        out, used = [], set()
        for front in non_dominated_sort(objs):
            ranked = sorted(front, key=lambda i: (
                records[i].objectives,
                self.space.genome_key(records[i].genome)))
            for i in ranked:
                key = self.space.genome_key(records[i].genome)
                if key not in used:
                    used.add(key)
                    out.append(records[i])
                if len(out) >= self.mu:
                    return out
        return out

    def frontier(self) -> list[EvalRecord]:
        """Non-dominated records, distinct by genome, deterministically
        ordered by (objectives, genome key)."""
        objs = [r.objectives for r in self.records]
        keep = [self.records[i] for i in pareto_front(objs)]
        out, used = [], set()
        for r in sorted(keep, key=lambda r: (
                r.objectives, self.space.genome_key(r.genome))):
            key = self.space.genome_key(r.genome)
            if key not in used:
                used.add(key)
                out.append(r)
        return out

    def frontier_hypervolume(self) -> float:
        """Hypervolume of the current frontier against the nadir of ALL
        evaluated points (worst per axis, nudged out so every frontier
        point contributes) — comparable across runs of the same trace."""
        if not self.records:
            return 0.0
        objs = [r.objectives for r in self.records]
        ref = [max(o[i] for o in objs) + 1e-9 + 0.05 * (
            max(o[i] for o in objs) - min(o[i] for o in objs))
            for i in range(len(objs[0]))]
        return hypervolume([r.objectives for r in self.frontier()], ref)

    def baseline(self) -> EvalRecord:
        """The seeded hand-tuned default's evaluation (record 0)."""
        assert self.records, "run() first"
        return self.records[0]

    # ---------------------------------------------------------- checkpoint

    def save(self, path: str) -> None:
        doc = {
            "version": CHECKPOINT_VERSION,
            "seed": self.seed,
            "mu": self.mu, "lam": self.lam,
            "mutate_p": self.mutate_p, "crossover_p": self.crossover_p,
            "space": _space_signature(self.space),
            "rng_state": self.rng.bit_generator.state,
            "records": [{"genome": r.genome,
                         "objectives": list(r.objectives),
                         "metrics": r.metrics} for r in self.records],
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("version") != CHECKPOINT_VERSION:
            raise ValueError(f"checkpoint {path}: unsupported version "
                             f"{doc.get('version')!r}")
        for field in ("seed", "mu", "lam", "mutate_p", "crossover_p"):
            if doc[field] != getattr(self, field):
                raise ValueError(
                    f"checkpoint {path}: {field}={doc[field]!r} does not "
                    f"match this search ({getattr(self, field)!r}) — resume "
                    "with identical search parameters or delete the file")
        if doc["space"] != _space_signature(self.space):
            raise ValueError(
                f"checkpoint {path}: knob space changed since the "
                "checkpoint was written — evaluated points would be "
                "incomparable; delete the file to start fresh")
        self.records = []
        self.seen = {}
        for r in doc["records"]:
            genome = self.space.validate_and_repair(r["genome"])
            rec = EvalRecord(genome, tuple(r["objectives"]), r["metrics"])
            self.records.append(rec)
            self.seen.setdefault(self.space.genome_key(genome), rec)
        self.rng.bit_generator.state = doc["rng_state"]


def make_space_from_signature(sig: dict) -> KnobSpace:
    """Rebuild a ``KnobSpace`` from a checkpoint's space signature."""
    return KnobSpace(
        max_len=sig["max_len"], budget_slots=sig["budget_slots"],
        budget_page=sig["budget_page"],
        knobs=tuple(Knob(name, tuple(ch)) for name, ch in sig["knobs"]))
