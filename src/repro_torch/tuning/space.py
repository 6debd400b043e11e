"""Typed knob space over ``ServingCfg`` for the port's serving auto-tuner
(the JAX package's ``tuning/space.py``; the same genomes from the same
``np.random.Generator`` state).

A *genome* is a plain dict of knob name -> value, drawn from per-knob
categorical choice sets (every knob the engine exposes behaves like an
operating-point selector, so categorical choices keep mutation/crossover
trivially deterministic and the evaluation memo exact). Capacity fields
(``num_pages`` / ``max_blocks_per_slot`` / ``escalated_pages``) are NOT
genes: they are derived from a FIXED token budget (the hand-tuned baseline
arena, ``equal_arena_serving(budget_slots, max_len, budget_page)``), so the
search cannot win throughput by simply provisioning more memory — every
genome serves the trace from the same arena bytes, and ``num_slots`` trades
parallelism against oversubscription/preemption instead.

``validate_and_repair`` maps ANY dict into the space: unknown knobs are
dropped, missing knobs filled from the hand-tuned default, off-choice values
snapped to the nearest choice, and cross-knob constraints (watermark
ordering) repaired — never raised. The repaired genome always materializes
into a ``ServingCfg`` that passes ``ServingCfg.validate()``: prefill chunks
are page-aligned BY CONSTRUCTION (the gene is ``chunk_pages``, the chunk
length in pages, so ``prefill_chunk = chunk_pages * page_size`` can never
misalign), and speculation is always paired with chunked admission
(``chunk_pages >= 1``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs import ServingCfg
from repro_torch.serving.paged_cache import pages_needed


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    choices: tuple

    def snap(self, value):
        """Nearest in-space choice (numeric by distance; everything else
        falls back to exact membership, else the first choice)."""
        if value in self.choices and not isinstance(value, bool):
            return value
        if isinstance(value, bool):
            return value if value in self.choices else self.choices[0]
        if isinstance(value, (int, float)) and all(
                isinstance(c, (int, float)) for c in self.choices):
            return min(self.choices, key=lambda c: (abs(c - value), c))
        return self.choices[0]


DEFAULT_KNOBS: tuple[Knob, ...] = (
    Knob("num_slots", (2, 4, 6, 8)),
    Knob("page_size", (4, 8, 16)),
    # prefill chunk length IN PAGES: prefill_chunk = chunk_pages * page_size
    # is page-aligned by construction (the repair the ISSUE names)
    Knob("chunk_pages", (1, 2, 4)),
    Knob("policy", ("fifo", "priority", "slo")),
    Knob("low_watermark", (0.1, 0.25, 0.4)),
    Knob("critical_watermark", (0.02, 0.05, 0.1, 0.25)),
    Knob("high_watermark", (0.6, 0.8, 1.0)),
    Knob("enable_escalation", (False, True)),
    Knob("spec_len", (0, 2, 4)),
    Knob("spec_ngram", (2, 3)),
    Knob("defrag_every", (0, 4, 16)),
)

# the hand-tuned baseline every benchmark uses: equal_arena_serving(4, L, 8)
DEFAULT_GENOME = {
    "num_slots": 4, "page_size": 8, "chunk_pages": 2, "policy": "fifo",
    "low_watermark": 0.25, "critical_watermark": 0.1, "high_watermark": 1.0,
    "enable_escalation": False, "spec_len": 0, "spec_ngram": 3,
    "defrag_every": 0,
}


@dataclasses.dataclass(frozen=True)
class KnobSpace:
    """Search space bound to a trace's context ceiling ``max_len`` and the
    baseline arena budget (``budget_slots`` rows of ``budget_page`` pages —
    the equal-arena-bytes contract all genomes share)."""

    max_len: int
    knobs: tuple[Knob, ...] = DEFAULT_KNOBS
    budget_slots: int = 4
    budget_page: int = 8

    def __post_init__(self):
        names = [k.name for k in self.knobs]
        assert len(names) == len(set(names)), "duplicate knob names"
        for k in self.knobs:
            assert k.choices, f"knob {k.name} has no choices"

    @property
    def budget_tokens(self) -> int:
        """Fixed arena token capacity (excl. the null page) every genome
        materializes under — the hand-tuned baseline's provisioning."""
        return (self.budget_slots
                * pages_needed(self.max_len, self.budget_page)
                * self.budget_page)

    def knob(self, name: str) -> Knob:
        for k in self.knobs:
            if k.name == name:
                return k
        raise KeyError(name)

    def default_genome(self) -> dict:
        return self.validate_and_repair(dict(DEFAULT_GENOME))

    # ------------------------------------------------------------ operators

    def sample(self, rng: np.random.Generator) -> dict:
        g = {k.name: k.choices[int(rng.integers(len(k.choices)))]
             for k in self.knobs}
        return self.validate_and_repair(g)

    def mutate(self, genome: dict, rng: np.random.Generator,
               p: float = 0.35) -> dict:
        """Each knob reassigns (to a DIFFERENT choice) with probability
        ``p``; if no knob fired, one random knob is forced — a mutation
        always moves."""
        g = dict(genome)
        moved = False
        for k in self.knobs:
            if len(k.choices) > 1 and rng.random() < p:
                alts = [c for c in k.choices if c != g.get(k.name)]
                g[k.name] = alts[int(rng.integers(len(alts)))]
                moved = True
        if not moved:
            movable = [k for k in self.knobs if len(k.choices) > 1]
            k = movable[int(rng.integers(len(movable)))]
            alts = [c for c in k.choices if c != g.get(k.name)]
            g[k.name] = alts[int(rng.integers(len(alts)))]
        return self.validate_and_repair(g)

    def crossover(self, a: dict, b: dict, rng: np.random.Generator) -> dict:
        g = {k.name: (a if rng.random() < 0.5 else b)[k.name]
             for k in self.knobs}
        return self.validate_and_repair(g)

    # ------------------------------------------------------ repair + encode

    def validate_and_repair(self, genome: dict) -> dict:
        """Any dict -> an in-space genome: fill from the default, snap to
        choices, repair watermark ordering (critical <= low <= high).
        Invalid combinations are repaired, never raised."""
        g = {}
        for k in self.knobs:
            v = genome.get(k.name, DEFAULT_GENOME.get(k.name, k.choices[0]))
            g[k.name] = k.snap(v)
        names = {k.name for k in self.knobs}
        # watermark ordering repair only applies when a restricted space
        # actually searches those knobs (un-searched ones fall back to
        # ServingCfg defaults, which are already ordered)
        if "low_watermark" in names:
            low = g["low_watermark"]
            if "critical_watermark" in names and \
                    g["critical_watermark"] > low:
                crit = [c for c in self.knob("critical_watermark").choices
                        if c <= low]
                g["critical_watermark"] = max(crit) if crit else low
            if "high_watermark" in names and g["high_watermark"] < low:
                high = [c for c in self.knob("high_watermark").choices
                        if c >= low]
                g["high_watermark"] = min(high) if high else 1.0
        return g

    def genome_key(self, genome: dict) -> tuple:
        """Canonical hashable identity (knob order pinned by the space) —
        the evaluation-memo / checkpoint key."""
        return tuple((k.name, genome[k.name]) for k in self.knobs)

    def to_serving(self, genome: dict) -> ServingCfg:
        """Materialize a genome into a ``ServingCfg`` under the fixed arena
        budget. The result always passes ``ServingCfg.validate()``."""
        g = dict(DEFAULT_GENOME)  # un-searched knobs of a restricted space
        g.update(self.validate_and_repair(genome))
        ps = g["page_size"]
        max_blocks = pages_needed(self.max_len, ps)
        # same token capacity for every page size (+1 reserved null page);
        # at least one full-length row must fit
        num_pages = max(self.budget_tokens // ps, max_blocks) + 1
        chunk = g["chunk_pages"] * ps
        return ServingCfg(
            num_slots=g["num_slots"],
            page_size=ps,
            num_pages=num_pages,
            max_blocks_per_slot=max_blocks,
            # tiered genomes spill to a half-budget CPQ arena (compressed
            # pages are ~4x cheaper per token, so this stays within spirit
            # of the equal-bytes contract; non-tiered genomes never allocate it)
            escalated_pages=max(2, self.budget_tokens // (2 * ps) + 1),
            low_watermark=g["low_watermark"],
            critical_watermark=g["critical_watermark"],
            high_watermark=g["high_watermark"],
            enable_escalation=g["enable_escalation"],
            policy=g["policy"],
            prefill_bucket=chunk,
            prefill_chunk=chunk,
            defrag_every=g["defrag_every"],
            spec_len=g["spec_len"],
            spec_ngram=g["spec_ngram"],
        ).validate()


def space_for_trace(work, *, knobs: Optional[tuple[Knob, ...]] = None
                    ) -> KnobSpace:
    """KnobSpace whose context ceiling covers every request in ``work``
    (prompt + target tokens), budgeted to the hand-tuned baseline arena."""
    max_len = max(len(w.prompt) + w.target for w in work)
    if knobs is None:
        return KnobSpace(max_len=max_len)
    return KnobSpace(max_len=max_len, knobs=knobs)
