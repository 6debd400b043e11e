"""Pareto machinery of the port's tuner (the JAX package's
``tuning/frontier.py``, which is pure Python): dominance, non-dominated
sort, hypervolume.

All objectives are MINIMIZED. Objective vectors are plain tuples/lists of
floats; everything here is deterministic and pure (no numpy RNG, no engine
imports) so the search loop's bookkeeping stays bit-reproducible.
"""
from __future__ import annotations

from typing import Iterable, Sequence


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """a dominates b: no worse on every objective, strictly better on one."""
    assert len(a) == len(b), (a, b)
    return all(x <= y for x, y in zip(a, b)) and any(
        x < y for x, y in zip(a, b))


def pareto_front(points: Sequence[Sequence[float]]) -> list[int]:
    """Indices of the non-dominated points, in input order. Duplicates of a
    frontier point all survive (they dominate nothing and nothing dominates
    them) — callers dedupe by genome key if they need distinct points."""
    out = []
    for i, p in enumerate(points):
        if not any(dominates(q, p) for j, q in enumerate(points) if j != i):
            out.append(i)
    return out


def non_dominated_sort(points: Sequence[Sequence[float]]) -> list[list[int]]:
    """NSGA-style fronts: front 0 is the Pareto set, front 1 the Pareto set
    of the remainder, and so on. Returns lists of input indices."""
    remaining = list(range(len(points)))
    fronts: list[list[int]] = []
    while remaining:
        sub = [points[i] for i in remaining]
        keep = set(pareto_front(sub))
        front = [remaining[k] for k in sorted(keep)]
        fronts.append(front)
        remaining = [i for k, i in enumerate(remaining) if k not in keep]
    return fronts


def _pareto_min(points: list[tuple]) -> list[tuple]:
    return [points[i] for i in pareto_front(points)]


def hypervolume(points: Iterable[Sequence[float]],
                ref: Sequence[float]) -> float:
    """Exact hypervolume (minimization) dominated by ``points`` w.r.t. the
    reference point ``ref``: the measure of the region every point must
    dominate for the frontier to 'cover' it. Points not strictly better than
    ``ref`` on every axis contribute nothing. Recursive slicing on the first
    objective — exponential in dimensions but exact, and the tuner runs at 3
    objectives over a few dozen frontier points."""
    ref = tuple(float(r) for r in ref)
    pts = sorted({tuple(float(x) for x in p) for p in points
                  if all(x < r for x, r in zip(p, ref))})
    pts = _pareto_min(pts)

    def hv(pts: list[tuple], ref: tuple) -> float:
        if not pts:
            return 0.0
        if len(ref) == 1:
            return ref[0] - min(p[0] for p in pts)
        vals = sorted({p[0] for p in pts})
        total = 0.0
        for i, v in enumerate(vals):
            upper = vals[i + 1] if i + 1 < len(vals) else ref[0]
            width = upper - v
            if width <= 0:
                continue
            slab = [p[1:] for p in pts if p[0] <= v]
            total += width * hv(_pareto_min(slab), ref[1:])
        return total

    return hv(pts, ref)
