"""Materialize a Pareto frontier into named ``ServingCfg`` presets (the JAX
package's ``tuning/presets.py``).

``latency`` / ``throughput`` / ``energy`` are the frontier's argmin on each
objective axis (ties broken by the full objective vector then genome key —
deterministic), and ``default`` records the hand-tuned baseline the search
was seeded with. The JSON document this module writes is what
``ServingCfg.from_preset()`` and ``python -m repro_torch.launch.serve
--preset`` load; the port's committed copy lives at
``src/repro_torch/serving_presets.json`` (``ServingCfg.preset_path()``) and
is regenerated on the GPU by ``python -m repro_torch.launch.tune``.

Because evaluation 0 of every search is the hand-tuned default genome, each
named preset is no worse than the default on its own objective axis by
construction (the global per-axis minimum always sits on the frontier).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from repro_torch.tuning.evolution import EvalRecord, ParetoSearch
from repro_torch.tuning.objectives import OBJECTIVE_NAMES
from repro_torch.tuning.space import KnobSpace

PRESET_NAMES = OBJECTIVE_NAMES  # one preset per objective axis


def select_presets(space: KnobSpace, frontier: list[EvalRecord]
                   ) -> dict[str, EvalRecord]:
    """Frontier argmin per objective axis, deterministically tie-broken."""
    assert frontier, "empty frontier"
    out = {}
    for axis, name in enumerate(PRESET_NAMES):
        out[name] = min(frontier, key=lambda r: (
            r.objectives[axis], r.objectives,
            space.genome_key(r.genome)))
    return out


def _point(space: KnobSpace, rec: EvalRecord) -> dict:
    return {
        "genome": dict(rec.genome),
        "serving": dataclasses.asdict(space.to_serving(rec.genome)),
        "objectives": {n: rec.objectives[i]
                       for i, n in enumerate(OBJECTIVE_NAMES)},
        "metrics": dict(rec.metrics),
    }


def materialize(search: ParetoSearch, *, trace: Optional[dict] = None
                ) -> dict:
    """Reduce a finished search to the presets document: named presets
    (per-axis winners + the hand-tuned ``default``), the full frontier,
    and enough provenance (seed, budget, trace, hypervolume) to regenerate
    or audit it. Wall-time free: a same-seed rerun writes an identical
    document."""
    space = search.space
    front = search.frontier()
    presets = {name: _point(space, rec)
               for name, rec in select_presets(space, front).items()}
    presets["default"] = _point(space, search.baseline())
    return {
        "version": 1,
        "seed": search.seed,
        "budget": len(search.records),
        "mu": search.mu, "lam": search.lam,
        "trace": trace or {},
        "objective_names": list(OBJECTIVE_NAMES),
        "hypervolume": search.frontier_hypervolume(),
        "frontier": [_point(space, r) for r in front],
        "presets": presets,
    }


def write_presets(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_presets(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
