"""The port's serving auto-tuner (the JAX package's ``repro.tuning``).

Searches the ``ServingCfg`` knob space with a seeded, resumable μ+λ
evolutionary Pareto loop against three minimized objectives measured on the
port's ``ContinuousServeEngine`` over a fixed seeded trace: throughput
(-tokens/step), latency (interactive p95 TTFT) and energy (mJ/token from the
analytical device model of ``energy.py``, the H100's record by default),
and materializes the frontier into named presets loadable via
``ServingCfg.from_preset()``.

Modules:
  space      — typed knob space: sampling / mutation / crossover with a
               ``validate_and_repair`` pass (invalid combos repaired, not
               crashed); capacity derived from a fixed arena byte budget
  objectives — the evaluation harness over
               ``repro_torch.serving.trace.run_trace``
  energy     — the device records and ``decode_token_cost``, the model
               that prices the energy axis
  evolution  — the μ+λ loop: deterministic under a seed, JSON-checkpoint
               resumable after every evaluation
  frontier   — dominance, non-dominated sort, exact hypervolume
  presets    — frontier -> named operating points (latency / throughput /
               energy / default) + the presets JSON document

CLI: ``python -m repro_torch.launch.tune --budget 24 --seed 0 --smoke``
(on the GPU; add ``--device cpu`` to run the plain path on the CPU).
"""
from repro_torch.tuning.evolution import EvalRecord, ParetoSearch
from repro_torch.tuning.frontier import (dominates, hypervolume,
                                         non_dominated_sort, pareto_front)
from repro_torch.tuning.objectives import (OBJECTIVE_NAMES, ServingObjective,
                                           TraceSpec, energy_mj_per_token)
from repro_torch.tuning.presets import (load_presets, materialize, select_presets,
                                        write_presets)
from repro_torch.tuning.space import (DEFAULT_GENOME, DEFAULT_KNOBS, Knob,
                                      KnobSpace, space_for_trace)

__all__ = [
    "EvalRecord", "ParetoSearch", "dominates", "hypervolume",
    "non_dominated_sort", "pareto_front", "OBJECTIVE_NAMES",
    "ServingObjective", "TraceSpec", "energy_mj_per_token", "load_presets",
    "materialize", "select_presets", "write_presets", "DEFAULT_GENOME",
    "DEFAULT_KNOBS", "Knob", "KnobSpace", "space_for_trace",
]
