"""Objective evaluation of the port's serving auto-tuner (the JAX package's
``tuning/objectives.py``).

One evaluation = materialize the genome into a ``ServingCfg``
(``KnobSpace.to_serving``), serve the FIXED seeded trace through the port's
``ContinuousServeEngine`` (``repro_torch.serving.trace.run_trace``, on the
GPU unless another device is given), and reduce the run to a minimized
objective vector:

  0. throughput:  -tokens/step (useful generated tokens per engine tick)
  1. latency:     p95 TTFT of the interactive SLO class, engine ticks
                  (overall p95 TTFT when the trace carries no classes)
  2. energy:      mJ/token from the analytical device model
                  (``tuning/energy.py``): the paper-scale model (OPT-6.7B)
                  on a device record (the H100's by default) charged at
                  THIS run's measured utilization and page-table traffic

Determinism: the trace is fixed and seeded, decoding is greedy, and every
objective lives on the engine's tick clock (never wall time), so the same
genome always maps to the same objective vector, which is what makes the
search memoizable, checkpoint-resumable and reproducible.

The smoke model measures SCHEDULING behaviour (utilization, tokens per
invocation, paged bytes/token for the genome's page size), and the
analytical model prices that behaviour at paper scale. Utilization is
useful tokens per slot-invocation (``tokens_per_step / num_slots``).

The reference keeps a donor engine per arena kind so that evaluation
engines adopt its jitted steps; eager PyTorch compiles nothing, the port's
``run_trace`` ignores ``donor``, and so the port keeps no donor.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Optional

import torch

from repro_torch.params import resolve_device, to_device
from repro_torch.serving.trace import make_slo_workload, make_workload, run_trace
from repro_torch.tuning.energy import H100_SXM, Device, TrafficCfg, decode_token_cost
from repro_torch.tuning.space import KnobSpace, space_for_trace

OBJECTIVE_NAMES = ("throughput", "latency", "energy")

# scalar run metrics carried into checkpoints / presets (JSON-safe, wall-
# time free: timers would break the reproducibility claims)
_METRIC_KEYS = (
    "tokens_per_step", "decode_steps", "useful_tokens", "ttft_p50",
    "ttft_p95", "itl_p50", "itl_p95", "itl_mean", "ttft_p95_interactive",
    "itl_p95_interactive", "ttft_p95_batch", "itl_p95_batch",
    "unserved_interactive", "unserved_batch", "slot_utilization",
    "arena_utilization", "preemptions", "escalations", "deescalations",
    "spec_accept_rate", "spec_accepted_per_step", "prefill_chunks",
    "defrags", "prefill_write_bytes",
)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """The fixed seeded workload an entire search is scored on."""

    kind: str = "slo"        # slo (mixed interactive/batch) | mixed (Poisson)
    seed: int = 0
    n_requests: int = 12
    rate: float = 2.0

    def build(self, vocab: int):
        if self.kind == "slo":
            return make_slo_workload(self.seed, self.n_requests, vocab,
                                     self.rate)
        if self.kind == "mixed":
            return make_workload(self.seed, self.n_requests, vocab,
                                 self.rate), None
        raise ValueError(f"unknown trace kind {self.kind!r}")


_PAPER_SCALE: dict = {}      # lazy: n_params, num_layers, ModelConfig
_KV_PAGED: dict[int, float] = {}   # page_size -> paged bytes/token/layer


def _paper_scale():
    """OPT-6.7B's parameters counted from the port's ``ParamSpec`` shapes
    (no weight is allocated)."""
    if not _PAPER_SCALE:
        from repro_torch.configs import get_config
        from repro_torch.params import count_params, model_defs

        mc = get_config("opt-6.7b")
        _PAPER_SCALE["cfg"] = mc
        _PAPER_SCALE["n_params"] = count_params(model_defs(mc))
        _PAPER_SCALE["L"] = mc.num_layers
    return _PAPER_SCALE


def _kv_paged_bytes(page_size: int) -> float:
    """Paged dense bytes per token per layer at OPT-6.7B's heads, from a
    2-page bf16 arena built on the CPU."""
    if page_size not in _KV_PAGED:
        from repro_torch.serving import paged_cache as pgc

        mc = _paper_scale()["cfg"]
        arena = pgc.init_paged_dense(2, page_size, mc.num_kv_heads,
                                     mc.head_dim, device="cpu")
        _KV_PAGED[page_size] = pgc.bytes_per_token(arena, page_size)
    return _KV_PAGED[page_size]


def energy_mj_per_token(run: dict, serving, device_model: Device = H100_SXM) -> float:
    """Price the measured run at paper scale (OPT-6.7B on ``device_model``)
    through ``decode_token_cost``: block-table-amortized paged bytes for
    THIS page size, chunked-prefill write amortization, and the measured
    tokens-per-slot-invocation utilization."""
    ps = _paper_scale()
    kv = _kv_paged_bytes(serving.page_size)
    util = min(1.0, max(run["tokens_per_step"] / serving.num_slots, 1e-6))
    tc = TrafficCfg(batch=serving.num_slots,
                    kv_bytes_per_token_layer=kv,
                    prefill_ctx=2048, gen_tokens=256,
                    prefill_write_bytes_per_token_layer=kv,
                    slot_util=util)
    _, e = decode_token_cost(device_model, ps["n_params"], ps["L"], tc)
    return e * 1e3


def _scalar(v):
    """A run metric as a plain Python number (a 0-d tensor or a numpy
    scalar included), or None when it is not a real scalar."""
    if isinstance(v, torch.Tensor):
        if v.dim() != 0 or v.dtype == torch.bool:
            return None
        v = v.item()
    if isinstance(v, numbers.Real) and not isinstance(v, bool):
        fv = float(v)
        return int(fv) if fv.is_integer() else fv
    return None


class ServingObjective:
    """Callable evaluation harness: genome -> (objectives, metrics).

    Builds the trace once, then serves it through a fresh engine per
    evaluation on ``device`` (the GPU unless given; the weights are moved
    there once). ``device_model`` is the device record that prices the
    energy axis (the H100's by default)."""

    names = OBJECTIVE_NAMES

    def __init__(self, cfg, params, trace: TraceSpec = TraceSpec(),
                 space: Optional[KnobSpace] = None,
                 device_model: Device = H100_SXM, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = to_device(params, self.device)
        self.trace = trace
        self.device_model = device_model
        self.work, self.slos = trace.build(cfg.vocab_size)
        self.space = space or space_for_trace(self.work)
        assert self.space.max_len >= max(
            len(w.prompt) + w.target for w in self.work), (
            "KnobSpace.max_len does not cover the trace")

    def __call__(self, genome: dict) -> tuple[tuple[float, ...], dict]:
        serving = self.space.to_serving(genome)
        run = run_trace(self.cfg, self.params, self.work, serving,
                        slos=self.slos, device=self.device)
        energy = energy_mj_per_token(run, serving, self.device_model)
        latency = float(run.get("ttft_p95_interactive", run["ttft_p95"]))
        # unscheduled requests (never produced a token) are a hard miss:
        # their sentinel stamps are excluded from the percentiles, so make
        # the latency axis reflect them instead of rewarding starvation
        unserved = sum(v for k, v in run.items()
                       if k.startswith("unserved_"))
        if unserved:
            latency += 1e3 * unserved
        objectives = (-float(run["tokens_per_step"]), latency, float(energy))
        metrics = {}
        for k in _METRIC_KEYS:
            v = _scalar(run.get(k))
            if v is not None:
                metrics[k] = v
        metrics["energy_mj_per_token"] = float(energy)
        return objectives, metrics
