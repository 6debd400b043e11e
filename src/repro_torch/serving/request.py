"""Request-centric serving API: the public dataclasses (a copy of the JAX
package's ``serving/request.py``).

  ``SamplingParams``   per-request decoding knobs (temperature / top-k /
                       top-p / seed / stop tokens / token budget). The engine
                       loads them into per-row arrays read by one sampler;
                       greedy rows (``temperature <= 0``) take the argmax.
  ``SloClass``         the request's service class: a strict priority level
                       plus TTFT / ITL targets in engine ticks. Pure
                       metadata to the engine; ``serving/policies.py`` turns
                       it into admission / preemption / escalation decisions
                       and benchmarks score attainment against the targets.
  ``ServeRequest``     the immutable user-facing request spec
                       (prompt + sampling + slo + arrival + optional
                       streaming callback). ``ContinuousServeEngine
                       .add_request`` converts it into the scheduler-owned
                       mutable ``Request`` record.
  ``RequestOutput``    one incremental output event: a single generated
                       token with its stream index, the engine tick it
                       became available at, and the finish flag/reason on
                       the last one. ``engine.step()`` returns the tick's
                       events; per-request ``stream`` callbacks get them as
                       they are committed.

Seeded sampling is reproducible by construction: token ``i`` of a request is
drawn with ``fold_in(PRNGKey(seed), i)``, a function of the request alone —
never of the slot it landed in, the co-resident batch, or preemption history
(recompute replays the context and re-draws the same keys).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters (vLLM-style).

    ``temperature <= 0`` selects greedy argmax (the default) — such rows are
    bit-identical to the pre-request-API engine. ``top_k == 0`` disables the
    top-k filter; ``top_p == 1.0`` disables the nucleus filter. ``seed``
    names the request's private sample stream (see module docstring);
    ``stop_token_ids`` retire the request exactly like EOS (pages freed, slot
    refilled) with finish_reason ``"stop"``."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    max_tokens: int = 32
    stop_token_ids: tuple[int, ...] = ()
    seed: int = 0
    # explicit total-latency budget in engine ticks RELATIVE to arrival
    # (math.inf = none). At a tick boundary where the budget is blown the
    # request retires with finish_reason "timeout" (pages freed, counted in
    # the ``timeouts`` stat). Overrides any SloClass-derived budget.
    deadline: float = math.inf
    # per-request opt-out of speculative decoding (engines with
    # ``ServingCfg.spec_len > 0``). Output-invisible either way: committed
    # tokens are always the request's own fold_in(seed, token_index) draws
    # (argmax for greedy), speculation only changes WHEN they land.
    speculate: bool = True

    def __post_init__(self):
        assert self.max_tokens >= 1, "max_tokens must be >= 1"
        assert self.top_k >= 0, "top_k < 0 (0 disables the filter)"
        assert 0.0 < self.top_p <= 1.0, "top_p must be in (0, 1]"
        assert self.deadline > 0, "deadline must be > 0 ticks (inf = none)"
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))


@dataclasses.dataclass(frozen=True)
class SloClass:
    """Service-level class: strict priority + latency targets.

    ``priority`` orders classes (higher = more urgent); ``ttft_target`` /
    ``itl_target`` are time-to-first-token / inter-token-latency targets in
    engine ticks (the decode-step clock every serve stat is measured in).
    ``math.inf`` targets mean "no deadline" — `SloAwarePolicy` treats such
    requests as infinitely patient and benchmarks score them as always
    attained."""

    name: str = "standard"
    priority: int = 1
    ttft_target: float = math.inf
    itl_target: float = math.inf


# canonical classes (benchmarks and examples use these; any SloClass works)
INTERACTIVE = SloClass("interactive", priority=2, ttft_target=8.0,
                       itl_target=3.0)
STANDARD = SloClass("standard", priority=1, ttft_target=32.0, itl_target=8.0)
BATCH = SloClass("batch", priority=0)


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """User-facing request spec. ``prompt`` is any int sequence; ``stream``
    (optional) is called with each ``RequestOutput`` as it is committed.
    ``arrival`` is in decode-step units (0.0 = already arrived), matching
    the engine's simulation clock. ``session_id`` (optional) names a
    multi-turn conversation: the replica router pins every request of a
    session to the replica that served its earlier turns (the replica
    holding the session's arena pages), remapping only on drain — a single
    engine ignores it."""

    prompt: np.ndarray
    sampling: SamplingParams = SamplingParams()
    slo: SloClass = STANDARD
    rid: Optional[int] = None          # None => engine assigns the next id
    arrival: float = 0.0
    stream: Optional[Callable[["RequestOutput"], None]] = None
    session_id: Optional[str] = None   # replica-affinity key (router)

    def __post_init__(self):
        object.__setattr__(self, "prompt",
                           np.asarray(self.prompt, np.int32).reshape(-1))
        assert len(self.prompt) >= 1, "empty prompt"


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """One streamed token. ``index`` is the token's position in the request's
    generated stream (0-based); ``step`` the engine tick it became available
    at (end-of-work convention, same clock as ``token_steps`` in results).
    ``finished`` is True on the request's final event, with ``finish_reason``
    in {eos, stop, max_tokens, length_cap, oom, unschedulable, timeout,
    shed}. ``timeout``/``shed`` finishes carry ``token == -1`` — a
    finish-only event with no token payload (the stream up to ``index``
    tokens is still gapless)."""

    rid: int
    token: int
    index: int
    step: int
    finished: bool = False
    finish_reason: str = ""
