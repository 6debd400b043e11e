"""Reusable serving traces of the port (the JAX package's
``serving/trace.py``): workload builders and the continuous-run harness, so
that a caller can run the port's ``ContinuousServeEngine`` on a seeded trace
and read structured metrics. The generators are numpy and give the same
items as the reference's for the same seed.

The module has three layers:

  * ``WorkItem`` + ``make_*_workload`` — deterministic seeded traces
    (Poisson mixed-length, shared-system-prompt templated, mixed-SLO-class,
    heavy-tailed burst, self-similar loopy).
  * ``equal_arena_serving`` — the hand-tuned ``ServingCfg`` construction
    (page pool sized to the static engine's token capacity).
  * ``run_trace`` — one engine, one trace, one metrics dict. Deterministic
    under greedy decoding for a fixed (cfg, serving, work): every metric
    except the ``wall_time_s``/``tokens_per_s`` timers is computed on the
    engine's tick clock.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs import ServingCfg
from repro_torch.serving.engine import ContinuousServeEngine, GenerationConfig
from repro_torch.serving.paged_cache import pages_needed
from repro_torch.serving.request import SloClass
from repro_torch.serving.scheduler import Request


@dataclasses.dataclass
class WorkItem:
    rid: int
    prompt: np.ndarray
    target: int          # tokens the request actually wants
    arrival: float       # decode-step units


def make_workload(seed: int, n_requests: int, vocab: int, rate: float,
                  prompt_lens=(4, 28), short=(2, 9), long=(48, 80),
                  p_long=0.25, long_prompt=(0, 0), p_long_prompt=0.0
                  ) -> list[WorkItem]:
    """Poisson arrivals; heavy-tailed generation targets (the realistic mixed
    traffic where static batching pads every row to the batch straggler).
    ``long_prompt``/``p_long_prompt`` mix in occasional long prompts — the
    head-of-line hazard that makes monolithic admission stall decode."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n_requests):
        t += rng.exponential(1.0 / max(rate, 1e-9))
        tgt = int(rng.integers(*long) if rng.random() < p_long
                  else rng.integers(*short))
        plen = (int(rng.integers(*long_prompt))
                if p_long_prompt and rng.random() < p_long_prompt
                else int(rng.integers(*prompt_lens)))
        out.append(WorkItem(
            rid=i,
            prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
            target=tgt,
            arrival=t))
    return out


def make_templated_workload(seed: int, n_sessions: int, vocab: int,
                            rate: float, *, sys_tokens: int = 24,
                            turns: int = 3, turn_step: int = 10,
                            target=(3, 7), long=(24, 48),
                            p_long: float = 0.25) -> list[WorkItem]:
    """Shared-system-prompt multi-turn trace (the prefix-sharing workload):
    every request opens with ONE ``sys_tokens``-token system prompt, and each
    session's turns replay a growing slice of that session's private token
    stream (turn k's prompt = system + history[:k * turn_step] — the
    multi-turn chat shape where each follow-up resends the whole
    conversation). Prefix sharing mounts the system prompt (and any still-
    resident session history) as refcount bumps; sharing OFF rewrites it per
    request. Poisson arrivals interleave the sessions so the system-prompt
    pages stay hot. Generation targets keep the mixed trace's heavy tail
    (``p_long`` of turns draw from ``long``) — chat responses vary wildly in
    length, and that spread is what static batching pads for."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, vocab, size=sys_tokens).astype(np.int32)
    t0 = 0.0  # session starts form their own Poisson process; turn gaps
    out = []  # within a session extend past later sessions' starts, so the
    rid = 0   # sorted trace interleaves turns from different sessions
    for _ in range(n_sessions):
        t0 += rng.exponential(1.0 / max(rate, 1e-9))
        t = t0
        hist = rng.integers(1, vocab, size=turns * turn_step).astype(np.int32)
        for k in range(1, turns + 1):
            t += rng.exponential(turns / max(rate, 1e-9))
            tgt = int(rng.integers(*long) if rng.random() < p_long
                      else rng.integers(*target))
            out.append(WorkItem(
                rid=rid,
                prompt=np.concatenate([sys_p, hist[:k * turn_step]]),
                target=tgt,
                arrival=t))
            rid += 1
    out.sort(key=lambda w: w.arrival)
    return out


def make_loopy_workload(seed: int, n_requests: int, vocab: int, *,
                        motif: int = 8, reps: int = 3, target: int = 48,
                        gap: float = 0.0) -> list[WorkItem]:
    """Self-similar prompts (one random motif tiled ``reps`` times plus a
    short unique tail) with LONG generation targets — the structure
    prompt-lookup drafting exploits. A tiny random model decoding greedily
    over a long horizon falls into short cycles, so the row's suffix n-gram
    recurs in its own context and verification accepts multi-token runs:
    the bench analogue of the repetition real decode traces show (code,
    templated text, chat boilerplate). ``gap`` spaces arrivals in
    decode-step units; a gap larger than a request's lifetime serializes
    the trace to occupancy 1 — the weight-stream-bound regime speculative
    decoding targets."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        m = rng.integers(1, vocab, size=motif).astype(np.int32)
        prompt = np.concatenate(
            [np.tile(m, reps),
             rng.integers(1, vocab, size=2).astype(np.int32)])
        out.append(WorkItem(rid=i, prompt=prompt, target=target,
                            arrival=i * gap))
    return out


def make_slo_workload(seed: int, n_requests: int, vocab: int, rate: float,
                      p_interactive: float = 0.35):
    """Mixed-class Poisson trace for the policy comparison: mostly
    low-priority batch jobs (longer prompts, heavy generation targets) with
    interleaved high-priority interactive arrivals (short prompts, short
    targets, tight TTFT/ITL deadlines). Under FIFO the interactive requests
    queue behind whatever batch work arrived first — exactly the contention
    priority/slo scheduling exists to resolve. Returns (work, slos)."""
    interactive = SloClass("interactive", priority=2, ttft_target=10.0,
                           itl_target=4.0)
    batch = SloClass("batch", priority=0, ttft_target=96.0, itl_target=16.0)
    rng = np.random.default_rng(seed)
    t = 0.0
    work, slos = [], []
    for i in range(n_requests):
        t += rng.exponential(1.0 / max(rate, 1e-9))
        if rng.random() < p_interactive:
            slo, plen, tgt = interactive, int(rng.integers(3, 9)), \
                int(rng.integers(2, 7))
        else:
            # the batch class keeps the acceptance workload's heavy tail
            # (static padding waste is what the 1.5x bar measures)
            slo = batch
            plen = int(rng.integers(4, 28))
            tgt = (int(rng.integers(48, 80)) if rng.random() < 0.25
                   else int(rng.integers(2, 9)))
        work.append(WorkItem(
            rid=i, prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
            target=tgt, arrival=t))
        slos.append(slo)
    return work, slos


def make_burst_workload(seed: int, n_requests: int, vocab: int, rate: float,
                        p_interactive: float = 0.4, alpha: float = 1.5):
    """Heavy-tailed router traffic: Pareto inter-arrival gaps (bursty — most
    gaps tiny, occasional long lulls, infinite variance at ``alpha <= 2``)
    carrying the mixed Poisson-style class draw of ``make_slo_workload``
    (interactive = short prompt/target + tight deadlines, batch = heavy
    generation tail). Bursts are what make single-engine queueing collapse
    and what placement policies must absorb. Returns (work, slos)."""
    interactive = SloClass("interactive", priority=2, ttft_target=10.0,
                           itl_target=4.0)
    batch = SloClass("batch", priority=0, ttft_target=96.0, itl_target=16.0)
    rng = np.random.default_rng(seed)
    # Lomax (Pareto II) gaps scaled to the requested mean arrival rate:
    # mean gap = scale / (alpha - 1)
    scale = (alpha - 1.0) / max(rate, 1e-9)
    t = 0.0
    work, slos = [], []
    for i in range(n_requests):
        t += float(rng.pareto(alpha) * scale)
        if rng.random() < p_interactive:
            slo, plen, tgt = interactive, int(rng.integers(3, 9)), \
                int(rng.integers(2, 7))
        else:
            # tail targets stay shorter than a replica's share of the trace:
            # a lone straggler decoding at 1 token/step sets the lockstep
            # clock and would cap aggregate scaling no matter the placement
            slo = batch
            plen = int(rng.integers(4, 28))
            tgt = (int(rng.integers(16, 28)) if rng.random() < 0.25
                   else int(rng.integers(2, 9)))
        work.append(WorkItem(
            rid=i, prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
            target=tgt, arrival=t))
        slos.append(slo)
    return work, slos


def equal_arena_serving(num_slots: int, max_len: int, page_size: int,
                        prefill_chunk: int = 16,
                        bucket: int | None = None) -> ServingCfg:
    """Page pool with the SAME token capacity the static engine provisions
    (num_slots contiguous worst-case rows), plus the reserved null page.
    ``prefill_chunk=0`` selects the one-shot admission foil; pass ``bucket``
    = the chunked config's chunk size so both engines charge prefill work at
    the same clock quantum (fair ITL comparison)."""
    return ServingCfg(
        num_slots=num_slots,
        page_size=page_size,
        num_pages=num_slots * pages_needed(max_len, page_size) + 1,
        max_blocks_per_slot=pages_needed(max_len, page_size),
        prefill_bucket=bucket or prefill_chunk or page_size,
        prefill_chunk=prefill_chunk)


def run_trace(cfg, params, work: list[WorkItem], serving: ServingCfg,
              mode_rt=None, policy=None, slos=None, donor=None, device=None):
    """Serve one trace through a fresh ``ContinuousServeEngine`` and return
    the metrics dict. ``policy`` is a SchedulerPolicy (or name); ``slos`` an
    optional per-request SloClass list aligned with ``work`` (per-class tail
    metrics are added when given). ``donor`` does nothing: the reference
    adopts a donor engine's compiled steps, and eager PyTorch compiles none
    (the argument keeps the reference's signature). ``device`` is the
    engine's (the GPU unless given)."""
    eng = ContinuousServeEngine(cfg, params, rt=mode_rt, serving=serving,
                                policy=policy, device=device)
    reqs = [Request(rid=w.rid, prompt=w.prompt, max_new_tokens=w.target,
                    arrival=w.arrival,
                    slo=None if slos is None else slos[i])
            for i, w in enumerate(work)]
    # max_new is per request; gen caps nothing here (eos disabled)
    res, stats = eng.serve(reqs, GenerationConfig(max_new_tokens=max(
        w.target for w in work)))
    latencies = [res[w.rid]["done_step"] - w.arrival for w in work]
    ttfts = [res[w.rid]["first_token_step"] - w.arrival for w in work]
    itls = np.concatenate(
        [np.diff(res[w.rid]["token_steps"]) for w in work
         if len(res[w.rid]["token_steps"]) > 1] or [np.zeros(1)])
    out = {
        "engine": "continuous" + ("-chunked" if eng.chunked else "-oneshot"),
        "useful_tokens": stats["generated_tokens"],
        "waste_tokens": 0,
        "decode_steps": stats["decode_steps"],
        "tokens_per_step": stats["generated_tokens"] / max(stats["decode_steps"], 1),
        "latency_mean": float(np.mean(latencies)),
        "latency_p90": float(np.percentile(latencies, 90)),
        "ttft_p50": float(np.percentile(ttfts, 50)),
        "ttft_p95": float(np.percentile(ttfts, 95)),
        "itl_p50": float(np.percentile(itls, 50)),
        "itl_p95": float(np.percentile(itls, 95)),
        "arena_utilization": stats["arena_utilization_mean"],
        "wall_time_s": stats["wall_time_s"],
        "tokens_per_s": stats["tokens_per_s"],
        "preemptions": stats["preemptions"],
        "escalations": stats["escalations"],
        "deescalations": stats["deescalations"],
        "prefill_chunks": stats["prefill_chunks"],
        "itl_mean": float(np.mean(itls)),
        # speculative-decoding surface (zeros with spec_len == 0)
        "spec_steps": stats["spec_steps"],
        "spec_accept_rate": stats["spec_accept_rate"],
        "spec_accepted_per_step": (stats["spec_accepted"]
                                   / max(stats["decode_steps"], 1)),
        # mesh / allocator surface (public engine stats, no private state)
        "tokens": np.concatenate([res[w.rid]["tokens"] for w in work]),
        "model_shards": stats["model_shards"],
        "arena_bytes_total": stats["arena_bytes_total"],
        "arena_bytes_per_device": stats["arena_bytes_per_device"],
        "interconnect_bytes_per_token": stats["interconnect_bytes_per_token"],
        "dense_arena_utilization": stats["dense_arena_utilization"],
        "defrags": stats["defrags"],
        # prefix-sharing surface (zeros with sharing off)
        "prefill_write_bytes": stats["prefill_write_bytes"],
        "prefix_hits": stats["prefix_hits"],
        "shared_prefix_tokens": stats["shared_prefix_tokens"],
        "shared_prefix_pages": stats["shared_prefix_pages"],
        "cow_copies": stats["cow_copies"],
        # per-tick idle-vs-active traces + the per-request records the
        # policy metrics are scored on
        "policy": stats["policy"],
        "slot_utilization": stats["slot_utilization"],
        "trace_active_rows": stats["trace_active_rows"],
        "trace_arena_util": stats["trace_arena_util"],
        "results": res,
    }
    if slos is not None:
        out.update(class_tails(out, work, slos))
    return out


def class_tails(run: dict, work: list[WorkItem], slos) -> dict:
    """Per-SLO-class tail latencies on the engine tick clock:
    ``ttft_p95_<class>`` / ``itl_p95_<class>`` / ``unserved_<class>``.
    Requests that never produced a token (oom / unschedulable / shed) are
    excluded from the percentiles (their sentinel -1 stamp is not a latency)
    and counted in ``unserved_<class>`` instead."""
    res = run["results"]
    ttft_by: dict[str, list] = {}
    itl_by: dict[str, list] = {}
    unserved: dict[str, int] = {}
    for w, slo in zip(work, slos):
        r = res[w.rid]
        if r["first_token_step"] < 0:
            unserved[slo.name] = unserved.get(slo.name, 0) + 1
            continue
        ttft_by.setdefault(slo.name, []).append(
            r["first_token_step"] - w.arrival)
        gaps = (np.diff(r["token_steps"])
                if len(r["token_steps"]) > 1 else np.zeros(1))
        itl_by.setdefault(slo.name, []).append(float(np.percentile(gaps, 95)))
    out = {}
    for name, vals in ttft_by.items():
        out[f"ttft_p95_{name}"] = float(np.percentile(vals, 95))
        out[f"itl_p95_{name}"] = float(np.percentile(itl_by[name], 95))
    for name, n in unserved.items():
        out[f"unserved_{name}"] = n
    return out
