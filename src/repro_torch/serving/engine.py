"""Serving engines of the port (the JAX package's ``serving/engine.py``).

``ServeEngine`` (``:116``) is the static-batch engine, the contiguous-arena
baseline: one batch of equal-length prompts is prefilled into contiguous
``(B, S + max_new_tokens, ...)`` arenas, then decoded step by step at one
shared position to the end, greedily.

``ContinuousServeEngine`` (``:225``) is continuous batching: requests are
admitted into vacated slots as soon as their pages fit, their prompts stream
into the slot's arena pages one ``prefill_chunk`` per tick (interleaved with
the decode step), every running row decodes at its own position, and rows
retire at EOS / stop tokens / budget and free their pages at once. With
``prefill_chunk=0`` an admission is one-shot instead, the reference's
construction-exact oracle of chunked admission: the whole prompt, padded to
the ``prefill_bucket``, is prefilled into a B=1 contiguous cache and packed
into the slot's pages, and the clock is charged its bucket-equivalents.
Ticks, outputs, stats, recompute preemption and tier escalation follow the
reference step for step, so greedy streams and tick counters are identical
to the JAX engine's.

Attention modes: ``dense``, ``decomposed`` (T1: the arena holds the normed
block input X and a roped key slice per kv head instead of K and V),
``cpq`` (T2: the whole arena holds int8 CPQ codes) and ``retrieval`` (T3:
K and V pages beside int8 proxy-code pages; decode attends the top-k keys
by proxy score plus a recent window, prefill attends densely). With
``ServingCfg(enable_escalation=True)`` a dense engine is tiered: every
layer pairs its dense arena with a CPQ escalation arena, new admissions go
to the CPQ tier while the dense arena's free fraction is below
``low_watermark``, and below ``critical_watermark`` (or when a dense row
cannot grow) running dense rows are re-compressed into it. As in the
reference, escalation with any other mode leaves the engine untiered.

Both engines run on the GPU unless ``device`` names another device. They
refuse, with ``SchedulerConfigError``, every knob the port does not
implement yet instead of ignoring it: the T1+T2 attention mode, non-token
inputs and sampled (``temperature > 0``) requests, and, in the continuous
engine, prefix sharing, speculative decoding, defrag, a device mesh and
non-FIFO policies.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs import AttentionRuntime, CPQCfg, ModelConfig, ServingCfg
from repro_torch.models import model as M
from repro_torch.params import model_defs, resolve_device, to_device
from repro_torch.serving import paged_cache as pgc
from repro_torch.serving.policies import derive_deadlines, make_policy, slo_of
from repro_torch.serving.request import RequestOutput, SamplingParams, ServeRequest
from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfigError


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 => greedy
    top_p: float = 1.0
    eos_id: int = -1              # -1 => never stop early
    seed: int = 0


def _unported_knobs(serving: ServingCfg, rt: AttentionRuntime,
                    cfg: ModelConfig) -> list[str]:
    """The settings this engine refuses, each with its ROADMAP item."""
    out = []
    if serving.share_prefix:
        out.append("share_prefix (prefix sharing, ROADMAP A11)")
    if serving.spec_len > 0:
        out.append(f"spec_len={serving.spec_len} (speculative decoding, ROADMAP A12)")
    if serving.defrag_every:
        out.append(f"defrag_every={serving.defrag_every} (defrag, ROADMAP A11)")
    if serving.policy != "fifo":
        out.append(f"policy={serving.policy!r} (ROADMAP A10)")
    return out + _unported_model(rt, cfg)


def _unported_model(rt: AttentionRuntime, cfg: ModelConfig) -> list[str]:
    """The runtime and model settings neither engine serves yet."""
    out = []
    if rt.mesh is not None:
        out.append("mesh (multi-device serving, ROADMAP A21)")
    if rt.mode in pgc.UNPORTED_MODES:
        out.append(f"mode={rt.mode!r} (ROADMAP {pgc.UNPORTED_MODES[rt.mode]})")
    if cfg.input_kind != "tokens":
        out.append(f"input_kind={cfg.input_kind!r} (ROADMAP A19)")
    return out


def _refuse_sampling(temperature: float, who: str) -> None:
    if temperature > 0.0:
        raise SchedulerConfigError(
            f"{who}: temperature={temperature} — seeded sampling is not ported yet "
            "(ROADMAP A6); the port serves greedy requests")


def sample_tokens(logits: torch.Tensor, gen: GenerationConfig) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 greedy tokens (the reference's
    ``sample_tokens`` at temperature 0; sampling is refused)."""
    _refuse_sampling(gen.temperature, "sample_tokens")
    return torch.argmax(logits, dim=-1).to(torch.int32)


# --------------------------------------------------------------- static engine


class ServeEngine:
    """Static-batch engine: one batch of equal-length prompts, prefilled
    into contiguous arenas and decoded to the end at one shared position,
    greedily. The contiguous-arena baseline."""

    def __init__(self, cfg: ModelConfig, params, rt: Optional[AttentionRuntime] = None,
                 max_len: int = 4096, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rt = rt or cfg.attention
        unported = _unported_model(self.rt, cfg)
        if unported:
            raise SchedulerConfigError("not ported yet: " + "; ".join(unported))
        model_defs(cfg)  # raises NotImplementedError for unported layer kinds
        self.params = to_device(params, self.device)
        self.max_len = max_len

    def generate(self, batch: dict, gen: GenerationConfig = GenerationConfig()):
        """batch: {'tokens': (B, S)}. Returns (generated (B, n) int32, n <=
        max_new_tokens, stats). With ``eos_id`` rows past their EOS emit
        ``eos_id``, the EOS itself counts as generated, and the run stops
        once every row has emitted one."""
        _refuse_sampling(gen.temperature, "ServeEngine.generate")
        cfg = self.cfg
        prompt = torch.as_tensor(np.asarray(batch["tokens"]), device=self.device)
        B, S = prompt.shape
        if S > self.max_len:
            raise ValueError(f"ServeEngine.generate: prompts of {S} tokens exceed "
                             f"max_len={self.max_len}")
        caches = M.init_caches(cfg, self.rt, B, S + gen.max_new_tokens, self.device)
        logits, caches = M.prefill(cfg, self.rt, self.params, prompt, caches)

        toks = []
        done = np.zeros((B,), bool)
        live_tokens = decode_calls = 0
        tok = sample_tokens(logits, gen).cpu().numpy()
        for t in range(gen.max_new_tokens):
            if gen.eos_id >= 0:  # rows past their EOS emit eos_id
                tok = np.where(done, gen.eos_id, tok).astype(np.int32)
            toks.append(tok)
            live_tokens += int((~done).sum())  # EOS itself counts; padding does not
            if gen.eos_id >= 0:
                done = done | (tok == gen.eos_id)
                if done.all():
                    break
            if t == gen.max_new_tokens - 1:
                break  # the last token needs no decode
            logits, caches = M.decode_step(cfg, self.rt, self.params,
                                           torch.as_tensor(tok[:, None], device=self.device),
                                           S + t, caches)
            decode_calls += 1
            tok = sample_tokens(logits, gen).cpu().numpy()
        stats = {"prompt_tokens": int(B * S), "generated_tokens": live_tokens,
                 "decode_steps": decode_calls, "cache_mode": self.rt.mode}
        return np.stack(toks, axis=1), stats


class _ServeState:
    """Mutable per-session state behind ``add_request()``/``step()``: the
    scheduler, the paged arenas, the tick clock, counters and the pending
    outputs. ``reset`` starts a new one."""

    def __init__(self, eng: "ContinuousServeEngine", gen: GenerationConfig):
        self.gen = gen
        self.sched = Scheduler(eng.serving, eng.tiered,
                               policy=make_policy(eng.serving.policy), share_prefix=False)
        self.caches = M.init_paged_caches(eng.cfg, eng.rt, eng.serving, eng.device,
                                          eng.tiered)
        self.bpt0, self.bpt1 = eng._tier_bpt(self.caches)
        self.quantum = eng.serving.prefill_chunk or eng.serving.prefill_bucket
        self.last_tok = np.zeros((eng.serving.num_slots,), np.int32)
        self.results: dict[int, dict] = {}
        self.outputs: list[RequestOutput] = []       # pending (undrained)
        self.step_outputs: list[RequestOutput] = []  # this tick's events
        self.next_rid = 0
        self.step = 0                 # model-invocation tick clock
        self.decode_steps = self.live_steps = self.prefill_chunks = 0
        self.prefill_tokens = self.generated = 0
        self.traffic = self.prefill_write_bytes = 0.0
        self.util_peak = self.util_sum = 0.0
        self.util_n = 0
        self.has_deadlines = False
        self.trace_active: list[int] = []
        self.trace_util: list[float] = []
        self.t0 = time.time()


class ContinuousServeEngine:
    """Continuous batching over block-paged arenas, driven tick by tick.

    ``add_request()`` + ``step()`` is the request-centric interface (one
    engine tick per call, returning the tick's ``RequestOutput`` events);
    ``serve(requests, gen)`` resets the session, submits everything and
    drains. The decode clock is the time base: a request with
    ``arrival=t`` becomes admissible after t ticks."""

    def __init__(self, cfg: ModelConfig, params, rt: Optional[AttentionRuntime] = None,
                 serving: ServingCfg = ServingCfg(), device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.serving = serving
        try:
            serving.validate()
        except ValueError as e:
            raise SchedulerConfigError(str(e)) from None
        rt = rt or cfg.attention
        if (serving.use_paged_kernels is not None
                and rt.paged_kernels != serving.use_paged_kernels):
            rt = dataclasses.replace(rt, paged_kernels=serving.use_paged_kernels)
        unported = _unported_knobs(serving, rt, cfg)
        if unported:
            raise SchedulerConfigError(
                "not ported yet: " + "; ".join(unported))
        model_defs(cfg)  # raises NotImplementedError for unported layer kinds
        self.tiered = bool(serving.enable_escalation and rt.mode == "dense")
        if self.tiered and rt.cpq is None:
            rt = dataclasses.replace(rt, cpq=CPQCfg())
        self.rt = rt
        self.params = to_device(params, self.device)
        self.chunked = bool(serving.prefill_chunk)  # else one-shot admission
        self._n_cache_layers = sum(1 for m, _ in cfg.layer_kinds if m in ("attn", "mla"))
        self._st: Optional[_ServeState] = None

    # ------------------------------------------------------------- helpers

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=self.device)

    def _tier_bpt(self, caches) -> tuple[float, float]:
        """(base, escalated) per-token decode traffic per cache-bearing layer."""
        ps = self.serving.page_size
        for (mixer, _), c in zip(self.cfg.layer_kinds, M.per_layer(self.cfg, caches)):
            if mixer not in ("attn", "mla"):
                continue
            if isinstance(c, pgc.TieredPagedCache):
                return (pgc.bytes_per_token(c.dense, ps),
                        pgc.bytes_per_token(c.cpq, ps, self.rt.cpq))
            b = pgc.bytes_per_token(c, ps, self.rt.cpq)
            return b, b
        return 0.0, 0.0

    def _escalate(self, st: _ServeState, req: Request) -> None:
        """Move a running dense row to the CPQ tier: the scheduler hands its
        pages over, then every layer re-compresses its dense K/V."""
        slot, length = req.slot, req.length
        dense_row, cpq_row = st.sched.apply_escalation(req)
        M.escalate_slot(self.cfg, self.rt, st.caches, self._tensor(dense_row),
                        self._tensor(cpq_row), slot, int(length))

    def _rt_for_tier(self, tier: int) -> AttentionRuntime:
        return self.rt if tier == 0 else pgc._cpq_runtime(self.rt)

    def _bucketed(self, ctx: np.ndarray) -> tuple[np.ndarray, int]:
        """Right-pad a context to the prefill bucket with its edge token
        (padding never enters attention: causal mask, logits of the true
        last position, and pack positions past the slot's capacity land on
        the null page). Returns (padded, true length)."""
        S = len(ctx)
        b = self.serving.prefill_bucket
        S_pad = max(b, -(-S // b) * b)
        if S_pad == S:
            return ctx, S
        return np.concatenate([ctx, np.full((S_pad - S,), ctx[-1], np.int32)]), S

    def _admit(self, req: Request, st: _ServeState):
        """One-shot admission: prefill the whole bucket-padded context into
        a B=1 contiguous cache of the request's tier, pack it into the
        slot's pages, and take the first token from the true last
        position's logits. Returns (first token, padded length)."""
        sched = st.sched
        padded, S = self._bucketed(req.context)
        rt_t = self._rt_for_tier(req.tier)
        ctg = M.init_caches(self.cfg, rt_t, 1, len(padded), self.device)
        logits, ctg = M.prefill(self.cfg, rt_t, self.params, self._tensor(padded[None]), ctg,
                                last_index=S - 1)
        tables = sched.alt_block_tables if req.tier == 1 else sched.block_tables
        M.pack_prefill_caches(self.cfg, rt_t, st.caches, ctg, self._tensor(tables[req.slot]),
                              req.slot)
        sched.finish_prefill(req)
        return int(torch.argmax(logits, dim=-1)[0]), len(padded)

    def _prefill_chunk(self, req: Request, st: _ServeState):
        """Stream the next ``prefill_chunk`` prompt tokens straight into the
        request's arena pages; on the final chunk, take the first token from
        the last valid position's logits. Returns (first_token | None,
        valid tokens this chunk)."""
        sched = st.sched
        C = self.serving.prefill_chunk
        off = req.length
        valid = min(C, req.prefill_target - off)
        chunk = req.context[off:off + valid]
        if valid < C:  # pad with the edge token (masked everywhere)
            chunk = np.concatenate([chunk, np.full((C - valid,), chunk[-1], np.int32)])
        tables = sched.alt_block_tables if req.tier == 1 else sched.block_tables
        logits, _ = M.prefill_chunk_rows(
            self.cfg, self.rt, req.tier, off == 0, self.params,
            self._tensor(chunk[None]), req.slot, self._tensor(tables[req.slot]), off,
            valid, st.caches)
        sched.note_chunk(req, valid)
        if req.length < req.prefill_target:
            return None, valid
        sched.finish_prefill(req)
        return int(torch.argmax(logits, dim=-1)[0]), valid

    def _row_state(self, sched: Scheduler, active: np.ndarray) -> pgc.RowState:
        return pgc.RowState(lengths=self._tensor(sched.lengths),
                            block_table=self._tensor(sched.block_tables),
                            active=self._tensor(active),
                            tier=self._tensor(sched.tiers),
                            alt_block_table=(self._tensor(sched.alt_block_tables)
                                             if sched.tiered else None))

    # ------------------------------------------------- request-centric API

    def reset(self, gen: GenerationConfig = GenerationConfig()) -> None:
        """Start a fresh serving session: new scheduler, empty arenas, empty
        output buffer. ``gen`` supplies the session-wide ``eos_id`` and the
        temperature of scheduler ``Request`` objects that carry no
        SamplingParams (it must be 0: greedy)."""
        self._st = _ServeState(self, gen)

    def _ensure_state(self) -> _ServeState:
        if self._st is None:
            self.reset()
        return self._st

    def add_request(self, req: Union[ServeRequest, Request], *, stream=None) -> int:
        """Submit one request to the live session. Accepts the public
        ``ServeRequest`` or a scheduler ``Request``. Returns the request id."""
        st = self._ensure_state()
        if isinstance(req, ServeRequest):
            rid = req.rid if req.rid is not None else st.next_rid
            req = Request(rid=rid, prompt=req.prompt,
                          max_new_tokens=req.sampling.max_tokens,
                          arrival=req.arrival, sampling=req.sampling,
                          slo=req.slo, stream=stream or req.stream,
                          session_id=req.session_id)
        elif stream is not None:
            req.stream = stream
        temp = req.sampling.temperature if req.sampling is not None else st.gen.temperature
        _refuse_sampling(temp, f"request {req.rid}")
        if (req.rid in st.results
                or any(r.rid == req.rid for r in st.sched.queue)
                or any(r is not None and r.rid == req.rid for r in st.sched.slots)):
            raise SchedulerConfigError(
                f"request id {req.rid} already in use this session "
                "(omit ServeRequest.rid to auto-assign)")
        st.next_rid = max(st.next_rid, req.rid + 1)
        self._assign_deadlines(req, st)
        st.sched.submit(req)
        return req.rid

    def _assign_deadlines(self, req: Request, st: _ServeState) -> None:
        scale = self.serving.deadline_scale
        sp = req.sampling
        if sp is None:
            if scale <= 0:
                return
            sp = SamplingParams(max_tokens=req.max_new_tokens)
        req.ttft_deadline, req.deadline = derive_deadlines(
            sp, slo_of(req), req.arrival, scale)
        if np.isfinite(req.deadline) or np.isfinite(req.ttft_deadline):
            st.has_deadlines = True

    def has_unfinished(self) -> bool:
        return self._st is not None and self._st.sched.has_work()

    def pending_outputs(self) -> list[RequestOutput]:
        """Drain the buffered ``RequestOutput`` events."""
        st = self._ensure_state()
        out, st.outputs = st.outputs, []
        return out

    def results(self) -> dict[int, dict]:
        """Finished-request records so far: rid -> {tokens, finish_reason,
        admitted_step, token_steps, ...}."""
        return dict(self._st.results) if self._st is not None else {}

    # ----------------------------------------------------- result plumbing

    def _result_of(self, req: Request) -> dict:
        slo = req.slo
        return {
            "tokens": np.asarray(req.generated, np.int32),
            "session": req.session_id,
            "finish_reason": req.finish_reason,
            "arrival": req.arrival,
            "admitted_step": req.admitted_step,
            "first_token_step": req.first_token_step,
            "token_steps": np.asarray(req.token_steps, np.int64),
            "done_step": req.done_step,
            "preemptions": req.preemptions,
            "escalated": req.escalated,
            "deescalations": req.deescalations,
            "slo": slo.name if slo is not None else "standard",
            "priority": slo.priority if slo is not None else 1,
            "ttft_target": slo.ttft_target if slo is not None else float("inf"),
            "itl_target": slo.itl_target if slo is not None else float("inf"),
        }

    def _finish(self, st: _ServeState, req: Request, reason: str) -> None:
        st.sched.retire(req, st.step, reason)
        st.results[req.rid] = self._result_of(req)

    def _emit(self, st: _ServeState, req: Request, ev: RequestOutput) -> None:
        st.step_outputs.append(ev)
        st.outputs.append(ev)
        if req.stream is not None:
            req.stream(ev)

    def _emit_token(self, st: _ServeState, req: Request, tok: int, tick: int,
                    grow: bool = False) -> None:
        """Commit one token available at ``tick``; ``grow`` extends the
        cache bookkeeping (decode tokens). EOS, a stop token or the budget
        retires the request here and frees its pages at once."""
        req.generated.append(tok)
        req.token_steps.append(tick)
        if grow:
            req.length += 1
            st.sched.lengths[req.slot] += 1
        st.last_tok[req.slot] = tok
        st.generated += 1
        if req.first_token_step < 0:
            req.first_token_step = tick
        reason = ""
        if st.gen.eos_id >= 0 and tok == st.gen.eos_id:
            reason = "eos"
        elif tok in req.stop_ids:
            reason = "stop"
        elif req.num_generated >= req.max_new_tokens:
            reason = "max_tokens"
        if reason:
            self._finish(st, req, reason)
        self._emit(st, req, RequestOutput(rid=req.rid, token=int(tok),
                                          index=req.num_generated - 1, step=tick,
                                          finished=bool(reason), finish_reason=reason))

    def _expire_deadlines(self, st: _ServeState) -> None:
        """Tick-boundary deadline enforcement (finish_reason ``timeout``);
        skipped when no request carries a finite deadline."""
        if not st.has_deadlines:
            return
        sched, now = st.sched, st.step

        def blown(req):
            return (now >= req.deadline
                    or (req.first_token_step < 0 and now >= req.ttft_deadline))

        def timeout_event(req):
            return RequestOutput(rid=req.rid, token=-1, index=req.num_generated,
                                 step=now, finished=True, finish_reason="timeout")

        for req in list(sched.occupied()):
            if blown(req):
                self._finish(st, req, "timeout")
                sched.stats["timeouts"] += 1
                self._emit(st, req, timeout_event(req))
        for req in [r for r in sched.queue if blown(r)]:
            sched.queue.remove(req)
            req.state, req.done_step = "done", now
            req.finish_reason = "timeout"
            st.results[req.rid] = self._result_of(req)
            sched.stats["timeouts"] += 1
            self._emit(st, req, timeout_event(req))

    # ----------------------------------------------------------------- run

    def step(self) -> list[RequestOutput]:
        """Run ONE engine tick: admissions, the watermark escalation policy,
        at most one streamed prompt chunk, page growth (escalation or
        recompute preemption on exhaustion), and one decode step + greedy
        sampling over the running rows. Returns this tick's
        ``RequestOutput`` events.

        Clock model (the reference's): a tick that runs the decode step
        costs 1 and one prompt chunk rides along for free; a prefill-only
        tick also costs 1; a one-shot admission costs its padded length in
        ``prefill_bucket`` units before the tick's decode step."""
        st = self._ensure_state()
        st.step_outputs = []
        sched = st.sched
        if not sched.has_work():
            return []
        B = self.serving.num_slots

        # 0) deadline shedding before admissions, so freed slots refill now
        self._expire_deadlines(st)
        if not sched.has_work():
            return st.step_outputs

        # 1) admissions into vacated slots: chunked, their prompts stream
        #    below; one-shot, the whole prompt is prefilled now and the
        #    clock is charged its bucket-equivalents (the head-of-line stall)
        while (req := sched.admit_next(now=st.step, step=st.step)) is not None:
            if self.chunked:
                continue
            tok, padded = self._admit(req, st)
            st.step += -(-padded // st.quantum)
            st.prefill_tokens += req.length
            st.prefill_write_bytes += (req.length * (st.bpt1 if req.tier else st.bpt0)
                                       * self._n_cache_layers)
            self._emit_token(st, req, tok, st.step)  # ready after the stall

        # 1b) watermark policy: under critical pressure, running dense rows
        #     are re-compressed into the CPQ arena and their pages freed
        while (cand := sched.escalation_candidate()) is not None:
            self._escalate(st, cand)

        # 1c) recovery: a policy may de-escalate one T2 row per tick back to
        #     dense by re-admission (FIFO never volunteers one)
        if (cand := sched.deescalation_candidate()) is not None:
            sched.deescalate(cand)

        # 2) chunked-prefill pump: at most ONE prompt chunk per tick
        did_chunk = False
        fresh_slot = -1  # row whose prefill finished THIS tick
        if self.chunked and (pre := sched.prefilling()):
            req = pre[0]
            tok, valid = self._prefill_chunk(req, st)
            did_chunk = True
            st.prefill_chunks += 1
            st.prefill_tokens += valid
            st.prefill_write_bytes += (valid * (st.bpt1 if req.tier else st.bpt0)
                                       * self._n_cache_layers)
            if tok is not None:
                # available at the tick's end; the row decodes from next tick
                self._emit_token(st, req, tok, st.step + 1)
                if req.state == "running":
                    fresh_slot = req.slot

        # 3) growth: map a page for every running row's next write; out of
        #    pages, a dense grower first escalates itself to the CPQ arena,
        #    else the policy's victim (the youngest) is preempted
        for req in sorted(sched.running(), key=lambda r: r.admitted_step):
            if req.state != "running":
                continue
            while not sched.ensure_writable(req):
                if req.length // self.serving.page_size >= self.serving.max_blocks_per_slot:
                    self._finish(st, req, "length_cap")
                    break
                if self.tiered and req.tier == 0 and sched.cpq_alloc.can_alloc(
                        pgc.pages_needed(req.length + 1, self.serving.page_size)):
                    self._escalate(st, req)
                    continue
                victim = sched.preemption_victim(exclude=req)
                if victim is None:
                    self._finish(st, req, "oom")
                    break
                sched.preempt(victim)

        active = sched.active_mask()
        if fresh_slot >= 0:
            active[fresh_slot] = False

        if not active.any():
            if did_chunk:
                st.step += 1     # prefill-only tick still costs a tick
                return st.step_outputs
            if not sched.occupied():
                if sched.queue and sched.policy.select_admission(sched, st.step) is not None:
                    return st.step_outputs
                cands = sched.policy.admission_order(sched, st.step)
                if cands and cands[0].arrival <= st.step:
                    # empty machine and the head still does not fit: never will
                    req = cands[0]
                    sched.queue.remove(req)
                    req.state, req.done_step = "done", st.step
                    req.finish_reason = "unschedulable"
                    st.results[req.rid] = self._result_of(req)
                    return st.step_outputs
                if sched.queue:  # idle: jump the clock to the next arrival
                    nxt = (cands[0].arrival if cands
                           else min(r.arrival for r in sched.queue))
                    st.step = max(st.step + 1, int(np.ceil(nxt)))
            return st.step_outputs

        # 4) one decode step over per-row positions (rows still prefilling,
        #    and a row whose last chunk landed this tick, write the null page)
        rows = self._row_state(sched, active)
        logits, _ = M.decode_step_rows(self.cfg, self.rt, self.params,
                                       self._tensor(st.last_tok[:, None]), rows,
                                       st.caches)
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        st.decode_steps += 1
        st.live_steps += int(active.sum())
        st.traffic += float(sum(
            (sched.lengths[s] + 1.0) * (st.bpt1 if sched.tiers[s] else st.bpt0)
            for s in range(B) if active[s])) * self._n_cache_layers
        util = sched.dense_alloc.utilization
        st.util_peak = max(st.util_peak, util)
        st.util_sum += util
        st.util_n += 1
        st.trace_active.append(int(active.sum()))
        st.trace_util.append(util)
        st.step += 1
        for slot in range(B):
            if active[slot]:
                self._emit_token(st, sched.slots[slot], int(toks[slot]), st.step,
                                 grow=True)
        return st.step_outputs

    def stats(self) -> dict:
        """Session counters, in the shape of the reference engine's."""
        st = self._ensure_state()
        sched = st.sched
        B = self.serving.num_slots
        wall = time.time() - st.t0
        total_bytes = pgc.arena_bytes(st.caches)
        return {
            "cache_mode": self.rt.mode,
            "tiered": self.tiered,
            "chunked_prefill": self.chunked,
            "prefix_sharing": False,
            "spec_on": False,
            "spec_accept_rate": (sched.stats["spec_accepted"]
                                 / max(sched.stats["spec_drafted"], 1)),
            "policy": sched.policy.name,
            "model_shards": 1,
            "arena_bytes_total": total_bytes,
            "arena_bytes_per_device": float(total_bytes),
            "interconnect_bytes": 0.0,
            "interconnect_bytes_per_token": 0.0,
            "decode_steps": st.decode_steps,
            "prefill_chunks": st.prefill_chunks,
            "prefill_tokens": st.prefill_tokens,
            "generated_tokens": st.generated,
            "tokens_per_step": st.generated / max(st.decode_steps, 1),
            "slot_utilization": st.live_steps / max(st.decode_steps * B, 1),
            "arena_utilization_mean": st.util_sum / max(st.util_n, 1),
            "arena_utilization_peak": st.util_peak,
            "trace_active_rows": np.asarray(st.trace_active, np.int32),
            "trace_arena_util": np.asarray(st.trace_util, np.float64),
            "decode_traffic_bytes": st.traffic,
            "prefill_write_bytes": st.prefill_write_bytes,
            "bytes_per_token_layer": st.bpt0,
            "wall_time_s": wall,
            "tokens_per_s": st.generated / max(wall, 1e-9),
            "dense_pages_leaked": sched.dense_alloc.num_used,
            "cpq_pages_leaked": sched.cpq_alloc.num_used if sched.cpq_alloc else 0,
            **sched.stats,
            **sched.arena_stats(),
        }

    def serve(self, requests: list[Union[Request, ServeRequest]],
              gen: GenerationConfig = GenerationConfig()):
        """Reset the session, submit every request in arrival order and
        drain with ``step()``. Returns (results, stats)."""
        self.reset(gen)
        st = self._st
        for r in sorted(requests, key=lambda r: r.arrival):
            self.add_request(r)
        while st.sched.has_work():
            self.step()
        return dict(st.results), self.stats()

    def generate(self, batch: dict, gen: GenerationConfig = GenerationConfig()):
        """One batch of equal requests: {'tokens': (B, S)} -> (tokens
        (B, max_new) right-padded with eos or 0, stats)."""
        prompt = np.asarray(batch["tokens"])
        reqs = [Request(rid=i, prompt=prompt[i], max_new_tokens=gen.max_new_tokens)
                for i in range(prompt.shape[0])]
        results, stats = self.serve(reqs, gen)
        pad = gen.eos_id if gen.eos_id >= 0 else 0
        out = np.full((prompt.shape[0], gen.max_new_tokens), pad, np.int32)
        for i in range(prompt.shape[0]):
            t = results[i]["tokens"]
            out[i, :len(t)] = t[:gen.max_new_tokens]
        return out, stats
