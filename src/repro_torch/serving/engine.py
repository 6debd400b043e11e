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
``cpq`` (T2: the whole arena holds int8 CPQ codes), ``retrieval`` (T3:
K and V pages beside int8 proxy-code pages; decode attends the top-k keys
by proxy score plus a recent window, prefill attends densely) and
``decomposed_cpq`` (T1+T2: X in CPQ codes). MLA layers cache their latent
(in CPQ codes in mode ``cpq``) whatever the mode; MoE stacks always take
one-shot admission, since their capacity routing depends on the token
group, and tier escalation refuses MLA stacks, as in the reference.
Recurrent layers (Mamba, mLSTM, sLSTM: xlstm-125m, Jamba's hybrid) keep
one state row a slot beside the arenas; their stacks admit one-shot at the
exact prompt length (bucket padding would enter the state), and the clock
is charged that length in ``prefill_chunk`` (else ``prefill_bucket``)
units. With
``ServingCfg(enable_escalation=True)`` a dense engine is tiered: every
layer pairs its dense arena with a CPQ escalation arena, new admissions go
to the CPQ tier while the dense arena's free fraction is below
``low_watermark``, and below ``critical_watermark`` (or when a dense row
cannot grow) running dense rows are re-compressed into it. As in the
reference, escalation with any other mode leaves the engine untiered.

Sampling is per request: ``SamplingParams`` fill per-row temperature /
top-k / top-p / seed arrays read by one sampler (``sample_token_rows``), and a
row's token ``i`` is drawn with ``fold_in(PRNGKey(seed), i)`` through the
port's Threefry (``serving/prng.py``), so seeded streams are the reference's
and survive preemption. A batch whose rows are all greedy takes the single
argmax and never enters the sampler.

The continuous engine also serves the rest of the reference's tick: prefix
sharing with copy-on-write (``ServingCfg.share_prefix``; admissions mount
registered full pages of an earlier context, and a write into a shared page
splits it first), periodic defrag of the base arenas (``defrag_every``),
the ``priority`` and ``slo`` scheduling policies, and speculative decoding
(``spec_len``: prompt-lookup drafts verified by one chunked forward pass
through B2, see ``serving/speculative.py``). Sharing and speculation follow
the reference's gate: chunked admissions over the dense or T1 arena (the
dense arm of a tiered arena).

The static engine also serves the non-token inputs: an audio model's frames
(musicgen, whose decode feeds its codes as tokens) and a text+patches
model's patches, which its cross-attention layers attend over
(llama-vision). The continuous engine drives token prompts only and refuses
the others with ``SchedulerConfigError``, as the reference does.

The continuous engine also carries the surface the replica router
(``serving/router.py``) drives: ``adopt_compiled`` (replicas share one
device weight tree), ``arena_stats``, a host-only ``health`` probe,
``queued_requests``, ``outstanding_tokens``, and the ``drain`` /
``drain_request`` snapshots that replay elsewhere through recompute
preemption, then ``release`` of the arenas.

The continuous engine also serves over a device mesh (``mesh=``, from
``launch/mesh.make_serve_mesh``): every paged arena is split over the
mesh's model axis, a head shard a device, and the attends run per shard
(``serving/sharded.py``); the weights, the scheduler and the sampler stay
on the lead device. ``stats()`` reports the shards, the arena bytes in all
and on each device, and the interconnect bytes by the reference's
accounting. The static engine takes no mesh, as in the reference.

Both engines run on the GPU unless ``device`` names another device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs import AttentionRuntime, CPQCfg, ModelConfig, ServingCfg
from repro_torch.distributed.sharding import Mesh, canonical_device
from repro_torch.models import model as M
from repro_torch.models.transformer import RECURRENT
from repro_torch.params import model_defs, resolve_device, to_device
from repro_torch.serving import paged_cache as pgc
from repro_torch.serving import prng, sharded
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


def _unported_model(rt: AttentionRuntime, cfg: ModelConfig) -> list[str]:
    """The runtime and model settings neither engine serves yet, each with
    its ROADMAP item."""
    out = []
    if rt.mode in pgc.UNPORTED_MODES:
        out.append(f"mode={rt.mode!r} (ROADMAP {pgc.UNPORTED_MODES[rt.mode]})")
    return out


NEG = -1e30  # the masked logit of the top-k / top-p filters


def _nucleus_threshold(desc: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """The top-p cut over descending logits: the value at index ``j`` =
    #(cumulative probability < top_p), clamped to the last index (JAX's
    ``take_along_axis`` clamps there; ``torch.gather`` would raise). The
    probabilities are built as ``jax.nn.softmax`` builds them.
    desc (B, V); top_p broadcasts against (B, 1). Returns (B, 1)."""
    e = torch.exp(desc - desc.amax(dim=-1, keepdim=True))
    cum = torch.cumsum(e / e.sum(dim=-1, keepdim=True), dim=-1)
    j = (cum < top_p).sum(dim=-1, keepdim=True)
    return torch.gather(desc, 1, j.clamp(max=desc.shape[-1] - 1))


def sample_tokens(logits: torch.Tensor, key: Optional[torch.Tensor],
                  gen: GenerationConfig) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 samples of the static engine (greedy /
    temperature / top-p, one key for the whole batch; ``key`` is unused
    when greedy)."""
    if gen.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    # divide by a device tensor: CUDA multiplies by the reciprocal of a
    # host scalar, the reference divides
    t = torch.full((1,), gen.temperature, dtype=torch.float32, device=logits.device)
    l = logits.float() / t
    if gen.top_p < 1.0:
        desc = torch.sort(l, dim=-1, descending=True).values
        p = torch.full((1,), gen.top_p, dtype=torch.float32, device=logits.device)
        l = torch.where(l < _nucleus_threshold(desc, p), NEG, l)
    return prng.categorical(key, l).to(torch.int32)


def perturbed_logits(logits: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                     top_ps: torch.Tensor, seeds: torch.Tensor,
                     indices: torch.Tensor) -> torch.Tensor:
    """What a sampled row of ``sample_token_rows`` takes the argmax of: its
    logits over its temperature, top-k and top-p filtered (``top_k == 0``
    and ``top_p == 1`` disable a filter; filtered logits are -1e30), plus
    the Gumbel noise of ``fold_in(PRNGKey(seed), index)``. (B, V) float32
    (greedy rows are divided by 1)."""
    V = logits.shape[-1]
    l = logits.float() / torch.where(temps > 0, temps, 1.0)[:, None]
    # per-row top-k: mask everything below the k-th largest (k = V when off)
    desc = torch.sort(l, dim=-1, descending=True).values
    k = torch.clamp(torch.where(top_ks > 0, top_ks, V), 1, V).long()
    l = torch.where(l < torch.gather(desc, 1, (k - 1)[:, None]), NEG, l)
    # per-row top-p over the top-k-filtered distribution
    desc = torch.sort(l, dim=-1, descending=True).values
    l = torch.where(l < _nucleus_threshold(desc, top_ps[:, None]), NEG, l)
    keys = prng.fold_in(prng.PRNGKey(seeds), indices)
    return prng.gumbel(keys, (V,)) + l


def sample_token_rows(logits: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                      top_ps: torch.Tensor, seeds: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
    """Per-request sampler: (B, V) logits and per-row (B,) temperature /
    top-k / top-p / seed / stream index -> (B,) int32 tokens, on the
    logits' device. Greedy rows (``temps <= 0``) take the argmax of the
    raw logits; sampled rows the argmax of ``perturbed_logits`` (the
    Gumbel-max draw of ``jax.random.categorical``), so a draw depends on the
    request alone, not on its slot, the batch or its preemptions."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = torch.argmax(perturbed_logits(logits, temps, top_ks, top_ps, seeds, indices),
                           dim=-1).to(torch.int32)
    return torch.where(temps <= 0.0, greedy, sampled)


# --------------------------------------------------------------- static engine


class ServeEngine:
    """Static-batch engine: one batch of equal-length prompts, prefilled
    into contiguous arenas and decoded to the end at one shared position.
    The contiguous-arena baseline."""

    def __init__(self, cfg: ModelConfig, params, rt: Optional[AttentionRuntime] = None,
                 max_len: int = 4096, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rt = rt or cfg.attention
        unported = _unported_model(self.rt, cfg)
        if unported:
            raise SchedulerConfigError("not ported yet: " + "; ".join(unported))
        if self.rt.mesh is not None:
            raise SchedulerConfigError(
                "the static ServeEngine serves on one device, as the reference's "
                "does: serve over a mesh with ContinuousServeEngine")
        model_defs(cfg)  # raises ValueError for an unknown layer or input kind
        M.check_inputs(cfg)
        self.params = to_device(params, self.device)
        self.max_len = max_len

    def _inputs(self, batch: dict) -> dict:
        """The batch on the engine's device: tokens as given, frames and
        patches cast to the parameter dtype."""
        out = {}
        for name, a in batch.items():
            t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
            t = t.to(self.device)
            out[name] = t if name == "tokens" else t.to(self.cfg.param_dtype)
        return out

    def generate(self, batch: dict, gen: GenerationConfig = GenerationConfig()):
        """batch: {'tokens': (B, S)}, an audio model's {'frames': (B, S, D)}
        or a text+patches model's {'tokens': (B, S), 'patches': (B, P, D)}.
        Returns (generated (B, n) int32, n <=
        max_new_tokens, stats). With ``eos_id`` rows past their EOS emit
        ``eos_id``, the EOS itself counts as generated, and the run stops
        once every row has emitted one. Sampling (``temperature > 0``)
        draws the first token with ``PRNGKey(seed)`` and each later one
        with the next ``split`` of the key chain, as the reference does."""
        cfg = self.cfg
        inputs = self._inputs(batch)
        B, S = (inputs["tokens"] if "tokens" in inputs else inputs["frames"]).shape[:2]
        if S > self.max_len:
            raise ValueError(f"ServeEngine.generate: prompts of {S} tokens exceed "
                             f"max_len={self.max_len}")
        caches = M.init_caches(cfg, self.rt, B, S + gen.max_new_tokens, self.device)
        logits, caches = M.prefill(cfg, self.rt, self.params, inputs, caches)

        toks = []
        done = np.zeros((B,), bool)
        live_tokens = decode_calls = 0
        sampled = gen.temperature > 0.0
        key = sub = prng.PRNGKey(gen.seed, device=self.device) if sampled else None
        tok = sample_tokens(logits, key, gen).cpu().numpy()
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
            if sampled:
                key, sub = prng.split(key)
            logits, caches = M.decode_step(cfg, self.rt, self.params,
                                           torch.as_tensor(tok[:, None], device=self.device),
                                           S + t, caches)
            decode_calls += 1
            tok = sample_tokens(logits, sub, gen).cpu().numpy()
        stats = {"prompt_tokens": int(B * S), "generated_tokens": live_tokens,
                 "decode_steps": decode_calls, "cache_mode": self.rt.mode}
        return np.stack(toks, axis=1), stats


class _ServeState:
    """Mutable per-session state behind ``add_request()``/``step()``: the
    scheduler, the paged arenas, the per-slot sampling arrays, the tick
    clock, counters and the pending outputs. ``reset`` starts a new one."""

    def __init__(self, eng: "ContinuousServeEngine", gen: GenerationConfig):
        B = eng.serving.num_slots
        self.gen = gen
        self.sched = Scheduler(eng.serving, eng.tiered, policy=eng.make_policy(),
                               share_prefix=eng.share_prefix)
        self.caches = M.init_paged_caches(eng.cfg, eng.rt, eng.serving, eng.device,
                                          eng.tiered)
        self.bpt0, self.bpt1 = eng._tier_bpt(self.caches)
        self.quantum = eng.serving.prefill_chunk or eng.serving.prefill_bucket
        self.last_tok = np.zeros((B,), np.int32)
        # per-slot sampling parameters (rows set on admission, reset to
        # greedy when the slot is vacated)
        self.temp = np.zeros((B,), np.float32)
        self.top_k = np.zeros((B,), np.int32)
        self.top_p = np.ones((B,), np.float32)
        self.seed = np.zeros((B,), np.int32)
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
        self.defrag_mark = 0          # retirements at the last compaction
        self.trace_active: list[int] = []
        self.trace_util: list[float] = []
        self.t0 = time.time()
        # interconnect accounting under model sharding (the reference's):
        # each device sends its per-head output partial and receives the
        # others', (mp - 1) / mp of the concatenated head outputs a token a
        # layer whose arena is head-split (exact for the per-shard tiers; the
        # CPQ-X tiers replicate their code pools and are not charged) ...
        mp = eng.model_shards
        cfg = eng.cfg
        dv = cfg.mla.v_head_dim if cfg.mla is not None else cfg.head_dim
        n_concat = sum(
            1 for m, _ in cfg.layer_kinds
            if (m == "attn" and (eng.tiered or eng.rt.mode in
                                 ("dense", "cpq", "decomposed", "retrieval")))
            or (m == "mla" and eng.rt.mode != "cpq"))
        self.concat_bpt = (0.0 if mp <= 1 else
                           (mp - 1) / mp * cfg.num_heads * dv * cfg.param_dtype.itemsize
                           * n_concat)
        # ... plus, for split latent pools (T1 X / MLA c_kv), their gather,
        # charged once a model invocation
        self.gather_bps = eng._latent_gather_bytes_per_step(self.caches)
        self.interconnect = 0.0


class ContinuousServeEngine:
    """Continuous batching over block-paged arenas, driven tick by tick.

    ``add_request()`` + ``step()`` is the request-centric interface (one
    engine tick per call, returning the tick's ``RequestOutput`` events);
    ``serve(requests, gen)`` resets the session, submits everything and
    drains. The decode clock is the time base: a request with
    ``arrival=t`` becomes admissible after t ticks. ``policy`` (a policy
    object or name) overrides ``ServingCfg.policy``. ``mesh`` (or
    ``rt.mesh``) serves over a device mesh: the engine's device is then
    the mesh's first, and the arenas are split over its model axis."""

    def __init__(self, cfg: ModelConfig, params, rt: Optional[AttentionRuntime] = None,
                 serving: ServingCfg = ServingCfg(), mesh=None, policy=None, device=None):
        self.cfg = cfg
        self.serving = serving
        try:
            serving.validate()
        except ValueError as e:
            raise SchedulerConfigError(str(e)) from None
        rt = rt or cfg.attention
        if mesh is not None:
            if rt.mesh is not None and rt.mesh != mesh:
                raise SchedulerConfigError(
                    "conflicting device meshes: rt.mesh and the mesh= "
                    "argument disagree — set one or make them equal")
            rt = dataclasses.replace(rt, mesh=mesh)
        self.mesh = rt.mesh
        if self.mesh is not None:
            if not isinstance(self.mesh, Mesh):
                raise SchedulerConfigError(
                    f"mesh must be a repro_torch.distributed.sharding.Mesh "
                    f"(launch.mesh.make_serve_mesh), not {type(self.mesh).__name__}")
            lead = self.mesh.devices.reshape(-1)[0]
            if device is not None and canonical_device(device) != lead:
                raise SchedulerConfigError(
                    f"device={device} is not the mesh's first device {lead}")
            device = lead
        self.device = resolve_device(device)
        if (serving.use_paged_kernels is not None
                and rt.paged_kernels != serving.use_paged_kernels):
            rt = dataclasses.replace(rt, paged_kernels=serving.use_paged_kernels)
        unported = _unported_model(rt, cfg)
        if unported:
            raise SchedulerConfigError(
                "not ported yet: " + "; ".join(unported))
        model_defs(cfg)  # raises ValueError for an unknown layer or input kind
        self.tiered = bool(serving.enable_escalation and rt.mode == "dense")
        if self.tiered and rt.cpq is None:
            rt = dataclasses.replace(rt, cpq=CPQCfg())
        if self.tiered and any(m == "mla" for m, _ in cfg.layer_kinds):
            raise SchedulerConfigError(
                "tier escalation supports plain-attention stacks only "
                "(MLA already caches the compressed latent)")
        if cfg.input_kind != "tokens":
            raise SchedulerConfigError(
                "continuous serving drives token prompts; "
                f"input_kind={cfg.input_kind!r} needs the static engine")
        M.check_inputs(cfg)
        self.rt = rt
        # mesh-native serving: the model axis must divide every head and
        # latent axis it splits (1 = no model sharding)
        self.model_shards = sharded.validate_serve_mesh(cfg, rt, self.tiered)
        self.params = to_device(params, self.device)
        # recurrent mixers integrate every prefill token into their state, so
        # bucket padding would pollute it (attention only masks): such stacks
        # prefill at their exact length, as the reference does
        self._exact_prefill = any(m in RECURRENT for m, _ in cfg.layer_kinds)
        # two layer families keep one-shot admission, as in the reference:
        # recurrent state cannot be cut at page boundaries, and capacity-factor
        # MoE routing is a function of the token group (chunking a prompt
        # would change its drops)
        self.chunked = (bool(serving.prefill_chunk) and not self._exact_prefill
                        and not any(mlp == "moe" for _, mlp in cfg.layer_kinds))
        # prefix sharing and speculation need chunked admission (a tail or
        # a verify chunk streams from a mid-context offset) and a base arena
        # whose payload is purely positional: dense, T1, or a tiered
        # arena's dense arm; CPQ and T3 pages read through per-slot state
        self.share_prefix = (serving.share_prefix and self.chunked
                             and rt.mode in ("dense", "decomposed"))
        self.spec_on = (serving.spec_len > 0 and self.chunked
                        and rt.mode in ("dense", "decomposed"))
        self.policy = policy
        self._n_cache_layers = sum(1 for m, _ in cfg.layer_kinds if m in ("attn", "mla"))
        self._st: Optional[_ServeState] = None

    def make_policy(self):
        """The session's scheduling policy: an explicit object wins, a name
        (constructor argument or ``ServingCfg.policy``) goes through the
        factory. Called once per session (``reset``)."""
        if self.policy is None:
            return make_policy(self.serving.policy)
        if isinstance(self.policy, str):
            return make_policy(self.policy)
        return self.policy

    # ------------------------------------------------------------- helpers

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=self.device)

    def _tier_bpt(self, caches) -> tuple[float, float]:
        """(base, escalated) per-token decode traffic per cache-bearing layer."""
        ps = self.serving.page_size
        for (mixer, _), c in zip(self.cfg.layer_kinds, M.per_layer(self.cfg, caches)):
            if mixer not in ("attn", "mla"):
                continue
            c = pgc.logical_of(c)
            if isinstance(c, pgc.TieredPagedCache):
                return (pgc.bytes_per_token(c.dense, ps),
                        pgc.bytes_per_token(c.cpq, ps, self.rt.cpq))
            b = pgc.bytes_per_token(c, ps, self.rt.cpq)
            return b, b
        return 0.0, 0.0

    def _latent_gather_bytes_per_step(self, caches) -> float:
        """Interconnect bytes ONE model invocation moves gathering the split
        latent pools (``PagedXCache.x``, serving/sharded.py): each device
        ships its feature shard to the mp - 1 others, a latent layer. Zero
        unsharded. It dwarfs the per-head output concat: the price of
        splitting the latent for capacity, paid every step."""
        mp = self.model_shards
        if mp <= 1:
            return 0.0
        total = 0
        for c in M.per_layer(self.cfg, caches):
            x = pgc.logical_of(c)
            if isinstance(x, pgc.PagedXCache) and x.x.shape[-1] % mp == 0:
                total += x.x.numel() * x.x.element_size()
        return total * (mp - 1) / mp

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
        the null page); a recurrent stack's bucket is 1. Returns (padded,
        true length)."""
        S = len(ctx)
        b = 1 if self._exact_prefill else self.serving.prefill_bucket
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
        batch = {"tokens": self._tensor(padded[None])}
        logits, ctg = M.prefill(self.cfg, rt_t, self.params, batch, ctg, last_index=S - 1)
        tables = sched.alt_block_tables if req.tier == 1 else sched.block_tables
        M.pack_prefill_caches(self.cfg, rt_t, st.caches, ctg, self._tensor(tables[req.slot]),
                              req.slot)
        sched.finish_prefill(req)
        return self._sample_one(req, logits), len(padded)

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
        return self._sample_one(req, logits), valid

    # ---------------------------------------------------- per-row sampling

    def _resolve_sampling(self, req: Request, st: _ServeState) -> None:
        """Pin the request's SamplingParams (a scheduler Request without
        them derives them from the session GenerationConfig once) and load
        them into the slot's row of the sampling arrays."""
        if req.sampling is None:
            g = st.gen
            req.sampling = SamplingParams(temperature=g.temperature, top_p=g.top_p,
                                          max_tokens=req.max_new_tokens,
                                          seed=(g.seed + req.rid) & 0x7fffffff)
        s = req.slot
        st.temp[s] = req.sampling.temperature
        st.top_k[s] = req.sampling.top_k
        st.top_p[s] = req.sampling.top_p
        st.seed[s] = req.sampling.seed & 0x7fffffff

    def _sample_rows(self, logits: torch.Tensor, temp, top_k, top_p, seed,
                     index) -> np.ndarray:
        """``sample_token_rows`` over host per-row arrays; the draws come
        back to the host."""
        f32 = lambda a: self._tensor(np.asarray(a, np.float32))  # noqa: E731
        i32 = lambda a: self._tensor(np.asarray(a, np.int32))    # noqa: E731
        return sample_token_rows(logits, f32(temp), i32(top_k), f32(top_p),
                                 i32(seed), i32(index)).cpu().numpy()

    def _sample_one(self, req: Request, logits: torch.Tensor) -> int:
        """First token at the end of a prefill, at stream index
        ``num_generated`` (0 on admission, the replay index after a
        preemption). Greedy requests take the argmax."""
        sp = req.sampling
        if sp.temperature <= 0.0:
            return int(torch.argmax(logits, dim=-1)[0])
        return int(self._sample_rows(logits, [sp.temperature], [sp.top_k], [sp.top_p],
                                     [sp.seed & 0x7fffffff], [req.num_generated])[0])

    def _sample_active(self, st: _ServeState, logits: torch.Tensor) -> np.ndarray:
        """One sampling call over the decode batch, row r at its request's
        stream index; inactive rows draw garbage the caller never reads. A
        batch whose rows are all greedy takes the single argmax and never
        enters the sampler."""
        if (st.temp <= 0.0).all():
            return torch.argmax(logits, dim=-1).cpu().numpy()
        idx = [r.num_generated if (r := st.sched.slots[s]) is not None else 0
               for s in range(self.serving.num_slots)]
        return self._sample_rows(logits, st.temp, st.top_k, st.top_p, st.seed, idx)

    def _clear_row_sampling(self, st: _ServeState, slot: int) -> None:
        """Reset a vacated slot's sampling row to greedy, so that a retired
        sampled request does not keep the batch off the argmax short cut."""
        if slot < 0:
            return
        st.temp[slot] = 0.0
        st.top_k[slot] = 0
        st.top_p[slot] = 1.0
        st.seed[slot] = 0

    def _row_state(self, sched: Scheduler, active: np.ndarray) -> pgc.RowState:
        return pgc.RowState(lengths=self._tensor(sched.lengths),
                            block_table=self._tensor(sched.block_tables),
                            active=self._tensor(active),
                            tier=self._tensor(sched.tiers),
                            alt_block_table=(self._tensor(sched.alt_block_tables)
                                             if sched.tiered else None))

    # ------------------------------------------------- request-centric API

    def reset(self, gen: GenerationConfig = GenerationConfig()) -> None:
        """Start a fresh serving session: new scheduler (a fresh policy),
        empty arenas, empty output buffer. ``gen`` supplies the session-wide
        ``eos_id`` and the SamplingParams derived for scheduler ``Request``
        objects that carry none."""
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

    # ------------------------------------------------ router support surface

    def adopt_compiled(self, other: "ContinuousServeEngine") -> None:
        """Share ``other``'s device weight tree. The reference shares its
        jitted step functions here; the port compiles nothing, and what
        data-parallel replicas of one (cfg, rt) on one device share is the
        weights: N replicas, one copy of the weights, N arenas.
        ``ServingCfg`` may differ."""
        assert other.cfg == self.cfg and other.rt == self.rt, (
            "adopt_compiled requires an identical (cfg, rt) pair")
        assert other.device == self.device, (
            f"adopt_compiled across devices ({other.device} vs {self.device})")
        self.params = other.params

    def arena_stats(self) -> dict:
        """The scheduler's allocator counters plus the dense free-page
        fraction, which placement policies read."""
        sched = self._ensure_state().sched
        return {**sched.arena_stats(), "free_frac": sched.free_frac()}

    def health(self) -> dict:
        """The router's health probe: host bookkeeping only (no device
        tensor is read, nothing syncs). ``progress`` moves whenever the
        engine does anything (tick clock + admissions + retirements);
        ``exhausted`` is False here, and fault injection overrides it."""
        st = self._st
        if st is None:
            return {"alive": True, "has_work": False, "queued": 0,
                    "progress": 0, "free_frac": 1.0, "exhausted": False}
        sched = st.sched
        return {"alive": True,
                "has_work": sched.has_work(),
                "queued": len(sched.queue),
                "progress": (st.step + sched.stats["admitted"]
                             + sched.stats["retired"]),
                "free_frac": sched.free_frac(),
                "exhausted": False}

    def queued_requests(self) -> list[Request]:
        """The admission queue, in order (a read-only copy)."""
        st = self._st
        return list(st.sched.queue) if st is not None else []

    def drain_request(self, rid: int) -> Optional[Request]:
        """Snapshot one incomplete request for replay elsewhere and free its
        pages (the router's ``rebalance``). A resident row (decoding or
        mid-prefill) leaves through recompute preemption; a queued request
        is simply removed. Returns the Request (context = prompt +
        generated so far, pinned SamplingParams) or None when ``rid`` is
        not incomplete here."""
        st = self._st
        if st is None:
            return None
        sched = st.sched
        for req in sched.occupied():
            if req.rid == rid:
                slot = req.slot
                sched.preempt(req)          # pages freed, state -> queued
                self._clear_row_sampling(st, slot)
                sched.queue.remove(req)     # preempt requeued at the front
                return req
        for req in list(sched.queue):
            if req.rid == rid:
                sched.queue.remove(req)
                return req
        return None

    def outstanding_tokens(self) -> int:
        """Work still owed across queued and resident requests: prefill
        tokens not yet in the arena plus undelivered generation budget (the
        load that least-outstanding placement balances)."""
        st = self._st
        if st is None:
            return 0
        total = 0
        for r in list(st.sched.queue) + st.sched.occupied():
            total += max(len(r.prompt) + r.num_generated - r.length, 0)
            total += max(r.max_new_tokens - r.num_generated, 0)
        return total

    def drain(self) -> list[Request]:
        """Snapshot every incomplete request (queued, mid-prefill or
        decoding) for replay elsewhere and free their pages. Slot holders
        leave through recompute preemption, then the whole queue is handed
        over, by (arrival, rid). Greedy rows are deterministic and seeded
        rows draw ``fold_in(seed, token_index)``, so a replayed stream goes
        on token for token. Results and counters stay here; ``release()``
        drops the arenas."""
        st = self._st
        if st is None:
            return []
        sched = st.sched
        for req in sorted(sched.occupied(), key=lambda r: r.admitted_step):
            slot = req.slot
            sched.preempt(req)
            self._clear_row_sampling(st, slot)
        out = sorted(sched.queue, key=lambda r: (r.arrival, r.rid))
        sched.queue.clear()
        return out

    def release(self) -> None:
        """Drop the serving session: scheduler, arenas (their device memory
        is freed with them), sampling rows and output buffers. The next
        ``add_request()`` / ``reset()`` starts a fresh session."""
        self._st = None

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
        slot = req.slot
        st.sched.retire(req, st.step, reason)
        self._clear_row_sampling(st, slot)
        st.results[req.rid] = self._result_of(req)

    def _preempt(self, st: _ServeState, req: Request) -> None:
        slot = req.slot
        st.sched.preempt(req)
        self._clear_row_sampling(st, slot)

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

    def _cow_guard(self, st: _ServeState, req: Request) -> bool:
        """Copy-on-write valve before ``req``'s next cache write (a tail
        chunk or a decode token): if the target block maps a shared page,
        the scheduler splits it and the page copy duplicates the payload in
        every attention layer. Out of pages, the policy's victim is
        preempted, or ``req`` itself as the last resort. Returns False iff
        ``req`` was preempted (its write is skipped this tick)."""
        sched = st.sched
        while True:
            try:
                plan = sched.cow_plan(req)
            except pgc.PageAllocator.OutOfPages:
                victim = sched.preemption_victim(exclude=req)
                self._preempt(st, victim if victim is not None else req)
                if victim is None:
                    return False
                continue
            if plan is not None:
                M.copy_page_caches(self.cfg, self.rt, st.caches, *plan)
            return True

    # ------------------------------------------------- speculative decoding

    def _spec_eligible(self, req: Request) -> bool:
        """Whether a row can take a speculative step this tick: running on
        tier 0 (drafts alias dense pages), not opted out, with a budget of
        at least the verify draw plus one candidate."""
        sp = req.sampling
        return (req.state == "running" and req.tier == 0
                and req.draft is None
                and (sp is None or sp.speculate)
                and req.max_new_tokens - req.num_generated >= 2)

    def _verify_draws(self, req: Request, logits: torch.Tensor) -> np.ndarray:
        """The request's own draws at every chunk position: row i (position
        ``length + i``) at stream index ``num_generated + i``, through the
        decode path's sampler (the argmax for greedy rows). logits (C, V);
        padding rows draw garbage the caller never reads."""
        sp = req.sampling
        if sp is None or sp.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        C = logits.shape[0]
        return self._sample_rows(logits, [sp.temperature] * C, [sp.top_k] * C,
                                 [sp.top_p] * C, [sp.seed & 0x7fffffff] * C,
                                 req.num_generated + np.arange(C))

    def _speculate_row(self, st: _ServeState, req: Request) -> bool:
        """One speculative step of a running row: draft up to ``spec_len``
        tokens from its own context, open the draft (aliased history plus
        scratch pages), run one verify chunk over [last token, draft ...] at
        positions ``length .. length+k``, and commit the longest run of
        candidates equal to the request's own draws; every committed token
        lands this tick. The verify chunk is one model invocation and costs
        one tick. Returns True iff the row was handled here (the caller
        takes it out of the batched decode)."""
        from repro_torch.serving.speculative import propose_ngram

        sched = st.sched
        serving = self.serving
        L = req.length
        budget = req.max_new_tokens - req.num_generated
        cap = serving.max_blocks_per_slot * serving.page_size - 1 - L
        k = min(serving.spec_len, budget - 1, cap)
        if k < 1:
            return False
        # req.context ends with the last token (position L): the draft
        # continues the stream the verify chunk's first position extends
        draft = propose_ngram(req.context, serving.spec_ngram, k)
        k = int(len(draft))
        if k < 1:
            return False
        d = sched.begin_draft(req, k)
        if d is None:
            return False  # arena pressure or the block ceiling: decode
        d.tokens = [int(t) for t in draft]
        if d.copy_src >= 0:
            # partial frontier: seed the scratch page that replaces it
            M.copy_page_caches(self.cfg, self.rt, st.caches, d.copy_src, d.scratch[0])
        row = sched.draft_block_row(req)
        C = serving.spec_len + 1
        toks = np.full((C,), int(st.last_tok[req.slot]), np.int32)
        toks[1:1 + k] = draft
        logits, _ = M.verify_chunk_rows(self.cfg, self.rt, req.tier, False, self.params,
                                        self._tensor(toks[None]), req.slot,
                                        self._tensor(row), L, k + 1, st.caches)
        # clock and traffic: one model invocation reading L + k + 1 positions
        st.decode_steps += 1
        st.live_steps += 1
        st.traffic += float(L + k + 1) * st.bpt0 * self._n_cache_layers
        st.interconnect += (k + 1) * st.concat_bpt + st.gather_bps
        util = sched.dense_alloc.utilization
        st.util_peak = max(st.util_peak, util)
        st.util_sum += util
        st.util_n += 1
        st.trace_active.append(1)
        st.trace_util.append(util)
        st.step += 1

        draws = self._verify_draws(req, logits[0])
        n_accept = 1  # position L's draw is this tick's own next token
        for j in range(k):
            if int(draws[j]) != int(draft[j]):
                break
            n_accept += 1
        sched.commit_draft(req, n_accept)
        for j in range(n_accept):
            if req.state != "running":
                break  # a draw hit eos / stop / budget: the rest never emits
            self._emit_token(st, req, int(draws[j]), st.step, grow=True)
            sched.register_prefix(req)
        return True

    # ----------------------------------------------------------------- run

    def step(self) -> list[RequestOutput]:
        """Run ONE engine tick: deadline shedding, the periodic defrag,
        admissions, the watermark escalation policy, at most one streamed
        prompt chunk, page growth (escalation or recompute preemption on
        exhaustion, copy-on-write splits), speculative verify chunks of
        eligible rows, and one decode step + per-row sampling over the other
        running rows. Returns this tick's ``RequestOutput`` events.

        Clock model (the reference's): a tick that runs the decode step
        costs 1 and one prompt chunk rides along for free; a prefill-only
        tick also costs 1; each verify chunk costs 1; a one-shot admission
        costs its padded length in ``prefill_bucket`` units before the
        tick's decode step."""
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

        # 0b) periodic base-arena compaction every ``defrag_every``
        #     retirements: the scheduler relabels mapped pages onto the
        #     lowest ids and every base pool is permuted to match
        if (self.serving.defrag_every
                and sched.stats["retired"] - st.defrag_mark >= self.serving.defrag_every):
            st.defrag_mark = sched.stats["retired"]
            perm = sched.plan_defrag()
            if perm is not None:
                M.defrag_caches(self.cfg, self.rt, st.caches, self._tensor(perm))

        # 1) admissions into vacated slots: chunked, their prompts stream
        #    below; one-shot, the whole prompt is prefilled now and the
        #    clock is charged its bucket-equivalents (the head-of-line stall)
        while (req := sched.admit_next(now=st.step, step=st.step)) is not None:
            self._resolve_sampling(req, st)
            if self.chunked:
                continue
            tok, padded = self._admit(req, st)
            st.step += -(-padded // st.quantum)
            # no interconnect charge, as in the reference: the one-shot
            # prefill runs whole on the lead device and the pack writes each
            # shard's slice
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
            slot = cand.slot
            sched.deescalate(cand)
            self._clear_row_sampling(st, slot)

        # 2) chunked-prefill pump: at most ONE prompt chunk per tick
        did_chunk = False
        fresh_slot = -1  # row whose prefill finished THIS tick
        if self.chunked and (pre := sched.prefilling()):
            req = pre[0]
            # a shared-prefix admission's first tail write may land inside
            # a shared page (divergence mid-page): split it first
            if self._cow_guard(st, req):
                tok, valid = self._prefill_chunk(req, st)
                did_chunk = True
                st.prefill_chunks += 1
                st.prefill_tokens += valid
                st.prefill_write_bytes += (valid * (st.bpt1 if req.tier else st.bpt0)
                                           * self._n_cache_layers)
                st.interconnect += valid * st.concat_bpt + st.gather_bps
                # every page the chunk filled is immutable from here on:
                # register it, so that concurrent admissions can mount it
                sched.register_prefix(req)
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
                self._preempt(st, victim)
            if req.state == "running":
                # a decode write into a still-shared page splits it first
                self._cow_guard(st, req)

        active = sched.active_mask()
        if fresh_slot >= 0:
            active[fresh_slot] = False

        # 3b) speculative decoding: an eligible row takes its own verify
        #     chunk instead of the batched decode; a row whose draft cannot
        #     open stays active and decodes below
        did_spec = False
        if self.spec_on:
            for req in sorted(sched.running(), key=lambda r: r.admitted_step):
                slot = req.slot
                if slot < 0 or not active[slot] or not self._spec_eligible(req):
                    continue
                if self._speculate_row(st, req):
                    active[slot] = False
                    did_spec = True

        if not active.any():
            if did_spec:
                return st.step_outputs  # the verify chunks charged their ticks
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
        #    and a row whose last chunk landed this tick, write the null
        #    page), then one per-row sampling call for the whole batch
        rows = self._row_state(sched, active)
        logits, _ = M.decode_step_rows(self.cfg, self.rt, self.params,
                                       self._tensor(st.last_tok[:, None]), rows,
                                       st.caches)
        toks = self._sample_active(st, logits)
        st.decode_steps += 1
        st.live_steps += int(active.sum())
        st.traffic += float(sum(
            (sched.lengths[s] + 1.0) * (st.bpt1 if sched.tiers[s] else st.bpt0)
            for s in range(B) if active[s])) * self._n_cache_layers
        st.interconnect += int(active.sum()) * st.concat_bpt + st.gather_bps
        util = sched.dense_alloc.utilization
        st.util_peak = max(st.util_peak, util)
        st.util_sum += util
        st.util_n += 1
        st.trace_active.append(int(active.sum()))
        st.trace_util.append(util)
        st.step += 1
        for slot in range(B):
            if not active[slot]:
                continue
            req = sched.slots[slot]
            self._emit_token(st, req, int(toks[slot]), st.step, grow=True)
            # a page completed by decode is registered too: multi-turn
            # follow-ups then mount the request's whole history
            sched.register_prefix(req)
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
            "prefix_sharing": self.share_prefix,
            "spec_on": self.spec_on,
            "spec_accept_rate": (sched.stats["spec_accepted"]
                                 / max(sched.stats["spec_drafted"], 1)),
            "policy": sched.policy.name,
            "model_shards": self.model_shards,
            "arena_bytes_total": total_bytes,
            "arena_bytes_per_device": float(pgc.device_arena_bytes(st.caches)),
            "interconnect_bytes": st.interconnect,
            "interconnect_bytes_per_token": st.interconnect / max(st.generated, 1),
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
