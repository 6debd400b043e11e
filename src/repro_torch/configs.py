"""Config system of the PyTorch port.

Field-for-field copies of the JAX package's dataclasses (``ModelConfig``,
``AttentionRuntime``, ``ServingCfg``, ``ShapeCfg`` and the sub-configs), the
architecture registry ``ARCHS``, the shape registry ``SHAPES`` and
``smoke_config``. The port keeps its own copy because
the JAX package's config module imports ``jax.numpy``; the only difference is
``ModelConfig.param_dtype``, which returns a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional

import torch

# ---------------------------------------------------------------- sub-configs


@dataclass(frozen=True)
class MoECfg:
    num_experts: int = 64
    num_shared: int = 2
    top_k: int = 6
    d_ff_expert: int = 1408
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0  # 0 => direct q projection (V2-Lite)


@dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => d_model // 16


@dataclass(frozen=True)
class XLSTMCfg:
    proj_factor: float = 2.0
    conv_kernel: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class CPQCfg:
    """T2: cascade pruning-quantization of the KV / X cache."""

    prune_ratio: float = 0.4
    bits: int = 4
    max_levels: int = 4
    tolerance: float = 1.0
    residual_window: int = 32


@dataclass(frozen=True)
class RetrievalCfg:
    """T3: attention as nearest-neighbor retrieval."""

    top_k: int = 512
    proxy_bits: int = 8
    proxy_dim: int = 0
    recent_window: int = 64


@dataclass(frozen=True)
class AttentionRuntime:
    # dense | decomposed (T1) | cpq (T2) | retrieval (T3)
    # | decomposed_cpq (T1+T2)
    mode: str = "dense"
    cpq: Optional[CPQCfg] = None
    retrieval: Optional[RetrievalCfg] = None
    # paged serving: run the hand-written paged-attention kernels (True) or
    # the gather path over logical views, which is the numerics oracle
    paged_kernels: bool = True
    # paged serving over a device mesh (distributed.sharding.Mesh, from
    # launch.mesh.make_serve_mesh): the arenas split over its model axis
    mesh: Optional[object] = None

    def __post_init__(self):
        assert self.mode in ("dense", "decomposed", "cpq", "retrieval",
                             "decomposed_cpq"), self.mode
        if self.mode in ("cpq", "decomposed_cpq") and self.cpq is None:
            object.__setattr__(self, "cpq", CPQCfg())
        if self.mode == "retrieval" and self.retrieval is None:
            object.__setattr__(self, "retrieval", RetrievalCfg())


@dataclass(frozen=True)
class ServingCfg:
    """Continuous-batching serving layer (serving/scheduler.py + engine.py).

    The physical arena is ``num_pages`` pages of ``page_size`` tokens per
    attention layer (page 0 reserved as the null page); each request slot may
    map at most ``max_blocks_per_slot`` logical pages (its context ceiling).
    The knobs mirror the JAX package's ``ServingCfg`` one for one; the port's
    engine refuses those it does not implement yet."""

    num_slots: int = 4
    page_size: int = 16
    num_pages: int = 129           # incl. the reserved null page 0
    max_blocks_per_slot: int = 16
    escalated_pages: int = 65
    low_watermark: float = 0.25
    critical_watermark: float = 0.10
    high_watermark: float = 1.0
    enable_escalation: bool = False
    policy: str = "fifo"
    prefill_bucket: int = 16
    prefill_chunk: int = 16
    use_paged_kernels: Optional[bool] = None
    share_prefix: bool = False
    defrag_every: int = 0
    probe_interval: int = 4
    probe_failures: int = 3
    probe_backoff: int = 4
    probe_exhaust_frac: float = 0.0
    auto_drain: bool = False
    deadline_scale: float = 0.0
    max_backlog: int = 0
    spec_len: int = 0
    spec_ngram: int = 3

    def __post_init__(self):
        self.validate(strict=False)

    def validate(self, strict: bool = True) -> "ServingCfg":
        """Raise ``ValueError`` naming the knobs for inconsistent settings.
        ``strict=False`` checks the construction invariants only;
        ``strict=True`` adds the cross-knob checks the engine runs."""

        def bad(msg: str):
            raise ValueError(f"ServingCfg: {msg}")

        if not (self.num_pages >= 2 and self.escalated_pages >= 2):
            bad(f"num_pages={self.num_pages} and escalated_pages="
                f"{self.escalated_pages} must each be >= 2 (page 0 is the "
                "reserved null page)")
        if not (self.page_size >= 1 and self.num_slots >= 1
                and self.max_blocks_per_slot >= 1):
            bad(f"page_size={self.page_size}, num_slots={self.num_slots}, "
                f"max_blocks_per_slot={self.max_blocks_per_slot} must all "
                "be >= 1")
        if not 0.0 <= self.critical_watermark <= self.low_watermark <= 1.0:
            bad(f"watermarks must satisfy 0 <= critical_watermark "
                f"({self.critical_watermark}) <= low_watermark "
                f"({self.low_watermark}) <= 1")
        if not self.low_watermark <= self.high_watermark <= 1.0:
            bad(f"high_watermark ({self.high_watermark}) must lie in "
                f"[low_watermark ({self.low_watermark}), 1] — it is the "
                "de-escalation hysteresis threshold above low")
        if self.policy not in ("fifo", "priority", "slo"):
            bad(f"policy={self.policy!r} not one of fifo|priority|slo")
        if self.prefill_bucket < 1:
            bad(f"prefill_bucket={self.prefill_bucket} must be >= 1")
        if self.prefill_chunk < 0:
            bad(f"prefill_chunk={self.prefill_chunk} must be >= 0 "
                "(0 = one-shot admission)")
        if self.defrag_every < 0:
            bad(f"defrag_every={self.defrag_every} must be >= 0 (0 = off)")
        if self.probe_interval < 0:
            bad(f"probe_interval={self.probe_interval} must be >= 0")
        if self.probe_failures < 1 or self.probe_backoff < 1:
            bad(f"probe_failures={self.probe_failures} and probe_backoff="
                f"{self.probe_backoff} must be >= 1")
        if self.probe_exhaust_frac > 1.0:
            bad(f"probe_exhaust_frac={self.probe_exhaust_frac} must be "
                "<= 1.0 (negative disables the pressure check)")
        if self.deadline_scale < 0.0:
            bad(f"deadline_scale={self.deadline_scale} must be >= 0 "
                "(0 = deadlines off)")
        if self.max_backlog < 0:
            bad(f"max_backlog={self.max_backlog} must be >= 0 "
                "(0 = unbounded parking)")
        if self.spec_len < 0:
            bad(f"spec_len={self.spec_len} must be >= 0 (0 = off)")
        if self.spec_ngram < 1:
            bad(f"spec_ngram={self.spec_ngram} must be >= 1")
        if self.prefill_chunk and self.prefill_chunk % self.page_size != 0:
            bad("prefill_chunk must be page-aligned (chunks stream whole "
                f"arena pages): prefill_chunk={self.prefill_chunk} % "
                f"page_size={self.page_size} != 0")
        if not strict:
            return self
        if self.spec_len > 0 and self.prefill_chunk == 0:
            bad(f"spec_len={self.spec_len} requires chunked admission "
                "(prefill_chunk > 0): the verify pass IS a spec_len+1 wide "
                "prefill chunk. Set prefill_chunk to a page-aligned value "
                "or spec_len=0")
        if self.max_len < 2:
            bad(f"max_len = page_size*max_blocks_per_slot = {self.max_len} "
                "< 2: no request could hold a prompt token plus one "
                "generated token")
        return self

    @property
    def max_len(self) -> int:
        """Per-request logical context ceiling (tokens)."""
        return self.page_size * self.max_blocks_per_slot

    @classmethod
    def preset_path(cls) -> str:
        """The port's packaged presets file, written by the port's tuner
        (``python -m repro_torch.launch.tune``) on the GPU."""
        return os.path.join(os.path.dirname(__file__), "serving_presets.json")

    @classmethod
    def list_presets(cls, path: Optional[str] = None) -> list[str]:
        with open(path or cls.preset_path()) as f:
            return sorted(json.load(f)["presets"])

    @classmethod
    def from_preset(cls, name: str, path: Optional[str] = None,
                    **overrides) -> "ServingCfg":
        """A named operating point of a presets file (``latency`` /
        ``throughput`` / ``energy`` / ``default``); ``overrides`` replace
        preset fields, as the serve launcher does to size the arena for its
        own context ceiling."""
        with open(path or cls.preset_path()) as f:
            data = json.load(f)
        if name not in data["presets"]:
            raise ValueError(
                f"unknown serving preset {name!r}; available: "
                f"{sorted(data['presets'])}")
        kwargs = dict(data["presets"][name]["serving"])
        kwargs.update(overrides)
        return cls(**kwargs).validate()


# ------------------------------------------------------------------- model


MIXERS = ("attn", "xattn", "mla", "mamba", "mlstm", "slstm")
MLPS = ("dense", "moe", "none")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: tuple[tuple[str, str], ...]
    num_blocks: int
    prefix_pattern: tuple[tuple[str, str], ...] = ()
    mlp_act: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"    # rmsnorm | layernorm
    qkv_bias: bool = False
    qk_norm: bool = False
    pos_embedding: str = "rope"  # rope | absolute | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False
    logit_softcap: float = 0.0
    input_kind: str = "tokens"  # tokens | audio_frames | text+patches
    num_patch_tokens: int = 0
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    mamba: Optional[MambaCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    attention: AttentionRuntime = AttentionRuntime()
    dtype: str = "bfloat16"

    def __post_init__(self):
        for mixer, mlp in self.prefix_pattern + self.block_pattern:
            assert mixer in MIXERS, mixer
            assert mlp in MLPS, mlp

    @property
    def num_layers(self) -> int:
        return len(self.prefix_pattern) + self.num_blocks * len(self.block_pattern)

    @property
    def layer_kinds(self) -> tuple[tuple[str, str], ...]:
        return self.prefix_pattern + self.block_pattern * self.num_blocks

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_mha(self) -> bool:
        return self.num_kv_heads == self.num_heads

    @property
    def attention_free(self) -> bool:
        return not any(m in ("attn", "xattn", "mla") for m, _ in self.layer_kinds)

    @property
    def sub_quadratic(self) -> bool:
        fams = self.family in ("ssm", "hybrid")
        return fams or self.attention.mode == "retrieval"

    def with_attention(self, mode: str, **kw) -> "ModelConfig":
        return dataclasses.replace(self, attention=AttentionRuntime(mode=mode, **kw))


# ---------------------------------------------------------------- registry


def _configs() -> tuple[ModelConfig, ...]:
    """The eleven published configurations (the JAX package's
    ``configs/<arch>.py`` files, in its registry order)."""
    attn, dense = "attn", "dense"
    return (
        ModelConfig(
            name="deepseek-v2-lite-16b", family="moe", d_model=2048,
            num_heads=16, num_kv_heads=16, head_dim=128, d_ff=10944,
            vocab_size=102400, prefix_pattern=(("mla", dense),),
            block_pattern=(("mla", "moe"),), num_blocks=26, mlp_act="swiglu",
            norm="rmsnorm", rope_theta=10000.0,
            moe=MoECfg(num_experts=64, num_shared=2, top_k=6, d_ff_expert=1408),
            mla=MLACfg(kv_lora_rank=512, qk_nope_head_dim=128,
                       qk_rope_head_dim=64, v_head_dim=128)),
        ModelConfig(
            name="deepseek-moe-16b", family="moe", d_model=2048, num_heads=16,
            num_kv_heads=16, head_dim=128, d_ff=10944, vocab_size=102400,
            prefix_pattern=((attn, dense),), block_pattern=((attn, "moe"),),
            num_blocks=27, mlp_act="swiglu", norm="rmsnorm",
            moe=MoECfg(num_experts=64, num_shared=2, top_k=6, d_ff_expert=1408)),
        ModelConfig(
            name="llama-3.2-vision-11b", family="vlm", d_model=4096,
            num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
            vocab_size=128256,
            block_pattern=((attn, dense), (attn, dense), (attn, dense),
                           ("xattn", dense), (attn, dense)),
            num_blocks=8, mlp_act="swiglu", norm="rmsnorm",
            rope_theta=500000.0, input_kind="text+patches",
            num_patch_tokens=1600),
        ModelConfig(
            name="musicgen-large", family="audio", d_model=2048, num_heads=32,
            num_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=2048,
            block_pattern=((attn, dense),), num_blocks=48, mlp_act="gelu",
            norm="layernorm", pos_embedding="absolute",
            input_kind="audio_frames"),
        ModelConfig(
            name="xlstm-125m", family="ssm", d_model=768, num_heads=4,
            num_kv_heads=4, head_dim=192, d_ff=0, vocab_size=50304,
            block_pattern=(("mlstm", "none"),) * 5 + (("slstm", "none"),),
            num_blocks=2, norm="layernorm", pos_embedding="none",
            xlstm=XLSTMCfg(proj_factor=2.0, conv_kernel=4, chunk=256)),
        ModelConfig(
            name="qwen1.5-0.5b", family="dense", d_model=1024, num_heads=16,
            num_kv_heads=16, head_dim=64, d_ff=2816, vocab_size=151936,
            block_pattern=((attn, dense),), num_blocks=24, mlp_act="swiglu",
            norm="rmsnorm", qkv_bias=True, tie_embeddings=True),
        ModelConfig(
            name="gemma-2b", family="dense", d_model=2048, num_heads=8,
            num_kv_heads=1, head_dim=256, d_ff=16384, vocab_size=256000,
            block_pattern=((attn, dense),), num_blocks=18, mlp_act="geglu",
            norm="rmsnorm", tie_embeddings=True, embed_scale=True),
        ModelConfig(
            name="phi4-mini-3.8b", family="dense", d_model=3072, num_heads=24,
            num_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=200064,
            block_pattern=((attn, dense),), num_blocks=32, mlp_act="swiglu",
            norm="rmsnorm"),
        ModelConfig(
            name="qwen3-4b", family="dense", d_model=2560, num_heads=32,
            num_kv_heads=8, head_dim=128, d_ff=9728, vocab_size=151936,
            block_pattern=((attn, dense),), num_blocks=36, mlp_act="swiglu",
            norm="rmsnorm", qk_norm=True, rope_theta=1000000.0),
        ModelConfig(
            name="jamba-1.5-large-398b", family="hybrid", d_model=8192,
            num_heads=64, num_kv_heads=8, head_dim=128, d_ff=24576,
            vocab_size=65536,
            block_pattern=(("mamba", dense), ("mamba", "moe"), ("mamba", dense),
                           ("mamba", "moe"), (attn, dense), ("mamba", "moe"),
                           ("mamba", dense), ("mamba", "moe")),
            num_blocks=9, mlp_act="swiglu", norm="rmsnorm",
            moe=MoECfg(num_experts=16, num_shared=0, top_k=2, d_ff_expert=24576),
            mamba=MambaCfg(d_state=16, d_conv=4, expand=2)),
        ModelConfig(
            name="opt-6.7b", family="dense", d_model=4096, num_heads=32,
            num_kv_heads=32, head_dim=128, d_ff=16384, vocab_size=50272,
            block_pattern=((attn, dense),), num_blocks=32, mlp_act="gelu",
            norm="layernorm", pos_embedding="absolute"),
    )


ARCHS: dict[str, ModelConfig] = {c.name: c for c in _configs()}


# ------------------------------------------------------------------- shapes


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode")


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


# the configurations the dry-run covers: every one but opt-6.7b
ASSIGNED = tuple(n for n in ARCHS if n != "opt-6.7b")


def cell_supported(cfg: ModelConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """Whether (arch x shape) is a defined cell, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (enable attention.mode='retrieval' "
            "— the paper's T3 — to run this cell)"
        )
    return True, ""


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: tiny widths, 1 block, small vocab."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 96,
        vocab_size=256,
        num_blocks=1,
        num_patch_tokens=16 if cfg.num_patch_tokens else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = MoECfg(num_experts=8, num_shared=min(cfg.moe.num_shared, 1),
                           top_k=2, d_ff_expert=32, capacity_factor=2.0)
    if cfg.mla is not None:
        kw["mla"] = MLACfg(kv_lora_rank=32, qk_nope_head_dim=16,
                           qk_rope_head_dim=8, v_head_dim=16)
    if cfg.mamba is not None:
        kw["mamba"] = MambaCfg(d_state=8, d_conv=4, expand=2)
    if cfg.xlstm is not None:
        kw["xlstm"] = XLSTMCfg(proj_factor=2.0, conv_kernel=4, chunk=16)
    return dataclasses.replace(cfg, **kw)
