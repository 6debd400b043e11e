"""The analytical energy model that prices the tuner's energy axis: the
port's own copy of ``Device`` (the JAX repo's ``benchmarks/hw.py``) and of
``TrafficCfg`` and ``decode_token_cost`` (``benchmarks/bench_e2e_energy.py``),
with the same arithmetic in the same order, so that one device record gives
the reference's price to the last bit for every traffic the tuner prices.

  energy/token = moved_bytes * pj_per_byte + MACs * pj_per_mac
                 + idle_w * time/token * (1 - slot_util)
  time/token   = max(MACs*2 / peak_flops, moved_bytes / mem_bw)

``H100_SXM`` is the record of the card the port runs on, and the tuner's
default. A run is priced at the paper-scale model (OPT-6.7B), as the
reference prices it; only the device record differs.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Device:
    name: str
    peak_flops: float        # FLOP/s (bf16/fp16 dense)
    hbm_bw: float            # bytes/s
    mem_pj_per_byte: float   # off-chip access energy
    mac_pj: float            # energy per MAC (2 FLOPs)
    power_w: float           # board power (throughput/W comparisons)
    # static/leakage board power burned regardless of slot occupancy: what
    # a serving step pays for its idle rows (charged against the measured
    # slot utilization in decode_token_cost)
    idle_w: float = 0.0


H100_POWER_W = 700.0         # the card's power limit: NVIDIA H100 80GB HBM3 at
                             # 700.00 W (nvidia-smi --query-gpu=power.limit)
H100_PEAK_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)

H100_SXM = Device(
    name="h100-sxm",
    peak_flops=H100_PEAK_FLOPS,
    hbm_bw=3.35e12,           # H100 SXM HBM3 bandwidth (NVIDIA data sheet)
    # ~3.75 pJ/bit, HBM class: the architecture-literature range hw.py cites
    # for HBM2e (3.5-7 pJ/bit), which HBM3 stays within
    mem_pj_per_byte=30.0,
    # board power over the bf16 peak, 2 FLOP a MAC, in the arithmetic of
    # hw.py's TPU row (220 W / 197 TFLOP/s -> 0.56): 700 / 989e12 / 2
    mac_pj=H100_POWER_W / H100_PEAK_FLOPS * 1e12 / 2,
    power_w=H100_POWER_W,
    # ~30 % of board power idle (leakage, HBM refresh, interconnect), the
    # share hw.py gives its accelerators (TPU v5e 66 of 220 W, A100 110 of 400)
    idle_w=0.3 * H100_POWER_W,
)


# the decode context every token is priced at (the reference's default)
CTX = 2048


@dataclasses.dataclass
class TrafficCfg:
    """Per-run traffic knobs of the analytical model: the fields the tuner
    sets, at the reference's defaults. The reference's options for other
    hardware (stationary weights, a rewrite penalty, interconnect bytes, a
    context other than ``CTX``) are left out; at their defaults they add
    nothing to the price."""

    batch: int = 1
    kv_bytes_per_token_layer: float = 0.0
    # paged serving: chunked prefill writes the prompt's cache payload into
    # the arena exactly once, amortized over the generated tokens (prompt_ctx
    # tokens written per gen_tokens generated); 0 = not modeled
    prefill_ctx: int = 0
    gen_tokens: int = 256
    prefill_write_bytes_per_token_layer: float = 0.0
    # the mean fraction of batch slots that emit a useful token per decode
    # step; below 1.0 a useful token pays the 1/u amplification of the
    # per-step weight stream and the idle share of static board power
    slot_util: float = 1.0


def decode_token_cost(dev: Device, n_params: float, L: int, cfg: TrafficCfg):
    """(seconds, joules) per generated token (per sequence), amortized over
    the batch."""
    u = min(max(cfg.slot_util, 1e-6), 1.0)
    macs = n_params + 0.0  # linear layers: one MAC per weight per token
    kv_bytes = cfg.kv_bytes_per_token_layer * L * CTX
    attn_macs = cfg.kv_bytes_per_token_layer / 2 * L * CTX  # ~1 MAC/elem
    # weight streaming is a per-step cost: idle slots still ride the step,
    # so per useful token it amortizes over batch * slot_util live rows
    w_bytes = 2.0 * n_params / (cfg.batch * u)
    # chunked-prefill arena writes: one write per prompt token per layer,
    # amortized per generated token
    pf_bytes = (cfg.prefill_write_bytes_per_token_layer * L * cfg.prefill_ctx
                / max(cfg.gen_tokens, 1))
    bytes_moved = w_bytes + kv_bytes + pf_bytes
    t = max(2.0 * (macs + attn_macs) / dev.peak_flops,
            bytes_moved / dev.hbm_bw)
    e = (bytes_moved * dev.mem_pj_per_byte + (macs + attn_macs) * dev.mac_pj) * 1e-12
    # the idle rows' share of static board power over the token's time slice
    e += dev.idle_w * t * (1.0 - u)
    return t, e
