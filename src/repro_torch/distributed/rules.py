"""Logical-axis -> mesh-axis rule sets (the JAX package's
``distributed/rules.py``, copied whole: plain dicts, no JAX).

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.

Parameters (train & serve): 2D sharding — the d_model/"embed" dim is FSDP-
sharded over ``data`` (ZeRO-3; optimizer state follows), the parallel dim
(heads / mlp / vocab / experts) is Megatron-TP-sharded over ``model``.
Parameters are replicated across ``pod`` (pure DP between pods; the cross-pod
gradient all-reduce is the compressible slow-link collective).

Activations: batch over (pod, data), feature-parallel dims over model.

Caches (decode): batch over (pod, data); the head_dim (or latent dim) over
``model`` — this keeps one-token dynamic_update_slice writes local to every
shard (each owns a feature slice of every token) while attention contractions
reduce over the sharded feature dim with a psum. long-context batch=1 shapes
additionally shard the token arena over ``data`` (see launch/input_specs).
"""
from __future__ import annotations


def param_rules(multi_pod: bool) -> dict:
    return {
        # multi-pod: FSDP spans the DCN pod axis too (hybrid sharded DP /
        # ZeRO-3 across pods) — halves per-device param/grad/optimizer memory;
        # the cross-pod gradient sync becomes reduce-scatter + all-gather.
        "embed": ("data", "pod") if multi_pod else "data",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_mlp": None,
        "layers": None,
    }


def act_rules(multi_pod: bool, seq_axis=None) -> dict:
    b = ("pod", "data") if multi_pod else ("data",)
    return {
        "act_batch": b,
        "act_seq": seq_axis,
        "act_heads": "model",
        # KV-head activations replicate: KV < mesh "model" for GQA archs and
        # resharding 8<->16 forces involuntary full remat in SPMD
        "act_kv": None,
        "act_mlp": "model",
        "act_vocab": "model",
        "act_experts": "model",
        "act_expert_mlp": None,
    }


def serve_paged_rules(pool_axis=None) -> dict:
    """Logical-axis rules for the paged serving arenas (continuous batching).

    The physical page pool of every paged container partitions over the
    KV-HEAD axis (each device owns its head slice of every page — the
    paper's bank-parallel attention: compute runs where the KV lives and
    only per-head partials cross the interconnect). Latent pools (T1 X /
    MLA c_kv) have no head axis, so their FEATURE axis shards instead —
    storage is partitioned for HBM capacity and the serving shard_map
    all-gathers the local feature shards before the absorbed attend
    (serving/sharded.py). Page-pool and page axes stay unsharded by default;
    ``pool_axis`` ("data") opts the pool axis into capacity sharding for
    tiers served with global-semantics compute (GSPMD inserts the gathers).
    Block tables, RowState, and the slot/level axes replicate — note the
    slot-INDEXED CPQ HQE side state (scale/zero/num_levels/prune_thr) still
    shards its kv-head axis, exactly like the code pages it dequantizes.
    The CPQ-X (T1+T2 / MLA-CPQ) code pools are the exception and replicate
    entirely — see distributed.cache_specs._paged_cpq_specs."""
    return {
        "page_pool": pool_axis,   # physical page axis (P)
        "page": None,             # within-page token axis
        "kv_heads": "model",      # per-head pools: dense K/V, CPQ codes, proxy
        "head_dim": None,
        "latent": "model",        # feature axis of X / MLA latent pools
        "slots": None,            # per-slot side state (CPQ HQE, proxy calib)
        "levels": None,           # HQE level axis
    }


def batch_axes(multi_pod: bool, batch_size: int, mesh_shape: dict) -> tuple:
    """Mesh axes to shard the global batch over (drop axes that don't divide)."""
    axes = (("pod", "data") if multi_pod else ("data",))
    out = []
    n = batch_size
    for a in axes:
        k = mesh_shape[a]
        if n % k == 0 and n >= k:
            out.append(a)
            n //= k
    return tuple(out)
