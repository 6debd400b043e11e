"""PartitionSpec trees of the decode caches (the JAX package's
``distributed/cache_specs.py``): the contiguous arenas of
``models/model.init_caches`` (``layer_cache_specs``, ``cache_pspecs``) and
the paged serving arenas (``paged_cache_pspecs``).

Contiguous strategy (``distributed/rules.py``): batch over (pod,) data;
feature dims (head dim, latent dim, d_inner) over model, so one-token
cache writes stay local; a batch-1 long-context shape shards the token
arena over the axes the batch cannot use.

The port keeps one arena a layer (``models/model.init_caches`` and
``init_paged_caches``), so both trees give one spec a layer where the
reference's stacked block arenas carry a leading replicated layer axis."""
from __future__ import annotations

from repro_torch.configs import AttentionRuntime, ModelConfig
from repro_torch.distributed.sharding import PartitionSpec as P


def _cpq_tensor_specs(b, s):
    from repro_torch.core.cpq import CPQTensor
    return CPQTensor(
        codes=P(b, s, None, "model"),
        scale=P(b, None, None, "model"),
        zero=P(b, None, None, "model"),
        level=P(b, s, None),
        num_levels=P(b, None),
        prune_thr=P(b, None, "model"),
    )


def layer_cache_specs(cfg: ModelConfig, rt: AttentionRuntime, kind, b, s):
    """One layer's contiguous cache specs. b: mesh axes for the batch (str,
    tuple or None); s: mesh axes for the token arena."""
    from repro_torch.core import kv_cache as kvc
    from repro_torch.models.mamba import MambaState
    from repro_torch.models.xlstm import MLSTMState, SLSTMState

    mixer, _ = kind
    if mixer == "xattn":
        return kvc.DenseKVCache(k=P(b, None, None, "model"),
                                v=P(b, None, None, "model"), length=P())
    if mixer == "mla":
        if rt.mode == "cpq":
            return kvc.CPQXCache(x=_cpq_tensor_specs(b, s),
                                 k_rope=P(b, s, None, None), length=P())
        return kvc.XCache(x=P(b, s, "model"), k_rope=P(b, s, None, None), length=P())
    if mixer == "attn":
        if rt.mode == "dense":
            return kvc.DenseKVCache(k=P(b, s, None, "model"),
                                    v=P(b, s, None, "model"), length=P())
        if rt.mode == "decomposed":
            return kvc.XCache(x=P(b, s, "model"), k_rope=P(b, s, None, None), length=P())
        if rt.mode == "decomposed_cpq":
            return kvc.CPQXCache(x=_cpq_tensor_specs(b, s),
                                 k_rope=P(b, s, None, None), length=P())
        if rt.mode == "cpq":
            return kvc.CPQKVCache(k=_cpq_tensor_specs(b, s),
                                  v=_cpq_tensor_specs(b, s), length=P())
        if rt.mode == "retrieval":
            return kvc.RetrievalCache(
                k=P(b, s, None, "model"), v=P(b, s, None, "model"),
                proxy=P(b, s, None, "model"),
                proxy_scale=P(b, None, "model"), proxy_zero=P(b, None, "model"),
                length=P())
        raise ValueError(rt.mode)
    if mixer == "mamba":
        return MambaState(conv=P(b, None, "model"), h=P(b, "model", None))
    if mixer == "mlstm":
        return MLSTMState(C=P(b, None, None, "model"), n=P(b, None, "model"),
                          m=P(b, None), conv=P(b, None, "model"))
    if mixer == "slstm":
        return SLSTMState(c=P(b, "model"), n=P(b, "model"),
                          h=P(b, "model"), m=P(b, "model"))
    raise ValueError(mixer)


def cache_pspecs(cfg: ModelConfig, rt: AttentionRuntime, batch_axes, seq_axes):
    """Spec tree matching ``models.model.init_caches``: {"prefix": [spec a
    layer], "blocks": [[spec a block] a pattern position]}."""
    b = batch_axes if batch_axes else None
    s = seq_axes if seq_axes else None
    return {"prefix": [layer_cache_specs(cfg, rt, k, b, s) for k in cfg.prefix_pattern],
            "blocks": [[layer_cache_specs(cfg, rt, k, b, s) for _ in range(cfg.num_blocks)]
                       for k in cfg.block_pattern]}


# ------------------------------------------------------- paged serving arenas


def _paged_cpq_specs(rules: dict, latent: bool):
    """Spec tree for a serving PagedCPQTensor. ``latent`` selects the
    T1+T2 / MLA-CPQ layout (H == 1, D == d_model/L), which REPLICATES: its
    attend contracts over the feature axis, and splitting that axis would
    split the attend's float32 reduction (the reference observed greedy
    parity with the single-device engine break). Head-axis pools are safe
    to shard because every contraction treats the kv-head axis as
    batch-like."""
    from repro_torch.distributed.sharding import resolve
    from repro_torch.serving.paged_cache import PagedCPQTensor

    if latent:
        rep = P()
        return PagedCPQTensor(codes=rep, level=rep, scale=rep, zero=rep,
                              num_levels=rep, prune_thr=rep)
    r = lambda *axes: resolve(rules, axes)  # noqa: E731
    return PagedCPQTensor(
        codes=r("page_pool", "page", "kv_heads", "head_dim"),
        level=r("page_pool", "page", "kv_heads"),
        scale=r("slots", "levels", "kv_heads", "head_dim"),
        zero=r("slots", "levels", "kv_heads", "head_dim"),
        num_levels=r("slots", "kv_heads"),
        prune_thr=r("slots", "kv_heads", "head_dim"))


def paged_container_specs(container, rules: dict | None = None):
    """PartitionSpec intent tree for a paged serving container (only its
    type matters): per-kv-head page pools shard their head axis over
    ``model``, latent pools (T1 X / MLA c_kv) their feature axis, the CPQ-X
    code pools replicate, and the page-pool / page / slot axes replicate
    (rules from ``distributed.rules.serve_paged_rules``). Specs are intent:
    ``sharding.fit_spec_to_shape`` drops the axes that do not divide their
    dimension (MLA's one shared roped key, kv_r 1). The one source of both
    the arenas' placement and the per-shard calls (``serving/sharded.py``)."""
    from repro_torch.distributed.rules import serve_paged_rules
    from repro_torch.distributed.sharding import resolve
    from repro_torch.serving import paged_cache as pgc

    rules = serve_paged_rules() if rules is None else rules
    r = lambda *axes: resolve(rules, axes)  # noqa: E731
    c = container
    if isinstance(c, pgc.TieredPagedCache):
        return pgc.TieredPagedCache(dense=paged_container_specs(c.dense, rules),
                                    cpq=paged_container_specs(c.cpq, rules))
    if isinstance(c, pgc.PagedDenseKVCache):
        return pgc.PagedDenseKVCache(
            k=r("page_pool", "page", "kv_heads", "head_dim"),
            v=r("page_pool", "page", "kv_heads", "head_dim"))
    if isinstance(c, pgc.PagedXCache):
        return pgc.PagedXCache(
            x=r("page_pool", "page", "latent"),
            k_rope=r("page_pool", "page", "kv_heads", "head_dim"))
    if isinstance(c, pgc.PagedCPQKVCache):
        t = _paged_cpq_specs(rules, latent=False)
        return pgc.PagedCPQKVCache(k=t, v=t)
    if isinstance(c, pgc.PagedCPQXCache):
        return pgc.PagedCPQXCache(
            x=_paged_cpq_specs(rules, latent=True),
            k_rope=r("page_pool", "page", "kv_heads", "head_dim"))
    if isinstance(c, pgc.PagedRetrievalCache):
        return pgc.PagedRetrievalCache(
            k=r("page_pool", "page", "kv_heads", "head_dim"),
            v=r("page_pool", "page", "kv_heads", "head_dim"),
            proxy=r("page_pool", "page", "kv_heads", "head_dim"),
            proxy_scale=r("slots", "kv_heads", "head_dim"),
            proxy_zero=r("slots", "kv_heads", "head_dim"))
    raise TypeError(type(c))


def paged_layer_cache_specs(cfg: ModelConfig, rt: AttentionRuntime, kind, serving,
                            tiered: bool = False, rules: dict | None = None):
    """PartitionSpec tree for ONE layer's paged serving container, mirroring
    ``models.transformer.layer_paged_cache_init`` (built on the meta
    device: shapes only): attention mixers get the
    ``paged_container_specs`` intent; recurrent and cross-attention state
    is slot-indexed and O(1) a request, so it replicates."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import paged_cache as pgc

    skeleton = tfm.layer_paged_cache_init(cfg, rt, kind, serving, "meta", tiered)
    if isinstance(skeleton, pgc.PAGED_TYPES):
        return paged_container_specs(skeleton, rules)
    return pgc.tree_map(lambda _: P(), skeleton)


def paged_cache_pspecs(cfg: ModelConfig, rt: AttentionRuntime, serving,
                       tiered: bool = False, rules: dict | None = None):
    """Spec tree matching ``models.model.init_paged_caches``: {"prefix":
    [spec a layer], "blocks": [[spec a block] a pattern position]}."""
    def one(kind):
        return paged_layer_cache_specs(cfg, rt, kind, serving, tiered, rules)

    return {"prefix": [one(k) for k in cfg.prefix_pattern],
            "blocks": [[one(k) for _ in range(cfg.num_blocks)] for k in cfg.block_pattern]}
