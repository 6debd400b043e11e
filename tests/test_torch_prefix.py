"""Prefix sharing, copy-on-write and defrag of the port against the JAX
package. The device half first: ``permute_pool`` and ``copy_page`` move the
same payload as the reference's over every container (dense, T1 X, T2 CPQ,
T3 and the tiered arena's dense arm), in place. Then the engine on the
reference's prefix-sharing traces (``tests/test_serving_prefix.py``):
identical streams, ticks and counters to the JAX engine with sharing on in
dense and T1, a copy-on-write split at a mid-page divergence, sampled rows,
recompute preemption while pages are shared, the tiered dense arm, and the
periodic defrag. Float32, CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.serving import paged_cache as jpgc
from repro_torch.serving import paged_cache as tpgc

from torch_paged_cases import serve_pair, smoke_pair

P, PAGE, SLOTS = 9, 4, 2


def _arenas(seed):
    """The same random payload in every container of both packages."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    i8 = lambda *s: rng.integers(-127, 128, size=s).astype(np.int8)  # noqa: E731
    a = dict(k=f(P, PAGE, 2, 8), v=f(P, PAGE, 2, 8), x=f(P, PAGE, 16),
             kr=f(P, PAGE, 2, 4), proxy=i8(P, PAGE, 2, 8), ps=f(SLOTS, 2, 8),
             pz=f(SLOTS, 2, 8))
    cpq = [(i8(P, PAGE, 2, 8), rng.integers(0, 4, (P, PAGE, 2)).astype(np.int32),
            f(SLOTS, 4, 2, 8), f(SLOTS, 4, 2, 8), np.full((SLOTS, 2), 4, np.int32),
            f(SLOTS, 2, 8)) for _ in range(2)]

    def build(mod, t):
        c = mod.PagedCPQKVCache(*[mod.PagedCPQTensor(*map(t, arrs)) for arrs in cpq])
        c2 = mod.PagedCPQKVCache(*[mod.PagedCPQTensor(*map(t, arrs)) for arrs in cpq])
        return {"dense": mod.PagedDenseKVCache(t(a["k"]), t(a["v"])),
                "x": mod.PagedXCache(t(a["x"]), t(a["kr"])), "cpq": c,
                "retrieval": mod.PagedRetrievalCache(t(a["k"]), t(a["v"]), t(a["proxy"]),
                                                     t(a["ps"]), t(a["pz"])),
                "tiered": mod.TieredPagedCache(mod.PagedDenseKVCache(t(a["k"]), t(a["v"])),
                                               c2)}

    return build(jpgc, jnp.asarray), build(tpgc, lambda x: torch.tensor(np.array(x)))


def _same_tree(j, t):
    for a, b in zip(tuple(j), tuple(t)):
        if isinstance(a, tuple):
            _same_tree(a, b)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("kind", ["dense", "x", "cpq", "retrieval", "tiered"])
def test_permute_pool_matches_jax(kind):
    j, t = _arenas(0)
    perm = np.random.default_rng(1).permutation(P).astype(np.int32)
    out = tpgc.permute_pool(t[kind], torch.tensor(perm))
    assert out is t[kind]  # in place
    _same_tree(jpgc.permute_pool(j[kind], jnp.asarray(perm)), t[kind])


@pytest.mark.parametrize("kind", ["dense", "x", "tiered"])
def test_copy_page_matches_jax(kind):
    j, t = _arenas(2)
    tpgc.copy_page(t[kind], 3, 7)
    _same_tree(jpgc.copy_page(j[kind], jnp.int32(3), jnp.int32(7)), t[kind])


@pytest.mark.parametrize("kind", ["cpq", "retrieval"])
def test_copy_page_refuses_side_state_tiers(kind):
    _, t = _arenas(3)
    with pytest.raises(TypeError, match="copy-on-write"):
        tpgc.copy_page(t[kind], 1, 2)


@pytest.fixture(scope="module")
def model():
    return smoke_pair()


BASE = dict(num_slots=3, page_size=4, num_pages=65, max_blocks_per_slot=12,
            prefill_bucket=4, prefill_chunk=4)


def _shared_prompts(tails=(5, 9, 3, 14, 7), prefix=24, seed=0):
    """``test_serving_prefix._shared_prompts``: prompts opening with one
    ``prefix``-token system prompt."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, 256, size=prefix).astype(np.int32)
    return [np.concatenate([sys_p, rng.integers(1, 256, size=t).astype(np.int32)])
            for t in tails]


def _greedy(prompts, max_new):
    def requests(ns):
        return [ns.Request(rid=i, prompt=p, max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
    return requests


@pytest.mark.parametrize("mode,fused", [("dense", True), ("dense", False),
                                        ("decomposed", True), ("decomposed", False)])
def test_sharing_serves_as_jax(model, mode, fused):
    (_, jst), (_, tst) = serve_pair(
        model, _greedy(_shared_prompts(), 6),
        dict(BASE, share_prefix=True, use_paged_kernels=fused),
        gen=dict(max_new_tokens=6), rt=dict(mode=mode))
    assert tst["prefix_sharing"] and jst["prefix_hits"] > 0


def test_sharing_with_sampled_rows(model):
    prompts = _shared_prompts(seed=3)

    def requests(ns):
        return [ns.ServeRequest(prompt=p, rid=i, sampling=ns.SamplingParams(
            temperature=0.9, seed=10 + i, max_tokens=6)) for i, p in enumerate(prompts)]

    (_, jst), _ = serve_pair(model, requests,
                             dict(BASE, share_prefix=True, use_paged_kernels=False),
                             gen=dict(max_new_tokens=6))
    assert jst["prefix_hits"] > 0


@pytest.mark.parametrize("mode", ["dense", "decomposed"])
def test_cow_at_mid_page_divergence(model, mode):
    """A late arrival diverging two tokens into a page mounts it shared and
    splits it on its first tail write (the reference test's schedule)."""
    rng = np.random.default_rng(1)
    sys_p = rng.integers(1, 256, size=24).astype(np.int32)
    pa = np.concatenate([sys_p, rng.integers(1, 256, size=8).astype(np.int32)])
    pb = np.concatenate([sys_p[:22], rng.integers(1, 256, size=6).astype(np.int32)])

    def drive(eng, ns):
        eng.add_request(ns.Request(rid=0, prompt=pa, max_new_tokens=16))
        for _ in range(12):
            eng.step()
        eng.add_request(ns.Request(rid=1, prompt=pb, max_new_tokens=8))
        while eng.has_unfinished():
            eng.step()
        return eng.results()

    (_, jst), _ = serve_pair(model, None, dict(BASE, num_slots=2, share_prefix=True),
                             gen=dict(max_new_tokens=16), rt=dict(mode=mode), drive=drive)
    assert jst["cow_copies"] >= 1 and jst["shared_prefix_tokens"] == 22


def test_preemption_with_shared_pages(model):
    (_, jst), _ = serve_pair(
        model, _greedy(_shared_prompts(tails=(4, 6, 2, 5), prefix=12, seed=7), 12),
        dict(BASE, num_pages=14, max_blocks_per_slot=8, share_prefix=True),
        gen=dict(max_new_tokens=12))
    assert jst["preemptions"] > 0 and jst["prefix_hits"] > 0


@pytest.mark.parametrize("pressure", [False, True])
def test_tiered_dense_arm_sharing(model, pressure):
    """The tiered engine shares its dense arm; with pressure on, escalation
    composes with sharing."""
    water = (dict(num_pages=13, low_watermark=0.5, critical_watermark=0.25) if pressure
             else dict(num_pages=33, low_watermark=0.0, critical_watermark=0.0))
    (_, jst), _ = serve_pair(
        model, _greedy(_shared_prompts(tails=(8, 10, 6, 7), prefix=12, seed=5), 8),
        dict(BASE, escalated_pages=33, enable_escalation=True, max_blocks_per_slot=8,
             share_prefix=True, **water),
        gen=dict(max_new_tokens=8))
    assert jst["prefix_hits"] > 0 and (jst["escalations"] > 0) == pressure


@pytest.mark.parametrize("share,mode", [(False, "dense"), (True, "dense"),
                                        (True, "decomposed")])
def test_defrag_every_serves_as_jax(model, share, mode):
    """Periodic compaction every 2 retirements, over a pool whose pages the
    retirements scatter."""
    (_, jst), _ = serve_pair(
        model, _greedy(_shared_prompts(tails=(5, 9, 3, 14, 7, 2, 11), seed=2), 7),
        dict(BASE, num_pages=41, defrag_every=2, share_prefix=share),
        gen=dict(max_new_tokens=7), rt=dict(mode=mode))
    assert jst["defrags"] > 0
