"""Seeded sampling of the port against the JAX package. ``serving/prng.py``
reproduces ``jax.random``'s Threefry bits, ``fold_in``, ``split`` and
``uniform`` bit for bit; ``gumbel`` goes through ``log`` twice, where torch
and XLA may differ in the last ulp. So a draw of ``sample_token_rows`` /
``sample_tokens`` may differ from JAX's only where the top two perturbed
logits lie within such an ulp: such draws are excused below a 1e-6 relative
gap, counted, and must stay below 1 in 1000. The engines then serve seeded
traffic with the same tokens, ticks and counters as the reference: mixed
greedy and sampled rows, recompute preemption (the replay re-draws the same
keys), legacy requests whose sampling comes from the session
GenerationConfig, and the static engine's key chain. Float32, CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hypothesis import given, settings, strategies as st

from repro.serving import engine as jeng
from repro_torch.serving import engine as teng
from repro_torch.serving import prng
import repro_torch as T

from torch_paged_cases import serve_pair, smoke_pair

U32 = st.integers(0, 2**32 - 1)
SEEDS = st.integers(0, 2**31 - 1)


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@settings(max_examples=60, deadline=None)
@given(seed=SEEDS, data=U32)
def test_keys_fold_in_and_split_are_bit_exact(seed, data):
    k = prng.PRNGKey(seed)
    jk = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(k.numpy(), _words(jk))
    np.testing.assert_array_equal(prng.fold_in(k, data).numpy(),
                                  _words(jax.random.fold_in(jk, np.uint32(data))))
    np.testing.assert_array_equal(prng.split(k).numpy(), _words(jax.random.split(jk)))
    np.testing.assert_array_equal(prng.split(k, 5).numpy(),
                                  _words(jax.random.split(jk, 5)))


@settings(max_examples=40, deadline=None)
@given(seed=SEEDS, index=st.integers(0, 2**31 - 1),
       shape=st.sampled_from([(1,), (7,), (3, 5), (2, 129)]))
def test_bits_and_uniform_are_bit_exact(seed, index, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), index)
    k = prng.fold_in(prng.PRNGKey(seed), index)
    np.testing.assert_array_equal(prng.random_bits(k, shape).numpy(),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (np.finfo(np.float32).tiny, 1.0)):
        np.testing.assert_array_equal(
            prng.uniform(k, shape, lo, hi).numpy().view(np.int32),
            np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi)).view(np.int32))


def test_batched_keys_draw_their_own_rows():
    """A batch of keys draws row b as key b alone would (the vmap of the
    per-key JAX draw)."""
    seeds = np.array([0, 5, 2**31 - 1], np.int32)
    idx = np.array([3, 0, 17], np.int32)
    keys = prng.fold_in(prng.PRNGKey(torch.tensor(seeds)), torch.tensor(idx))
    bits = prng.random_bits(keys, (33,)).numpy()
    for b in range(3):
        jk = jax.random.fold_in(jax.random.PRNGKey(int(seeds[b])), int(idx[b]))
        np.testing.assert_array_equal(bits[b], np.asarray(jax.random.bits(jk, (33,),
                                                                          jnp.uint32)))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_gumbel_within_two_ulp(seed):
    """The inner ``log`` of torch and XLA differ by at most an ulp; the
    outer ``log`` near 1 turns that into a large relative error around
    g = 0, so the ulp is taken at the scale the noise is added at: the
    larger of |g| and 1 (the logits it perturbs)."""
    g = prng.gumbel(prng.PRNGKey(seed), (151936,)).numpy().astype(np.float64)
    jg = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (151936,)))
    ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert (np.abs(g - jg) / ulp).max() <= 2.0


def _excused(perturbed: np.ndarray, got: int, want: int) -> bool:
    """A differing draw is excused iff the top two perturbed logits lie
    within 1e-6 of each other (relative) and the two draws are those two."""
    top2 = np.argsort(perturbed)[::-1][:2]
    a, b = perturbed[top2]
    return ({got, want} == set(top2.tolist())
            and abs(a - b) <= 1e-6 * max(abs(a), abs(b), 1.0))


def test_sample_token_rows_draws_as_jax():
    """4096 rows of seeded logits with mixed greedy / temperature / top-k /
    top-p rows draw the reference's tokens, excused draws aside."""
    rng = np.random.default_rng(0)
    B, V = 4096, 256
    logits = (rng.normal(size=(B, V)) * rng.uniform(0.5, 4.0, size=(B, 1))).astype(np.float32)
    temp = rng.choice([0.0, 0.5, 0.8, 1.0, 1.3], size=B).astype(np.float32)
    top_k = rng.choice([0, 1, 5, 50, 300], size=B).astype(np.int32)
    top_p = rng.choice([1.0, 0.9, 0.6, 0.05], size=B).astype(np.float32)
    seed = rng.integers(0, 2**31 - 1, size=B).astype(np.int32)
    index = rng.integers(0, 4096, size=B).astype(np.int32)
    want = np.asarray(jax.jit(jeng.sample_token_rows)(*map(jnp.asarray, (
        logits, temp, top_k, top_p, seed, index))))
    got = teng.sample_token_rows(*map(torch.tensor, (logits, temp, top_k, top_p, seed,
                                                     index))).numpy()
    diff = np.nonzero(got != want)[0]
    pert = teng.perturbed_logits(*map(torch.tensor, (logits, temp, top_k, top_p, seed,
                                                     index))).numpy()
    assert all(temp[b] > 0 and _excused(pert[b], got[b], want[b]) for b in diff), diff
    assert len(diff) * 1000 < B, len(diff)
    np.testing.assert_array_equal(got[temp <= 0], np.argmax(logits[temp <= 0], -1))
    np.testing.assert_array_equal(got[top_k == 1], np.argmax(logits[top_k == 1], -1))


@pytest.mark.parametrize("temperature,top_p", [(0.0, 1.0), (0.7, 1.0), (1.1, 0.8)])
def test_sample_tokens_key_chain_draws_as_jax(temperature, top_p):
    """The static engine's sampler over its key chain (``PRNGKey(seed)``,
    then ``split`` each step) draws the reference's tokens."""
    rng = np.random.default_rng(1)
    gen_j = jeng.GenerationConfig(temperature=temperature, top_p=top_p, seed=3)
    gen_t = teng.GenerationConfig(temperature=temperature, top_p=top_p, seed=3)
    jkey, key = jax.random.PRNGKey(3), prng.PRNGKey(3)
    diffs = draws = 0
    for step in range(40):
        logits = (rng.normal(size=(64, 256)) * 3).astype(np.float32)
        if step:
            jkey, jsub = jax.random.split(jkey)
            key, sub = prng.split(key)
        else:
            jsub, sub = jkey, key
        want = np.asarray(jeng.sample_tokens(jnp.asarray(logits), jsub, gen_j))
        got = teng.sample_tokens(torch.tensor(logits), sub, gen_t).numpy()
        diff = np.nonzero(got != want)[0]
        if len(diff):  # the static sampler's perturbed logits, one key a batch
            l = torch.tensor(logits) / temperature
            if top_p < 1.0:
                desc = torch.sort(l, dim=-1, descending=True).values
                l = torch.where(l < teng._nucleus_threshold(desc, torch.tensor([top_p])),
                                teng.NEG, l)
            pert = (prng.gumbel(sub, l.shape) + l).numpy()
            assert all(_excused(pert[b], got[b], want[b]) for b in diff), diff
        diffs += len(diff)
        draws += got.size
    assert diffs * 1000 < draws


@pytest.fixture(scope="module")
def model():
    return smoke_pair()


SERVING = dict(num_slots=3, page_size=4, num_pages=65, max_blocks_per_slot=8,
               prefill_bucket=4, prefill_chunk=4)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("num_pages,fused", [(65, True), (65, False), (10, True)])
def test_mixed_greedy_and_sampled_serve_as_jax(model, num_pages, fused):
    """Greedy rows beside sampled ones (top-k, top-p, both), with a roomy
    arena and a tight one that forces recompute preemption: the replay
    re-draws the same keys, so the streams are the reference's."""
    prompts = _prompts(7, (5, 9, 7, 4, 8, 6))

    def requests(ns):
        return [ns.ServeRequest(prompt=p, rid=i, sampling=ns.SamplingParams(
            temperature=(0.0, 0.9, 0.7, 1.2)[i % 4], top_k=(0, 12, 0, 5)[i % 4],
            top_p=(1.0, 0.9, 0.8, 1.0)[i % 4], max_tokens=12, seed=100 + i))
            for i, p in enumerate(prompts)]

    (_, jst), _ = serve_pair(model, requests, dict(
        SERVING, num_pages=num_pages, use_paged_kernels=fused),
        gen=dict(max_new_tokens=12))
    if num_pages == 10:
        assert jst["preemptions"] > 0


def test_session_sampling_of_legacy_requests(model):
    """Scheduler Requests without SamplingParams sample with the session
    GenerationConfig, seeded ``seed + rid``."""
    prompts = _prompts(3, (6, 11, 4))

    def requests(ns):
        return [ns.Request(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]

    serve_pair(model, requests, SERVING,
               gen=dict(max_new_tokens=8, temperature=0.8, top_p=0.9, seed=5))


def test_one_shot_admission_samples_its_first_token(model):
    prompts = _prompts(4, (6, 11, 4))

    def requests(ns):
        return [ns.ServeRequest(prompt=p, rid=i, sampling=ns.SamplingParams(
            temperature=0.9, top_k=20, max_tokens=6, seed=i)) for i, p in enumerate(prompts)]

    serve_pair(model, requests, dict(SERVING, prefill_chunk=0))


@pytest.mark.parametrize("temperature,top_p", [(0.8, 1.0), (1.0, 0.9)])
def test_static_engine_samples_as_jax(model, temperature, top_p):
    cfg, tcfg, params, tparams = model
    toks = np.random.default_rng(2).integers(0, 256, size=(3, 7)).astype(np.int32)
    out_j, _ = jeng.ServeEngine(cfg, params).generate(
        {"tokens": jnp.asarray(toks)},
        jeng.GenerationConfig(max_new_tokens=6, temperature=temperature, top_p=top_p,
                              seed=11))
    out_t, _ = T.ServeEngine(tcfg, tparams, device="cpu").generate(
        {"tokens": toks}, T.GenerationConfig(max_new_tokens=6, temperature=temperature,
                                             top_p=top_p, seed=11))
    np.testing.assert_array_equal(out_t, np.asarray(out_j))
