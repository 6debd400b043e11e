"""The port's static ``ServeEngine`` against the JAX package's, in float32
on qwen's smoke config with 2 layers and the same weights: greedy streams
and the stats dict identical in every ported mode (dense, T1 decomposed,
T2 CPQ with its streams capped at 12 tokens, T3 retrieval with ``top_k``
below the prompt length, so selection is real), with the contiguous
kernels' plain versions and with the plain path; EOS masking; prefill and
first-decode logits within 1e-4; and the refusals of what the port does
not serve yet."""
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS, smoke_config
from repro.configs.base import AttentionRuntime as JRuntime
from repro.configs.base import RetrievalCfg as JRetrievalCfg
from repro.models import model as JM
from repro.serving import engine as jeng
import repro_torch as T
from repro_torch.configs import RetrievalCfg
from repro_torch.models import model as TM
from repro_torch.params import from_jax

MODES = ("dense", "decomposed", "cpq", "retrieval")
TOP_K, RECENT = 10, 3
MAX_NEW = {"cpq": 12}   # CPQ turns last-ulp K/V differences into code steps over long streams


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(smoke_config(ARCHS["qwen1.5-0.5b"]), dtype="float32",
                              num_blocks=2)
    tcfg = dataclasses.replace(T.smoke_config(T.ARCHS["qwen1.5-0.5b"]), dtype="float32",
                               num_blocks=2)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _runtimes(mode, fused=True):
    if mode == "retrieval":
        return (T.AttentionRuntime(mode=mode, paged_kernels=fused,
                                   retrieval=RetrievalCfg(top_k=TOP_K, recent_window=RECENT)),
                JRuntime(mode=mode, retrieval=JRetrievalCfg(top_k=TOP_K,
                                                            recent_window=RECENT)))
    return T.AttentionRuntime(mode=mode, paged_kernels=fused), JRuntime(mode=mode)


def _prompts(vocab, B=3, S=17, seed=4):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_static_streams_and_stats_match_jax(model, mode, fused):
    cfg, tcfg, params, tparams = model
    rt, jrt = _runtimes(mode, fused)
    toks = _prompts(cfg.vocab_size)
    n = MAX_NEW.get(mode, 20)
    want, jst = jeng.ServeEngine(cfg, params, rt=jrt).generate(
        {"tokens": jnp.asarray(toks)}, jeng.GenerationConfig(max_new_tokens=n))
    got, tst = T.ServeEngine(tcfg, tparams, rt=rt, device="cpu").generate(
        {"tokens": toks}, T.GenerationConfig(max_new_tokens=n))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert tst == jst


def test_static_eos_masking_matches_jax(model):
    """An EOS id that rows emit mid-stream: later samples of such a row are
    masked to eos_id, only live tokens count, and the outputs equal the
    JAX engine's."""
    cfg, tcfg, params, tparams = model
    toks = _prompts(cfg.vocab_size, B=4, S=8, seed=7)
    eng = T.ServeEngine(tcfg, tparams, device="cpu")
    probe, _ = eng.generate({"tokens": toks}, T.GenerationConfig(max_new_tokens=16))
    eos = int(probe[0, 3])  # row 0 emits it at step 3 at the latest
    gen = dict(max_new_tokens=16, eos_id=eos)
    got, tst = eng.generate({"tokens": toks}, T.GenerationConfig(**gen))
    want, jst = jeng.ServeEngine(cfg, params).generate({"tokens": jnp.asarray(toks)},
                                                       jeng.GenerationConfig(**gen))
    np.testing.assert_array_equal(got, want)
    assert tst == jst
    for row in got:
        hits = np.flatnonzero(row == eos)
        if hits.size:
            assert (row[hits[0]:] == eos).all()
    live = sum(int(np.flatnonzero(r == eos)[0]) + 1 if (r == eos).any() else len(r)
               for r in got)
    assert tst["generated_tokens"] == live < got.size


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_first_decode_logits_match_jax(model, mode, fused):
    cfg, tcfg, params, tparams = model
    rt, jrt = _runtimes(mode, fused)
    toks = _prompts(cfg.vocab_size, B=2, S=15, seed=11)
    B, S, n_max = 2, 15, 20
    j_logits, jc = jax.jit(partial(JM.prefill, cfg, jrt))(
        params, {"tokens": jnp.asarray(toks)}, JM.init_caches(cfg, jrt, B, n_max))
    t_logits, tc = TM.prefill(tcfg, rt, tparams, torch.tensor(toks),
                              TM.init_caches(tcfg, rt, B, n_max, "cpu"))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=1e-4)
    nxt = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
    j_dec, _ = jax.jit(partial(JM.decode_step, cfg, jrt))(
        params, jnp.asarray(nxt), jnp.asarray(S, jnp.int32), jc)
    t_dec, tc = TM.decode_step(tcfg, rt, tparams, torch.tensor(nxt), S, tc)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec), atol=1e-4, rtol=1e-4)
    assert all(int(c.length) == S + 1 for c in TM.per_layer(tcfg, tc))


def test_static_engine_refusals(model):
    """Sampling serves (``test_torch_sampling.py``), and so does the T1+T2
    mode (``test_torch_decomposed_cpq.py``), and so do the recurrent layer
    kinds (``test_torch_engine_recurrent.py``); the cross-attention layer kind
    and non-token inputs are refused."""
    _, tcfg, _, tparams = model
    xlstm = T.smoke_config(T.ARCHS["xlstm-125m"])
    with pytest.raises(NotImplementedError, match="A19: the xattn mixer"):
        T.ServeEngine(dataclasses.replace(xlstm, prefix_pattern=(("xattn", "none"),)),
                      tparams, device="cpu")
    with pytest.raises(T.SchedulerConfigError, match="A19"):
        T.ServeEngine(dataclasses.replace(tcfg, input_kind="audio_frames"), tparams,
                      device="cpu")
