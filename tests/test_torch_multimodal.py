"""The port's cross-attention mixer and non-token inputs against the JAX
package's, at float32 on the smoke widths of llama-3.2-vision-11b (4
self-attention layers around one gated cross-attention layer over 16 patch
tokens) and musicgen-large (audio frames in place of the token lookup,
absolute positions, MHA), with the same weights on both sides (carried by
``from_jax``) and every cross-attention ``gate`` set to 0.5: the reference
draws it at zero, where the layer adds nothing and a comparison would check
none of it. Inputs are numpy draws from a seed.

Stated tolerances: 5e-5 absolute for the layer functions (``xattn_prefill``,
``xattn_decode``, the frame embedding), 1e-4 for prefill and first-decode
logits (the port's other model tests' gate), and identical greedy streams and
stats for the static engine (CPQ and T3 capped at 12 tokens: their codes
turn last-ulp K/V differences into whole steps over long streams). The JAX
side of a model comparison is jitted, since the port copies the jitted CPQ
numerics."""
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
from repro.configs.base import ServingCfg as JServingCfg
from repro.models import attention_layer as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.serving import engine as jeng
from repro.serving import paged_cache as jpgc
import repro_torch as T
from repro_torch.configs import RetrievalCfg
from repro_torch.models import attention_layer as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttfm
from repro_torch.params import from_jax
from repro_torch.serving import paged_cache as tpgc

LLAMA, MUSICGEN = "llama-3.2-vision-11b", "musicgen-large"
LAYER_TOL, LOGIT_TOL = 5e-5, 1e-4
GATE = 0.5
TOP_K, RECENT = 10, 3            # T3 selects: prompts are longer than TOP_K + RECENT
MAX_NEW = {"cpq": 12, "retrieval": 12, "decomposed_cpq": 12}
B, S = 2, 17
CASES = [(LLAMA, "dense"), (LLAMA, "decomposed"), (MUSICGEN, "dense"),
         (MUSICGEN, "decomposed"), (MUSICGEN, "cpq"), (MUSICGEN, "retrieval"),
         (MUSICGEN, "decomposed_cpq")]


def _with_gates(params, value):
    """The JAX tree with every cross-attention gate at ``value``."""
    def set_gate(path, a):
        return jnp.full_like(a, value) if "'gate'" in jax.tree_util.keystr(path) else a
    return jax.tree_util.tree_map_with_path(set_gate, params)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch, blocks in ((LLAMA, 1), (MUSICGEN, 2)):
        cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32",
                                  num_blocks=blocks)
        tcfg = dataclasses.replace(T.smoke_config(T.ARCHS[arch]), dtype="float32",
                                   num_blocks=blocks)
        params = _with_gates(JM.init_params(cfg, jax.random.PRNGKey(7)), GATE)
        out[arch] = (cfg, tcfg, params, from_jax(jax.tree.map(np.asarray, params),
                                                 device="cpu"))
    return out


def _batch(cfg, seed=3, b=B, s=S):
    """numpy inputs drawn as tests/test_models_smoke.py draws them: frames
    0.3 N(0, 1), patches N(0, 1)."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "audio_frames":
        return {"frames": (0.3 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)}
    if cfg.input_kind == "text+patches":
        out["patches"] = rng.standard_normal((b, cfg.num_patch_tokens,
                                              cfg.d_model)).astype(np.float32)
    return out


def _runtimes(mode, fused=True):
    if mode == "retrieval":
        return (T.AttentionRuntime(mode=mode, paged_kernels=fused,
                                   retrieval=RetrievalCfg(top_k=TOP_K, recent_window=RECENT)),
                JRuntime(mode=mode, retrieval=JRetrievalCfg(top_k=TOP_K,
                                                            recent_window=RECENT)))
    return T.AttentionRuntime(mode=mode, paged_kernels=fused), JRuntime(mode=mode)


def _xattn_params(models):
    """Llama's cross-attention layer (block position 3) on both sides."""
    cfg, tcfg, params, tparams = models[LLAMA]
    pos = [m for m, _ in cfg.block_pattern].index("xattn")
    jp = jax.tree.map(lambda a: a[0], params["blocks"][pos]["mixer"])
    return cfg, tcfg, jp, tparams["blocks"][pos][0]["mixer"]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("fused", [True, False])
def test_xattn_prefill_and_decode_match_jax(models, fused):
    """``xattn_prefill`` (queries of the prompt over the patches' K/V,
    non-causal, gated) and two ``xattn_decode`` steps over the static K/V,
    with the kernels' plain versions (``fused``) and with the plain path."""
    cfg, tcfg, jp, tp = _xattn_params(models)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    patches = rng.standard_normal((B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    rt = T.AttentionRuntime(paged_kernels=fused)
    jy, jc = jattn.xattn_prefill(cfg, jp, jnp.asarray(x), jnp.asarray(patches))
    arena = ttfm.layer_cache_init(tcfg, rt, ("xattn", "dense"), B, S, "cpu")
    ty, tc = tattn.xattn_prefill(tcfg, rt, tp, torch.from_numpy(x), torch.from_numpy(patches),
                                 arena)
    _close(ty, jy, LAYER_TOL)
    _close(tc.k, jc.k, LAYER_TOL)
    _close(tc.v, jc.v, LAYER_TOL)
    assert int(tc.length) == int(jc.length) == cfg.num_patch_tokens
    assert np.abs(np.asarray(jy)).max() > 0.05   # the gate lets the layer through
    for step in range(2):
        x_t = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jattn.xattn_decode(cfg, jp, jnp.asarray(x_t), jc)
        ty, tc = tattn.xattn_decode(tcfg, rt, tp, torch.from_numpy(x_t), tc)
        _close(ty, jy, LAYER_TOL)


@pytest.mark.parametrize("rows", [False, True])
def test_frame_embedding_matches_jax(models, rows):
    """musicgen's frames in place of the token lookup, plus the sinusoidal
    positions: shared positions (S,) or per-row positions (B, S)."""
    cfg, tcfg, params, tparams = models[MUSICGEN]
    frames = _batch(cfg, seed=5)["frames"]
    pos = np.arange(S, dtype=np.int32) + 3
    if rows:
        pos = np.stack([pos, pos + 40])
    jx = jlayers.embed_inputs(cfg, params["embed"], {"frames": jnp.asarray(frames)},
                              jnp.asarray(pos))
    tx = tlayers.embed_inputs(tcfg, tparams["embed"], {"frames": torch.from_numpy(frames)},
                              torch.from_numpy(pos))
    _close(tx, jx, LAYER_TOL)


@pytest.mark.parametrize("arch,mode", CASES)
def test_prefill_and_first_decode_logits_match_jax(models, arch, mode):
    cfg, tcfg, params, tparams = models[arch]
    rt, jrt = _runtimes(mode)
    batch = _batch(cfg)
    n_max = S + 4
    j_logits, jc = jax.jit(partial(JM.prefill, cfg, jrt))(
        params, jax.tree.map(jnp.asarray, batch), JM.init_caches(cfg, jrt, B, n_max))
    t_logits, tc = TM.prefill(tcfg, rt, tparams, {k: torch.from_numpy(v) for k, v in
                                                  batch.items()},
                              TM.init_caches(tcfg, rt, B, n_max, "cpu"))
    _close(t_logits, j_logits, LOGIT_TOL)
    nxt = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
    j_dec, _ = jax.jit(partial(JM.decode_step, cfg, jrt))(
        params, jnp.asarray(nxt), jnp.asarray(S, jnp.int32), jc)
    t_dec, _ = TM.decode_step(tcfg, rt, tparams, torch.from_numpy(nxt), S, tc)
    _close(t_dec, j_dec, LOGIT_TOL)


@pytest.mark.parametrize("arch,mode", CASES)
def test_static_streams_and_stats_match_jax(models, arch, mode):
    cfg, tcfg, params, tparams = models[arch]
    rt, jrt = _runtimes(mode)
    batch = _batch(cfg, seed=9)
    n = MAX_NEW.get(mode, 20)
    want, jst = jeng.ServeEngine(cfg, params, rt=jrt).generate(
        jax.tree.map(jnp.asarray, batch), jeng.GenerationConfig(max_new_tokens=n))
    got, tst = T.ServeEngine(tcfg, tparams, rt=rt, device="cpu").generate(
        batch, T.GenerationConfig(max_new_tokens=n))
    np.testing.assert_array_equal(got, want)
    assert tst == jst


def test_paged_xattn_branches_match_jax(models):
    """The paged model functions at a cross-attention layer, which the
    continuous engine never reaches (it refuses non-token inputs): the
    slot-indexed patch arena of ``init_paged_caches``, ``pack_prefill_caches``
    of two B=1 prefills into slots 1 and 0, and two ``decode_step_rows``."""
    cfg, tcfg, params, tparams = models[LLAMA]
    jrt, trt = JRuntime(), T.AttentionRuntime()
    serving = dict(num_slots=2, page_size=4, num_pages=17, max_blocks_per_slot=8)
    jcaches = JM.init_paged_caches(cfg, jrt, JServingCfg(**serving))
    tcaches = TM.init_paged_caches(tcfg, trt, T.ServingCfg(**serving), "cpu")
    bt = np.zeros((2, 8), np.int32)
    bt[0, :4], bt[1, :3] = [9, 3, 14, 1], [12, 5, 10]
    lengths = np.array([13, 9], np.int32)
    pack = jax.jit(partial(JM.pack_prefill_caches, cfg, jrt))
    for slot in (1, 0):
        batch = _batch(cfg, seed=20 + slot, b=1, s=int(lengths[slot]))
        jsrc = JM.init_caches(cfg, jrt, 1, int(lengths[slot]))
        jl, jsrc = JM.prefill(cfg, jrt, params, jax.tree.map(jnp.asarray, batch), jsrc)
        tl, tsrc = TM.prefill(tcfg, trt, tparams, {k: torch.from_numpy(v) for k, v in
                                                   batch.items()},
                              TM.init_caches(tcfg, trt, 1, int(lengths[slot]), "cpu"))
        _close(tl, jl, LOGIT_TOL)
        jcaches = pack(jcaches, jsrc, jnp.asarray(bt[slot]), jnp.asarray(slot, jnp.int32))
        TM.pack_prefill_caches(tcfg, trt, tcaches, tsrc, torch.from_numpy(bt[slot]), slot)
    pos = [m for m, _ in cfg.block_pattern].index("xattn")
    jx, tx = jcaches["blocks"][pos], tcaches["blocks"][pos][0]
    assert tx.k.shape == (2, cfg.num_patch_tokens, cfg.num_kv_heads, cfg.head_dim)
    _close(tx.k, jx.k[0], LAYER_TOL)
    _close(tx.v, jx.v[0], LAYER_TOL)
    assert int(tx.length) == int(np.asarray(jx.length)[0]) == cfg.num_patch_tokens
    decode = jax.jit(partial(JM.decode_step_rows, cfg, jrt))
    rng = np.random.default_rng(4)
    for active in (np.array([True, True]), np.array([False, True])):
        toks = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        jrows = jpgc.RowState(jnp.asarray(lengths), jnp.asarray(bt), jnp.asarray(active),
                              jnp.zeros(2, jnp.int32))
        trows = tpgc.RowState(torch.from_numpy(lengths), torch.from_numpy(bt),
                              torch.from_numpy(active), torch.zeros(2, dtype=torch.int32))
        jl, jcaches = decode(params, jnp.asarray(toks), jrows, jcaches)
        tl, _ = TM.decode_step_rows(tcfg, trt, tparams, torch.from_numpy(toks), trows, tcaches)
        _close(tl[active], np.asarray(jl)[active], LOGIT_TOL)
        lengths = lengths + active


@pytest.mark.parametrize("gate", [0.0, GATE])
def test_patches_reach_the_logits_through_the_gate(models, gate):
    """Patches scaled by 3 and shifted by 1 move the port's prefill and
    first-decode logits when the gate is nonzero, and leave them exactly as
    they were at the reference's initial gate of zero."""
    cfg, tcfg, params, _ = models[LLAMA]
    tparams = from_jax(jax.tree.map(np.asarray, _with_gates(params, gate)), device="cpu")
    rt = T.AttentionRuntime()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=13).items()}
    moved = {**batch, "patches": 3.0 * batch["patches"] + 1.0}
    logits = []
    for b in (batch, moved):
        pre, c = TM.prefill(tcfg, rt, tparams, b, TM.init_caches(tcfg, rt, B, S + 1, "cpu"))
        tok = batch["tokens"][:, :1]
        dec, _ = TM.decode_step(tcfg, rt, tparams, tok, S, c)
        logits.append(torch.stack([pre, dec]))
    diff = (logits[0] - logits[1]).abs().max().item()
    if gate:
        assert diff > 1e-2
    else:
        assert diff == 0.0


def test_decomposed_matches_dense_at_absolute_positions(models):
    """musicgen has no rope: T1 caches X alone and its decode is exact
    against dense (the reference's own property, tests/test_models_smoke.py),
    through the port's static engine path."""
    _, tcfg, _, tparams = models[MUSICGEN]
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, seed=17).items()}
    out = {}
    for mode in ("dense", "decomposed"):
        rt = T.AttentionRuntime(mode=mode)
        pre, c = TM.prefill(tcfg, rt, tparams, batch, TM.init_caches(tcfg, rt, B, S + 1, "cpu"))
        dec, _ = TM.decode_step(tcfg, rt, tparams, pre.argmax(-1).to(torch.int32)[:, None], S, c)
        out[mode] = dec
    _close(out["decomposed"], out["dense"], 3e-4)
