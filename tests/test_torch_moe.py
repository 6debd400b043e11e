"""The port's mixture-of-experts MLP (``models/moe.py``) against the JAX
package's, and the deepseek-moe-16b stack (attention layers with MoE MLPs)
served by the port against the reference's paged engine. Float32, the same
seeded numpy inputs and the same weights on both sides. Stated tolerances:
1e-5 for ``apply_moe`` (relative, and absolute on the output's scale), 1e-4
for logits."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.common.param import init_tree
from repro.configs import ARCHS, smoke_config
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.serving.trace import make_workload
import repro_torch as T
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from torch_paged_cases import serve_pair, smoke_pair

OP_TOL = 1e-5
LOGIT_TOL = 1e-4


def _cfgs(num_shared, capacity_factor, num_experts=8, top_k=2):
    """deepseek-moe-16b's smoke config in both packages at f32, with the MoE
    settings replaced."""
    out = []
    for base in (smoke_config(ARCHS["deepseek-moe-16b"]),
                 T.smoke_config(T.ARCHS["deepseek-moe-16b"])):
        moe = dataclasses.replace(base.moe, num_shared=num_shared, top_k=top_k,
                                  num_experts=num_experts, capacity_factor=capacity_factor)
        out.append(dataclasses.replace(base, dtype="float32", moe=moe))
    return out


def _weights(jcfg, seed):
    jp = init_tree(jmoe.moe_defs(jcfg), jax.random.PRNGKey(seed))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _drops_of_jax(jcfg, jp, x):
    """(token, choice) pairs the reference's capacity drops, counted from its
    own router (``lax.top_k`` on the float32 softmax) by the FIFO rule."""
    m = jcfg.moe
    S = x.shape[0] * x.shape[1]
    g = min(jmoe.GROUP, S)
    xf = np.pad(x.reshape(S, -1), ((0, (-S) % g), (0, 0)))
    C = min(max(int(m.capacity_factor * g * m.top_k / m.num_experts), 4), g)
    probs = jax.nn.softmax(jnp.asarray(xf.reshape(-1, g, xf.shape[-1])) @ jp["router"], -1)
    _, top_e = jax.lax.top_k(probs, m.top_k)
    drops = 0
    for grp in np.asarray(top_e):
        seen = np.zeros(m.num_experts, int)
        for e in grp.reshape(-1):   # token-major (g * K) order
            drops += seen[e] >= C
            seen[e] += 1
    return int(drops)


@pytest.mark.parametrize("num_shared,cf,B,T_,drops", [
    (1, 2.0, 2, 7, False),      # one group, no drop (C = g)
    (0, 2.0, 2, 7, False),      # no shared experts
    (1, 1.25, 3, 400, True),    # 1200 tokens: two groups of 1024, the last padded
    (1, 0.25, 2, 300, True),    # a low capacity: drops in every group
    (0, 0.5, 1, 1100, True),    # padded group, no shared experts
])
def test_apply_moe_matches_jax(num_shared, cf, B, T_, drops):
    jcfg, tcfg = _cfgs(num_shared, cf)
    jp, tp = _weights(jcfg, 3)
    x = np.random.default_rng(B * T_).normal(size=(B, T_, jcfg.d_model)).astype(np.float32)
    j_out, j_aux = jax.jit(lambda p, x: jmoe.apply_moe(jcfg, p, x))(jp, jnp.asarray(x))
    t_out, t_aux = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x))
    # 1e-5 of the output's scale: at fan-in E the expert weights are wide and
    # the outputs reach ~20, so float32 sums differ past 1e-5 absolute
    scale = max(1.0, float(np.abs(np.asarray(j_out)).max()))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=OP_TOL * scale,
                               rtol=OP_TOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), atol=OP_TOL, rtol=OP_TOL)
    # the port's capacity drops, counted from its own combine weights
    S = B * T_
    g = min(tmoe.GROUP, S)
    xg = torch.nn.functional.pad(torch.from_numpy(x).reshape(S, -1), (0, 0, 0, (-S) % g))
    *_, combine = tmoe.route(tcfg, tp["router"], xg.reshape(-1, g, jcfg.d_model))
    t_drops = xg.shape[0] * tcfg.moe.top_k - int((combine > 0).sum())
    assert t_drops == _drops_of_jax(jcfg, jp, x)
    assert (t_drops > 0) == drops


def test_top_k_ties_take_the_lower_expert():
    """Equal router probabilities pick the lower expert index first, as
    ``lax.top_k`` does."""
    jcfg, tcfg = _cfgs(0, 2.0, num_experts=8, top_k=3)
    router = np.zeros((jcfg.d_model, 8), np.float32)
    router[0, [1, 5, 6]] = 1.0        # experts 1, 5 and 6 tie above the rest
    x = np.zeros((1, 4, jcfg.d_model), np.float32)
    x[..., 0] = 2.0
    *_, top_e, _ = tmoe.route(tcfg, torch.from_numpy(router), torch.from_numpy(x))
    _, j_top = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ router, -1), 3)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(j_top))
    assert top_e[0, 0].tolist() == [1, 5, 6]


@pytest.fixture(scope="module")
def moe_model():
    return smoke_pair("deepseek-moe-16b", num_blocks=2)


@pytest.mark.parametrize("mode", ["dense", "decomposed", "cpq", "retrieval"])
def test_prefill_and_decode_logits_match_jax(moe_model, mode):
    """The contiguous forward passes of the whole stack (one attn + dense
    layer, two attn + MoE layers): prefill of a batch of prompts, then two
    decode steps."""
    cfg, tcfg, params, tparams = moe_model
    jrt = dataclasses.replace(cfg.attention, mode=mode)
    rt = T.AttentionRuntime(mode=mode)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    jl, jc = JM.prefill(cfg, jrt, params, {"tokens": jnp.asarray(toks)},
                        JM.init_caches(cfg, jrt, 2, 16))
    tlg, tc = TM.prefill(tcfg, rt, tparams, {"tokens": torch.from_numpy(toks)},
                         TM.init_caches(tcfg, rt, 2, 16, "cpu"))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for t in range(2):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = JM.decode_step(cfg, jrt, params, jnp.asarray(nxt),
                                jnp.asarray(13 + t, jnp.int32), jc)
        tlg, tc = TM.decode_step(tcfg, rt, tparams, torch.from_numpy(nxt), 13 + t, tc)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def _work(vocab, n=6, cap=None):
    return [(w.rid, w.prompt, min(w.target, cap or w.target), w.arrival)
            for w in make_workload(0, n, vocab, 0.5)]


@pytest.mark.parametrize("mode", ["dense", "decomposed", "cpq", "retrieval"])
def test_engine_matches_jax(moe_model, mode):
    """Greedy streams, tick stamps, ``stats()`` and output events identical
    to the reference's paged engine. The serving config asks for chunks of
    8, but a MoE stack admits one-shot, as the reference does (its routing
    depends on the token group). CPQ generations are capped at 12 tokens,
    as in ``test_torch_engine_cpq.py`` (4-bit codes amplify the frameworks'
    last-ulp K/V differences)."""
    cap = 12 if mode == "cpq" else None
    work = _work(moe_model[0].vocab_size, cap=cap)
    (_, jst), (_, tst) = serve_pair(
        moe_model, lambda ns: [ns.Request(rid=r, prompt=p, max_new_tokens=n, arrival=a)
                               for r, p, n, a in work],
        dict(num_slots=3, page_size=4, num_pages=65, max_blocks_per_slot=32,
             prefill_chunk=8, prefill_bucket=8),
        gen=dict(max_new_tokens=cap or 30), rt=dict(mode=mode))
    assert not tst["chunked_prefill"] and tst["prefill_chunks"] == 0
    assert tst["cache_mode"] == mode and tst["admitted"] == len(work)


def test_static_engine_matches_jax(moe_model):
    from repro.serving import engine as jeng

    cfg, tcfg, params, tparams = moe_model
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(3, 11)).astype(np.int32)
    out_j, st_j = jeng.ServeEngine(cfg, params).generate(
        {"tokens": jnp.asarray(toks)}, jeng.GenerationConfig(max_new_tokens=8))
    out_t, st_t = T.ServeEngine(tcfg, tparams, device="cpu").generate(
        {"tokens": toks}, T.GenerationConfig(max_new_tokens=8))
    np.testing.assert_array_equal(out_t, np.asarray(out_j))
    assert st_t["decode_steps"] == st_j["decode_steps"]
