"""The port's optimizers, schedule, compression, train step and synthetic
data against the JAX package's, at float32 on the CPU.

AdamW and Adafactor take two steps from the same seeded numpy gradients
(scaled so that the global-norm clip acts) on whole parameter trees of
the eleven smoke configurations at three blocks: the port's per-layer
leaves are stacked into the reference's (num_blocks, ...) leaves inside
the optimizer, so a norm scale (3, d) is factored with its column moment
shared by the layers, a cross-attention gate (3,) is a full moment, and
Adafactor's update clip takes the RMS over the whole stacked leaf. Stated
tolerances: parameters and updates within 1e-6 of each leaf's own
largest magnitude (worst seen 3.7e-7), float32 moments within 5e-6 (worst
seen 1.8e-6: a second moment is a square, so it doubles the relative
error of the clipped gradients, whose clip scale sums the global norm in
another order), and none farther than 1e-6 of the tree's largest
magnitude (at least 1), absolute. Adafactor's first moment is bf16, and a
last-ulp difference of its float32 input can round it the other way:
there, at most 0.1 % of a tree's elements may differ by more than 1e-6 of
their leaf's largest, and none by more than two bf16 steps (2^-7
relative) of the leaf's largest moment, or the peak lr times that in the
updates and parameters.

``make_train_step``: one step of the port against the reference's (JAX at
``remat=False``; the port with remat on) with one and with two
microbatches, under a plain SGD probe (``torch_train_cases.sgd_pair``),
so that the step's float32 gradient accumulation is compared as it is
(qwen's and deepseek-moe's smoke configs; ``test_torch_train_model.py``
holds a one-microbatch step of all eleven). The loss within 1e-5 (the
reference's microbatch check, ``atol=1e-5``), each parameter leaf's
change within 1e-5 of its own largest change and 1e-5 of the largest
parameter (at least 1); and, as the reference's
own check, the port's two
microbatches against its one under AdamW on the first leaf.
``SyntheticLMData`` gives the reference's arrays for every config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeCfg as JShapeCfg
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JData
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import compress_int8 as j_compress
from repro.optim import cosine_schedule as j_cosine
from repro.optim import decompress_int8 as j_decompress
from repro.train.step import TrainStepCfg as JTrainStepCfg
from repro.train.step import make_train_step as j_make_train_step
import repro_torch.configs as tc
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.optim import (adafactor, adamw, apply_updates, compress_int8, cosine_schedule,
                               decompress_int8)
from repro_torch.params import ref_leaves
from repro_torch.train.step import TrainStepCfg, make_train_step
from torch_train_cases import (as_jax, as_torch, assert_leaves_close, assert_steps_close,
                               batch_np, jax_leaves, jax_params, leaf_scale, numpy_params,
                               pair, port_leaves, sgd_pair, SMOKE_ARCHS, to_torch,
                               tree_cap)

TOL = 1e-6
STATE_TOL = 5e-6
BF16_STEP = 2.0 ** -8


def _grads(params, seed: int, norm: float = 4.0):
    """Seeded gradients shaped like the JAX parameters, at a global norm of
    ``norm`` (above the optimizers' clip of 1)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(params)
    g = [rng.standard_normal(np.shape(x)).astype(np.float32) for x in leaves]
    total = np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in g))
    g = [x * np.float32(norm / total) for x in g]
    return jax.tree.unflatten(treedef, [jnp.asarray(x) for x in g])


def _state_leaves(state, port: bool):
    return [[t.detach().double().numpy() for t in ref_leaves(f)] if port else jax_leaves(f)
            for f in state]


def _assert_bf16_close(got: list, want: list, step_tols: list, what: str) -> None:
    """Every leaf within TOL of its own largest magnitude but for at most
    0.1 % of the tree's elements, and every element within its leaf's
    ``step_tols`` entry more."""
    off = sum(int(np.sum(np.abs(g - w) > TOL * leaf_scale(w))) for g, w in zip(got, want))
    assert off <= 1e-3 * sum(w.size for w in want), (what, off)
    for i, (g, w, step_tol) in enumerate(zip(got, want, step_tols)):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * leaf_scale(w) + step_tol,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_jax(arch, name):
    jcfg, _ = pair(arch, num_blocks=3)
    jp = numpy_params(jcfg, seed=0)
    peak = 1e-2
    lr_j, lr_t = j_cosine(peak, 1, 10), cosine_schedule(peak, 1, 10)
    j_opt = (j_adamw if name == "adamw" else j_adafactor)(lr_j, weight_decay=0.1)
    t_opt = (adamw if name == "adamw" else adafactor)(lr_t, weight_decay=0.1)
    tp = to_torch(jp)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    j_update = jax.jit(j_opt.update)
    j_apply = jax.jit(lambda params, updates: jax.tree.map(
        lambda p, u: (p.astype(jnp.float32) + u).astype(p.dtype), params, updates))
    for step in range(2):
        jg = _grads(jp, seed=step)
        ju, js = j_update(jg, js, jp, jnp.asarray(step, jnp.int32))
        jp = j_apply(jp, ju)
        tu, ts = t_opt.update(to_torch(jg), ts, tp, step)
        tp = apply_updates(tp, tu)
        got, want = _state_leaves(ts, True), _state_leaves(js, False)
        if name == "adamw":
            assert_leaves_close(port_leaves(tu), jax_leaves(ju), TOL, f"updates {step}")
            assert_leaves_close(port_leaves(tp), jax_leaves(jp), TOL, f"params {step}")
        else:
            m_step = [2 * BF16_STEP * leaf_scale(w) for w in want[0]]
            _assert_bf16_close(got[0], want[0], m_step, f"m {step}")
            lr_step = [peak * x for x in m_step]
            _assert_bf16_close(port_leaves(tu), jax_leaves(ju), lr_step, f"updates {step}")
            _assert_bf16_close(port_leaves(tp), jax_leaves(jp), lr_step, f"params {step}")
            got, want = got[1:], want[1:]
        for i, (g, w) in enumerate(zip(got, want)):
            assert_leaves_close(g, w, STATE_TOL, f"{name} state {i} step {step}",
                                cap=tree_cap(w, TOL))
    if name == "adafactor":  # the stacked norm scale is factored: v_col shared
        assert ts.v_col["blocks"][0]["norm1"]["scale"].shape == (jcfg.d_model,)
        assert ts.v_row["blocks"][0]["norm1"]["scale"].shape == (3,)


def test_cosine_schedule_matches_jax():
    j, t = j_cosine(3e-4, 20, 100), cosine_schedule(3e-4, 20, 100)
    for s in range(0, 101):
        assert float(t(s)) == pytest.approx(float(j(jnp.asarray(s, jnp.int32))), rel=1e-6)
    assert float(t(torch.tensor(5))) == float(t(5))


def test_int8_compression_matches_jax():
    x = np.random.default_rng(0).standard_normal((37, 11)).astype(np.float32)
    jc, js = j_compress(jnp.asarray(x))
    tc_, ts = compress_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tc_.numpy(), np.asarray(jc))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(decompress_int8(tc_, ts).numpy(),
                                  np.asarray(j_decompress(jc, js)))


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_synthetic_data_matches_jax(arch):
    from repro.configs import ARCHS, smoke_config

    jcfg = smoke_config(ARCHS[arch])
    tcfg = tc.smoke_config(tc.ARCHS[arch])
    jd = JData(jcfg, JShapeCfg("train", 32, 4, "train"), JDataConfig(seed=3))
    td = SyntheticLMData(tcfg, tc.ShapeCfg("train", 32, 4, "train"), DataConfig(seed=3))
    for step in (0, 1, 7):
        a, b = jd.batch(step), td.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    it = td.iter_from(5)
    try:
        np.testing.assert_array_equal(next(it)["labels"], jd.batch(5)["labels"])
        np.testing.assert_array_equal(next(it)["labels"], jd.batch(6)["labels"])
    finally:
        it.close()


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-moe-16b"])
def test_train_step_matches_jax_with_and_without_microbatches(arch):
    jcfg, tcfg = pair(arch)
    jp = jax_params(jcfg)
    # no padded labels: each microbatch's mean then weighs as many tokens
    batch = batch_np(jcfg, seed=1, B=4, S=16, pad=False)
    j_opt, t_opt = sgd_pair(0.5)
    out = {}
    for k in (1, 2):
        j_step = jax.jit(j_make_train_step(jcfg, j_opt, JTrainStepCfg(
            microbatches=k, remat=False)))
        jp2, _, jm = j_step(jp, (), jnp.asarray(0, jnp.int32), as_jax(batch))
        t_step = make_train_step(tcfg, t_opt, TrainStepCfg(microbatches=k, remat=True))
        tp2, _, tm = t_step(to_torch(jp), (), 0, as_torch(batch))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
        for key in ("nll", "aux"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), abs=1e-5)
        assert_steps_close(port_leaves(tp2), jax_leaves(jp2), jax_leaves(jp), 1e-5,
                           f"params mb={k}", cap=tree_cap(jax_leaves(jp2), 1e-5))
        out[k] = (tm, tp2)
    if tcfg.moe is None:  # MoE routing and its aux loss depend on the token group
        assert float(out[2][0]["loss"]) == pytest.approx(float(out[1][0]["loss"]), abs=1e-5)
        one = port_leaves(out[1][1])
        assert_steps_close(port_leaves(out[2][1]), one, jax_leaves(jp), 1e-5, "mb 2 vs 1",
                           cap=tree_cap(one, 1e-5))


def test_train_step_microbatch_equivalence_under_adamw():
    """The reference's own check (``test_system.py``) on the port: qwen's
    smoke config, 4 x 32 tokens, AdamW; the first leaf's update and the
    loss agree between one microbatch and two."""
    _, tcfg = pair("qwen1.5-0.5b")
    from repro_torch.params import init_params

    params = init_params(tcfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab_size, (4, 32)))
    batch = {"tokens": toks, "labels": toks}
    opt = adamw(1e-3)
    outs = {}
    for k in (1, 2):
        step = make_train_step(tcfg, opt, TrainStepCfg(microbatches=k, remat=False))
        p2, _, m = step(params, opt.init(params), 0, batch)
        outs[k] = (port_leaves(p2)[0], float(m["loss"]))
    np.testing.assert_allclose(outs[1][0], outs[2][0], atol=1e-5)
    np.testing.assert_allclose(outs[1][1], outs[2][1], rtol=1e-5)
