"""The port's training mesh (``repro_torch.train.sharded`` over
``launch/mesh.make_production_mesh``) against the JAX package.

* Spec trees: ``models.model.param_specs`` (both rule sets, on the two
  production mesh shapes and on (2, 2)) and both optimizers' ``state_specs``
  and ``state_like`` shapes equal the reference's for all eleven
  configurations at their published widths, compared in the reference's
  (stacked) layout; the port's per-layer specs are the stacked ones without
  their leading ``"layers"`` axis. Shapes only: a stand-in with
  ``axis_names`` and ``devices.shape`` serves the reference's functions.
* The mesh step at float32 over a (2, 2) mesh of CPU shards against the
  port's unsharded step, on dense, MLA + MoE, Mamba (jamba), xLSTM,
  cross-attention and audio-frame smoke configs, with 1 and 2 microbatches:
  a plain SGD probe's step (the step's gradients reach the parameters as
  they are: every leaf's change within 1e-5 of the reference's largest,
  ``assert_steps_close``) against the unsharded step in one pass a
  microbatch, on a batch with row 0 alone padded (the replicas weigh by
  their labelled tokens), and against the unsharded step over the mesh's
  own split of the rows (each replica's rows of each microbatch a
  microbatch of their own) on a batch with every row's tail padded (the
  split's microbatches weigh alike, so the two are one function there);
  then 2 AdamW steps and 1 Adafactor step against the step over that
  split: every loss within 1e-5 relative, and after the last step the
  parameters (as the SGD probe's) and every state tensor within 1e-5 of
  its largest |value| (Adafactor's bf16 first moment within one bf16 step,
  and its parameters within lr times that more); every block of the shape
  its fitted spec implies, on its position's device. ``update_sharded``
  against ``update`` on seeded gradients, on three meshes, likewise.
* The same against the reference's pjit step (``in_shardings`` /
  ``out_shardings`` from ``param_specs`` and ``state_specs`` inside
  ``sharding_context``, as ``launch/train.py:79-99``) on 4 emulated host
  devices with ``AxisType.Auto`` axes (the JAX version here makes Explicit
  axes by default, under which the reference's step raises), for qwen and
  the MLA + MoE config, in one subprocess: the SGD probe's parameters, each
  grid position's block equal to the reference's shard on the device at
  that position, and AdamW's and Adafactor's first step (the loss and
  every state tensor, Adafactor's bf16 first moment within one bf16 step).
* The launcher: ``--mesh single`` and ``--mesh multi`` on ``--device cpu``
  end at ``--mesh none``'s final loss within 1e-5 relative, and a
  checkpoint crosses from a mesh run to an unsharded one and back.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JARCHS
from repro.distributed import rules as jrules
from repro.models import model as JM
from repro.optim import adafactor as j_adafactor, adamw as j_adamw
import repro_torch.configs as tc
from repro_torch.distributed.rules import param_rules
from repro_torch.distributed.sharding import P, position_index
from repro_torch.launch.mesh import make_production_mesh, make_serve_mesh
from repro_torch.models import model as M
from repro_torch.optim import Optimizer, adafactor, adamw
from repro_torch.params import ref_leaves, stack_blocks, tree_map
from repro_torch.train.sharded import (gather_params, gather_tree, init_sharded,
                                       make_mesh_train_step, replica_axes, replica_devices,
                                       shard_tree, train_specs)
from repro_torch.train.step import TrainStepCfg, make_train_step

import torch_paged_cases  # noqa: F401  (one intra-op thread)
from conftest import run_with_devices
from torch_train_cases import (SMOKE_ARCHS, assert_steps_close, batch_np, numpy_params,
                               pair, to_torch)

MESH_SHAPES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
               {"data": 2, "model": 2}]
STEP_ARCHS = ["qwen1.5-0.5b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b", "xlstm-125m",
              "llama-3.2-vision-11b", "musicgen-large"]
TOL = 1e-5
BF16_STEP = 2.0 ** -8  # one bf16 rounding step, relative


def _stand_in(shape: dict):
    return SimpleNamespace(axis_names=tuple(shape), devices=np.empty(tuple(shape.values())))


def _jspecs(tree) -> list:
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))]


def _specs(tree) -> list:
    return [tuple(s) for s in ref_leaves(tree)]


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_param_and_state_specs_match_the_reference(arch):
    cfg, jcfg = tc.get_config(arch), JARCHS[arch]
    abstract, jabstract = M.abstract_params(cfg, stacked=True), JM.abstract_params(jcfg)
    assert [tuple(a.shape) for a in ref_leaves(abstract)] == \
        [a.shape for a in jax.tree.leaves(jabstract)]
    assert [str(a.dtype).split(".")[-1] for a in ref_leaves(abstract)] == \
        [str(a.dtype) for a in jax.tree.leaves(jabstract)]
    for multi in (False, True):
        rules = param_rules(multi)
        for ms in [None] + MESH_SHAPES:
            mine = M.param_specs(cfg, rules, ms, stacked=True)
            want = JM.param_specs(jcfg, jrules.param_rules(multi), ms)
            assert _specs(mine) == _jspecs(want), (multi, ms)
            # the port's per-layer specs: the stacked ones without "layers"
            flat = M.param_specs(cfg, rules, ms)
            for j, layers in enumerate(flat["blocks"]):
                for layer in layers:
                    assert _specs(layer) == [s[1:] for s in _specs(mine["blocks"][j])]
            assert _specs(flat["embed"]) == _specs(mine["embed"])
            for name, mk, jmk in (("adamw", adamw, j_adamw), ("adafactor", adafactor,
                                                                j_adafactor)):
                opt, jopt = mk(1e-3), jmk(1e-3)
                got = opt.state_specs(mine, abstract)
                ref = jopt.state_specs(want, jabstract)
                assert _specs(got) == _jspecs(ref), (name, multi, ms)
                like, jlike = opt.state_like(abstract), jopt.state_like(jabstract)
                assert [(tuple(a.shape), a.device.type) for a in ref_leaves(like)] == \
                    [(a.shape, "meta") for a in jax.tree.leaves(jlike)], name
                assert [str(a.dtype).split(".")[-1] for a in ref_leaves(like)] == \
                    [str(a.dtype) for a in jax.tree.leaves(jlike)], name


def sgd_probe(lr: float) -> Optimizer:
    """A plain SGD (``-lr * g``), also over sharded trees."""
    def sharded(g, st, p, step):
        return tree_map(lambda gg, pp: pp.map(lambda a, b: (a.float() - lr * b).to(a.dtype),
                                              gg), g, p), st

    return Optimizer(init=lambda p: (),
                     update=lambda g, st, p, step: (tree_map(lambda x: -lr * x, g), st),
                     state_like=lambda p: (), state_specs=lambda ps, a: (),
                     update_sharded=sharded)


def _config(arch: str):
    jcfg, cfg = pair(arch)
    return cfg, to_torch(numpy_params(jcfg, 0)), [
        {k: torch.from_numpy(v) for k, v in batch_np(cfg, s, B=4, S=16).items()}
        for s in range(2)]


def _check_blocks(tree, specs, mesh) -> None:
    """Every block of the shape its fitted spec implies, on its device."""
    for a, s in zip(ref_leaves(tree), ref_leaves(specs)):
        assert a.spec == s
        for pos in np.ndindex(*mesh.devices.shape):
            blk = a.at(pos)
            assert tuple(blk.shape) == a.block_shape and 0 not in blk.shape
            assert blk.device == mesh.devices[pos]


def _state_close(got, want, what: str) -> None:
    """Float32 state leaves within TOL of their largest |value|; a bf16
    first moment within one bf16 step."""
    for i, (g, w) in enumerate(zip(ref_leaves(got), ref_leaves(want))):
        rel = BF16_STEP if w.dtype == torch.bfloat16 else TOL
        g, w = g.double().numpy(), w.double().numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(1e-12, np.abs(w).max()),
                                   err_msg=f"{what} leaf {i}")


def _adafactor_params_close(got: list, want: list, old: list, m: list, lr: float,
                            what: str) -> None:
    """Parameters after Adafactor steps: each leaf's change within TOL of
    the reference's largest, one float32 rounding step, and lr times one
    bf16 step of the leaf's first moment (a bf16 moment that rounds one
    step the other way moves its update by that much)."""
    for i, (g, w, o) in enumerate(zip(got, want, old)):
        allow = lr * BF16_STEP * max(1e-12, float(np.abs(m[i].double().numpy()).max()))
        np.testing.assert_allclose(g - o, w - o, rtol=0,
                                   atol=TOL * np.abs(w - o).max() + allow + 2 ** -23,
                                   err_msg=f"{what} leaf {i}")


def _leaves64(tree) -> list:
    return [t.double().numpy() for t in ref_leaves(tree)]


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_mesh_step_matches_the_unsharded_step(arch, microbatches):
    cfg, params, batches = _config(arch)
    mesh = make_serve_mesh(2, 2, devices="cpu")
    tcfg = TrainStepCfg(microbatches=microbatches)
    # the unsharded step over the mesh's own split of the rows: each data
    # replica's rows of each microbatch a microbatch of their own
    replicas = len(replica_devices(mesh, replica_axes(cfg, 4 // microbatches, mesh)))
    split = TrainStepCfg(microbatches=replicas * microbatches)
    old = _leaves64(stack_blocks(params))
    # the split's microbatches weigh alike, the mesh's replicas by their
    # labelled tokens: the two are one function where every row has as many
    # (every row's tail padded), and the mesh step's weighting is held on
    # the batch with row 0 alone padded against the step in one pass
    even = [dict(b, labels=torch.where(torch.arange(b["labels"].shape[1]) >= 13, -1,
                                       b["labels"])) for b in batches]
    sgd = sgd_probe(0.5)
    step = make_mesh_train_step(cfg, sgd, tcfg, mesh)
    for ref_cfg, batch in ((tcfg, batches[0]), (split, even[0])):
        sp, _ = init_sharded(cfg, sgd, params, mesh)
        got, _, m_got = step(sp, (), 0, batch)
        want, _, m_want = make_train_step(cfg, sgd, ref_cfg)(params, (), 0, batch)
        assert abs(float(m_got["loss"]) - float(m_want["loss"])) <= \
            TOL * abs(float(m_want["loss"])), ref_cfg
        assert_steps_close(_leaves64(gather_tree(got, "cpu")), _leaves64(stack_blocks(want)),
                           old, TOL, f"{arch} sgd {ref_cfg.microbatches}")
    # AdamW over 2 steps, Adafactor over 1, against the unsharded step over
    # the same split: every loss, then the parameters and every state tensor
    for name, opt, steps in (("adamw", adamw(1e-4, weight_decay=0.1), 2),
                             ("adafactor", adafactor(1e-4), 1)):
        p, st = params, opt.init(params)
        sp, sst = init_sharded(cfg, opt, params, mesh)
        pspecs, ospecs = train_specs(cfg, opt, mesh)
        _check_blocks(sp, pspecs, mesh)
        _check_blocks(sst, ospecs, mesh)
        ref, mesh_step = make_train_step(cfg, opt, split), make_mesh_train_step(cfg, opt, tcfg,
                                                                                 mesh)
        for s in range(steps):
            p, st, m_want = ref(p, st, s, even[s])
            sp, sst, m_got = mesh_step(sp, sst, s, even[s])
            assert abs(float(m_got["loss"]) - float(m_want["loss"])) <= \
                TOL * abs(float(m_want["loss"])), (arch, s)
        got_p = _leaves64(stack_blocks(gather_params(sp, "cpu")))
        want_p = _leaves64(stack_blocks(p))
        if name == "adamw":
            assert_steps_close(got_p, want_p, old, TOL, f"{arch} adamw params")
        else:
            _adafactor_params_close(got_p, want_p, old, ref_leaves(st.m), 1e-4,
                                    f"{arch} adafactor params")
        _state_close(gather_tree(sst, "cpu"), st, f"{arch} {name} state")
        _check_blocks(sp, pspecs, mesh)
        _check_blocks(sst, ospecs, mesh)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (16, 16), (2, 16, 16)])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_sharded_optimizer_matches_update(name, mesh_shape):
    """``update_sharded`` on sharded gradients against ``update`` on the
    same whole gradients: two updates, parameters and every state tensor
    (seeded gradients of global norm 4, so the clip acts)."""
    jcfg, cfg = pair("qwen1.5-0.5b", num_blocks=2)
    params = to_torch(numpy_params(jcfg, 1))
    mesh = (make_serve_mesh(*mesh_shape, devices="cpu") if len(mesh_shape) == 2
            and mesh_shape != (16, 16) else make_production_mesh(len(mesh_shape) == 3, "cpu"))
    opt = (adamw if name == "adamw" else adafactor)(1e-2, weight_decay=0.1)
    gen = torch.Generator().manual_seed(0)
    pspecs, ospecs = train_specs(cfg, opt, mesh)
    p, st = params, opt.init(params)
    sp, sst = init_sharded(cfg, opt, params, mesh)
    for step in range(2):
        g = tree_map(lambda t: torch.randn(t.shape, generator=gen), params)
        norm = float(torch.sqrt(sum((x.double() ** 2).sum() for x in ref_leaves(g))))
        g = tree_map(lambda x: x * (4.0 / norm), g)
        u, st = opt.update(g, st, p, step)
        p = tree_map(lambda a, b: (a.float() + b).to(a.dtype), p, u)
        sp, sst = opt.update_sharded(shard_tree(stack_blocks(g), pspecs, mesh), sst, sp, step)
    got_p = [t.double().numpy() for t in ref_leaves(stack_blocks(gather_params(sp, "cpu")))]
    want_p = [t.double().numpy() for t in ref_leaves(stack_blocks(p))]
    old = [t.double().numpy() for t in ref_leaves(stack_blocks(params))]
    if name == "adamw":
        assert_steps_close(got_p, want_p, old, TOL, "adamw params")
    else:
        _adafactor_params_close(got_p, want_p, old, ref_leaves(st.m), 1e-2, "adafactor params")
    _state_close(gather_tree(sst, "cpu"), st, f"{name} state")
    _check_blocks(sst, ospecs, mesh)


REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, smoke_config
from repro.distributed.rules import act_rules, param_rules
from repro.distributed.sharding import sharding_context
from repro.models import model as M
from repro.optim import Optimizer, adafactor, adamw
from repro.train.step import TrainStepCfg, make_train_step
import dataclasses
a = dict(np.load(sys.argv[1]))
out = {}
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                               is_leaf=lambda x: isinstance(x, P))
sgd = Optimizer(init=lambda p: (), state_like=lambda p: (), state_specs=lambda ps, ab: (),
                update=lambda g, s, p, step: (jax.tree.map(lambda x: -0.5 * x, g), s))
for arch in ARCHS_RUN:
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32")
    params0 = M.init_params(cfg, jax.random.PRNGKey(0))
    for i, leaf in enumerate(jax.tree.leaves(params0)):
        out[f"{arch}/param/{i}"] = np.asarray(leaf)
    pspecs = M.param_specs(cfg, param_rules(False), {"data": 2, "model": 2})
    abstract = M.abstract_params(cfg)
    batch = {k[len(arch) + 1:]: jnp.asarray(v) for k, v in a.items() if k.startswith(arch + "/")}
    bspec = {k: P("data", *([None] * (v.ndim - 1))) for k, v in batch.items()}
    for name, opt in (("sgd", sgd), ("adamw", adamw(1e-4, weight_decay=0.1)),
                      ("adafactor", adafactor(1e-4))):
        ospecs = opt.state_specs(pspecs, abstract)
        tstep = make_train_step(cfg, opt, TrainStepCfg(microbatches=1))
        with sharding_context(mesh, act_rules(False)):
            params = jax.device_put(params0, named(pspecs))
            state = jax.jit(opt.init, out_shardings=named(ospecs))(params)
            fn = jax.jit(tstep, in_shardings=(named(pspecs), named(ospecs), None,
                                              named(bspec)),
                         out_shardings=(named(pspecs), named(ospecs), None))
            params, state, m = fn(params, state, jnp.asarray(0, jnp.int32),
                                  jax.device_put(batch, named(bspec)))
        out[f"{arch}/{name}/loss"] = np.asarray(m["loss"])
        for i, leaf in enumerate(jax.tree.leaves(params)):
            out[f"{arch}/{name}/p/{i}"] = np.asarray(leaf)
            if name == "sgd":
                for sh in leaf.addressable_shards:
                    pos = tuple(int(c) for c in np.argwhere(mesh.devices == sh.device)[0])
                    out[f"{arch}/{name}/shard/{i}/{pos}"] = np.asarray(sh.data)
        for i, leaf in enumerate(jax.tree.leaves(state)):  # bf16 exactly as float32
            out[f"{arch}/{name}/s/{i}"] = np.asarray(leaf.astype(jnp.float32))
np.savez(sys.argv[2], **out)
print("REFERENCE-OK")
"""
PJIT_ARCHS = ["qwen1.5-0.5b", "deepseek-v2-lite-16b"]


@pytest.fixture(scope="module")
def pjit_reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh")
    batches = {}
    for arch in PJIT_ARCHS:
        cfg = pair(arch)[1]
        batches.update({f"{arch}/{k}": v for k, v in batch_np(cfg, 7, B=4, S=16).items()})
    np.savez(d / "in.npz", **batches)
    code = (REFERENCE.replace("ARCHS_RUN", repr(PJIT_ARCHS))
            .replace("sys.argv[1]", repr(str(d / "in.npz")))
            .replace("sys.argv[2]", repr(str(d / "out.npz"))))
    assert "REFERENCE-OK" in run_with_devices(code, 4, timeout=600)
    return batches, dict(np.load(os.path.join(d, "out.npz")))


@pytest.mark.parametrize("arch", PJIT_ARCHS)
def test_mesh_step_matches_the_reference_pjit_step(arch, pjit_reference):
    from repro_torch.params import from_jax

    batches, ref = pjit_reference
    cfg = pair(arch)[1]
    shapes = JM.abstract_params(pair(arch)[0])
    leaves, treedef = jax.tree.flatten(shapes)
    jparams = jax.tree.unflatten(treedef, [ref[f"{arch}/param/{i}"] for i in range(len(leaves))])
    params = from_jax(jparams, device="cpu")
    batch = {k[len(arch) + 1:]: torch.from_numpy(v) for k, v in batches.items()
             if k.startswith(arch + "/")}
    mesh = make_serve_mesh(2, 2, devices="cpu")
    old = [t.double().numpy() for t in ref_leaves(stack_blocks(params))]
    n = len(old)
    for name, opt in (("sgd", sgd_probe(0.5)), ("adamw", adamw(1e-4, weight_decay=0.1)),
                      ("adafactor", adafactor(1e-4))):
        sp, sst = init_sharded(cfg, opt, params, mesh)
        sp, sst, m = make_mesh_train_step(cfg, opt, TrainStepCfg(), mesh)(sp, sst, 0, batch)
        want_loss = float(ref[f"{arch}/{name}/loss"])
        assert abs(float(m["loss"]) - want_loss) <= TOL * abs(want_loss), name
        if name == "sgd":
            got = [t.double().numpy() for t in ref_leaves(gather_tree(sp, "cpu"))]
            want = [ref[f"{arch}/sgd/p/{i}"].astype(np.float64) for i in range(n)]
            assert_steps_close(got, want, old, TOL, f"{arch} pjit sgd")
            # each grid position's block is the reference's shard on the
            # device at that position
            for i, a in enumerate(ref_leaves(sp)):
                for pos in np.ndindex(2, 2):
                    idx = position_index(a.spec, len(a.shape), mesh, pos)
                    sl = tuple(slice(j * b, (j + 1) * b) for j, b in zip(idx, a.block_shape))
                    shard = ref[f"{arch}/sgd/shard/{i}/{pos}"]
                    assert shard.shape == a.block_shape, (i, pos)
                    np.testing.assert_array_equal(shard, ref[f"{arch}/sgd/p/{i}"][sl])
                    np.testing.assert_allclose(a.at(pos).double().numpy(), got[i][sl], rtol=0,
                                               atol=0)
            continue
        got_state = ref_leaves(gather_tree(sst, "cpu"))
        assert len(got_state) == len([k for k in ref if k.startswith(f"{arch}/{name}/s/")])
        for i, g in enumerate(got_state):  # Adafactor's bf16 m within one bf16 step
            w = ref[f"{arch}/{name}/s/{i}"].astype(np.float64)
            rel = BF16_STEP if g.dtype == torch.bfloat16 else TOL
            np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                       atol=rel * max(1e-12, np.abs(w).max()),
                                       err_msg=f"{arch} {name} state leaf {i}")


def test_launcher_mesh_runs_end_at_the_unsharded_loss(tmp_path):
    from repro_torch.launch.train import main

    args = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "16", "--seq", "32"]
    plain = main(args + ["--mesh", "none"])
    for mesh in ("single", "multi"):
        got = main(args + ["--mesh", mesh])
        assert abs(got - plain) <= TOL * abs(plain), mesh
    # a checkpoint crosses mesh -> unsharded and unsharded -> mesh
    four = main(args[:-4] + ["--steps", "4", "--batch", "16", "--seq", "32", "--mesh", "none"])
    for first, second in (("single", "none"), ("none", "single")):
        d = str(tmp_path / f"{first}-{second}")
        main(args + ["--mesh", first, "--ckpt-dir", d])
        resumed = main(args[:-4] + ["--steps", "4", "--batch", "16", "--seq", "32",
                                    "--mesh", second, "--ckpt-dir", d])
        assert abs(resumed - four) <= TOL * abs(four), (first, second)


def test_production_mesh_shapes_and_refusals():
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data", "model"))):
        m = make_production_mesh(multi, "cpu")
        assert m.devices.shape == shape and m.axis_names == axes
        assert {d.type for d in m.devices.reshape(-1)} == {"cpu"}
        with pytest.raises(ValueError, match=rf"needs {np.prod(shape)} devices, have 3 "):
            make_production_mesh(multi, ["cpu"] * 3)
        grid = make_production_mesh(multi, ["cpu"] * int(np.prod(shape)))
        assert grid == m
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match=r"mesh \(16,16\) needs 256 devices, have 0 "):
            make_production_mesh(False)


def test_constrain_and_the_sharding_context():
    from repro.distributed import sharding as jsh
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.rules import act_rules

    x = torch.zeros(4, 6, 8)
    assert sh.constrain(x, "a") is x and sh.active_mesh() is None
    mesh = make_serve_mesh(2, 2, devices="cpu")
    stand_in = _stand_in({"data": 2, "model": 2})
    with sh.sharding_context(mesh, act_rules(False)):
        assert sh.active_mesh() is mesh
        assert sh.constrain(x, "act_batch", None, "act_mlp") is x
        for axes in (("act_batch", None, "act_mlp"), ("act_batch", "act_heads", None),
                     (None, "act_vocab", "act_kv")):
            got = sh.constrained_spec(x, *axes)
            want = jsh.fit_spec_to_shape(jsh.resolve(jrules.act_rules(False), axes), x.shape,
                                         stand_in)
            assert tuple(got) == tuple(want), axes
        with pytest.raises(ValueError, match=r"rank 3 vs axes \('act_batch',\)"):
            sh.constrain(x, "act_batch")
    assert sh.active_mesh() is None


def test_mesh_step_runs_a_batch_its_data_axis_does_not_split():
    """A batch of 2 rows on 16 data shards: one replica computes it (no
    average of copies), equal to the unsharded step."""
    cfg, params, batches = _config("qwen1.5-0.5b")
    batch = {k: v[:2] for k, v in batches[0].items()}
    sgd = sgd_probe(0.5)
    mesh = make_production_mesh(False, "cpu")
    want, _, m_want = make_train_step(cfg, sgd, TrainStepCfg())(params, (), 0, batch)
    sp, _ = init_sharded(cfg, sgd, params, mesh)
    got, _, m_got = make_mesh_train_step(cfg, sgd, TrainStepCfg(), mesh)(sp, (), 0, batch)
    assert float(m_got["loss"]) == float(m_want["loss"])
    for g, w in zip(ref_leaves(gather_tree(got, "cpu")), ref_leaves(stack_blocks(want))):
        assert torch.equal(g, w)


def test_model_param_tree_is_the_reference_layout_on_meta():
    cfg = tc.smoke_config(tc.ARCHS["jamba-1.5-large-398b"])
    flat, stacked = M.abstract_params(cfg), M.abstract_params(cfg, stacked=True)
    assert all(t.device.type == "meta" for t in ref_leaves(flat) + ref_leaves(stacked))
    assert [tuple(t.shape) for t in ref_leaves(stacked)] == \
        [tuple(t.shape) for t in ref_leaves(stack_blocks(flat))]
    specs = M.param_specs(cfg, param_rules(False), {"data": 2, "model": 2}, stacked=True)
    assert all(isinstance(s, P) for s in ref_leaves(specs))
