"""The port's input specs and dry-run (``repro_torch.launch.input_specs``,
``repro_torch.launch.dryrun``, ``distributed.cache_specs``'s contiguous
half, ``data.pipeline.make_batch_specs``) against the JAX package's, shapes
only: nothing is allocated on either side (the port's stand-ins live on the
``meta`` device; the reference's are ``ShapeDtypeStruct``s, its mesh a
stand-in with ``axis_names`` and ``devices.shape``).

* ``train_inputs``, ``prefill_inputs`` and ``decode_inputs`` for all eleven
  configurations at their published widths on every shape (long_500k in T3
  for a full-attention stack, as the reference's dry-run runs it) and both
  production meshes: the same inputs, dtypes and specs; the caches' shapes,
  dtypes and fitted specs per layer (the reference stacks each block
  position's layers: its leaves carry a leading layer axis, replicated).
* ``cache_pspecs`` mirrors ``init_caches`` in the reference's spec test's
  5 archs x 4 modes, and equals the reference's.
* The dry-run on three cells writes one record each under the directory it
  is given (and refuses the reference's ``experiments/dryrun``); its
  per-device parameter, optimizer-state, batch and cache bytes are the ones
  the reference's specs imply.
"""
import json
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
from repro.data.pipeline import make_batch_specs as j_batch_specs
from repro.distributed.cache_specs import cache_pspecs as j_cache_pspecs
from repro.distributed.rules import param_rules as j_param_rules
from repro.distributed.sharding import fit_spec_to_shape as j_fit
from repro.launch import input_specs as jis
from repro.models import model as JM
import repro_torch.configs as tc
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.distributed.cache_specs import cache_pspecs
from repro_torch.launch import dryrun, input_specs as tis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.params import ref_leaves

from torch_train_cases import SMOKE_ARCHS

MESHES = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


def _stand_in(shape: dict):
    return SimpleNamespace(axis_names=tuple(shape), devices=np.empty(tuple(shape.values())))


def _jleaves(tree) -> list:
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))


def _dt(t) -> str:
    return str(t.dtype).split(".")[-1]


def _compare_caches(caches, cspecs, jcaches, jcspecs, what: str) -> None:
    """Port caches (one a layer) against the reference's (block positions
    stacked): shapes, dtypes and fitted specs, the reference's leading
    layer axis dropped."""
    assert len(caches["prefix"]) == len(jcaches["prefix"])
    pairs = [(ref_leaves(caches["prefix"]), ref_leaves(cspecs["prefix"]),
              jax.tree.leaves(jcaches["prefix"]), _jleaves(jcspecs["prefix"]), 0)]
    for j, layers in enumerate(caches["blocks"]):
        for i, layer in enumerate(layers):
            pairs.append((ref_leaves(layer), ref_leaves(cspecs["blocks"][j][i]),
                          jax.tree.leaves(jcaches["blocks"][j]),
                          _jleaves(jcspecs["blocks"][j]), 1))
    for mine, mspecs, ref, rspecs, lead in pairs:
        assert len(mine) == len(ref) == len(mspecs) == len(rspecs), what
        for t, s, r, rs in zip(mine, mspecs, ref, rspecs):
            assert tuple(t.shape) == tuple(r.shape[lead:]), what
            assert _dt(t) == str(r.dtype), what
            assert tuple(s) == tuple(rs)[lead:], (what, s, rs)


def _cells():
    out = []
    for arch in SMOKE_ARCHS:
        for multi in (False, True):
            out.append((arch, multi))
    return out


@pytest.mark.parametrize("arch,multi", _cells())
def test_input_specs_match_the_reference(arch, multi):
    mesh = make_production_mesh(multi, "meta")
    jmesh = _stand_in(MESHES[multi])
    for name, shape in tc.SHAPES.items():
        cfg, jcfg = tc.get_config(arch), JARCHS[arch]
        if name == "long_500k" and not cfg.sub_quadratic:
            cfg, jcfg = cfg.with_attention("retrieval"), jcfg.with_attention("retrieval")
        jshape = JSHAPES[name]
        if shape.kind == "train":
            batch, specs = tis.train_inputs(cfg, shape, mesh)
            jbatch, jspecs = jis.train_inputs(jcfg, jshape, jmesh)
            assert sorted(batch) == sorted(jbatch)
            for k in batch:
                assert tuple(batch[k].shape) == jbatch[k].shape and batch[k].is_meta
                assert _dt(batch[k]) == str(jbatch[k].dtype)
                assert tuple(specs[k]) == tuple(jspecs[k]), (name, k)
        elif shape.kind == "prefill":
            batch, specs, caches, cspecs = tis.prefill_inputs(cfg, cfg.attention, shape, mesh)
            jb, js, jc, jcs = jis.prefill_inputs(jcfg, jcfg.attention, jshape, jmesh)
            assert sorted(batch) == sorted(jb)
            for k in batch:
                assert tuple(batch[k].shape) == jb[k].shape and tuple(specs[k]) == tuple(js[k])
            _compare_caches(caches, cspecs, jc, jcs, f"{arch} {name}")
        else:
            tokens, tspec, pos, caches, cspecs = tis.decode_inputs(cfg, cfg.attention, shape,
                                                                   mesh)
            jt, jts, jpos, jc, jcs = jis.decode_inputs(jcfg, jcfg.attention, jshape, jmesh)
            assert tuple(tokens.shape) == jt.shape and tuple(tspec) == tuple(jts)
            assert tuple(pos.shape) == jpos.shape == ()
            _compare_caches(caches, cspecs, jc, jcs, f"{arch} {name}")


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b",
                                  "xlstm-125m", "llama-3.2-vision-11b"])
def test_cache_pspecs_mirror_init_caches_and_match_the_reference(arch):
    from functools import partial

    for mode in ("dense", "decomposed", "cpq", "retrieval"):
        cfg, jcfg = tc.get_config(arch).with_attention(mode), JARCHS[arch].with_attention(mode)
        caches = M.init_caches(cfg, cfg.attention, 4, 64, "meta")
        specs = cache_pspecs(cfg, cfg.attention, "data", None)
        assert len(ref_leaves(caches)) == len(ref_leaves(specs)), (arch, mode)
        jcaches = jax.eval_shape(partial(JM.init_caches, jcfg, jcfg.attention, 4, 64))
        jspecs = j_cache_pspecs(jcfg, jcfg.attention, "data", None)
        _compare_caches(caches, specs, jcaches, jspecs, f"{arch} {mode}")
        # and with the batch over two axes and the arena over data
        _compare_caches(caches, cache_pspecs(cfg, cfg.attention, ("pod", "data"), "model"),
                        jcaches, j_cache_pspecs(jcfg, jcfg.attention, ("pod", "data"), "model"),
                        f"{arch} {mode} pod")


def test_make_batch_specs_matches_the_reference():
    cfg = tc.get_config("llama-3.2-vision-11b")
    batch = {"tokens": np.zeros((8, 16), np.int32), "labels": np.zeros((8, 16), np.int32),
             "patches": np.zeros((8, 4, 32), np.float32)}
    for axes in ((), ("data",), ("pod", "data")):
        got = make_batch_specs(cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, axes)
        want = j_batch_specs(JARCHS[cfg.name], batch, axes)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


def _reference_dryrun_rules():
    """The reference dry-run's ``pick_optimizer`` and ``suggest_microbatches``.
    Its module sets XLA_FLAGS (512 host devices) when imported; the flag is
    put back at once, before any JAX backend could read it, so the other
    tests of this process keep their one CPU device."""
    import os

    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import pick_optimizer, suggest_microbatches
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return pick_optimizer, suggest_microbatches


def _ref_bytes(specs, abstract, mesh) -> int:
    """Per-device bytes the reference's specs imply for its abstract tree."""
    total = 0
    for s, a in zip(_jleaves(specs), jax.tree.leaves(abstract)):
        s = j_fit(s, a.shape, mesh)
        parts = 1
        for entry in s:
            for ax in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                parts *= dict(zip(mesh.axis_names, mesh.devices.shape))[ax]
        total += math.prod(a.shape) // parts * np.dtype(a.dtype).itemsize
    return total


DRY_CELLS = [("qwen1.5-0.5b", "train_4k", False, None),
             ("deepseek-v2-lite-16b", "decode_32k", False, None),
             ("deepseek-v2-lite-16b", "decode_32k", True, None),
             ("xlstm-125m", "long_500k", False, None),
             ("xlstm-125m", "long_500k", True, None)]


@pytest.mark.parametrize("arch,shape,multi,mode", DRY_CELLS)
def test_dryrun_cell_records_the_reference_spec_bytes(arch, shape, multi, mode, tmp_path):
    rec = dryrun.run_cell(arch, shape, multi, mode, out_dir=tmp_path)
    tag = f"{arch}__{shape}__{'pod2' if multi else 'pod1'}__dense"
    assert json.loads((tmp_path / f"{tag}.json").read_text()) == rec
    assert rec["skipped"] is False and rec["flops_per_device"] > 0
    jcfg, jshape, jmesh = JARCHS[arch], JSHAPES[shape], _stand_in(MESHES[multi])
    pspecs = JM.param_specs(jcfg, j_param_rules(multi),
                            dict(zip(jmesh.axis_names, jmesh.devices.shape)))
    abstract = JM.abstract_params(jcfg)
    assert rec["param_bytes_per_device"] == _ref_bytes(pspecs, abstract, jmesh)
    if jshape.kind == "train":
        j_pick, j_micro = _reference_dryrun_rules()
        name, jopt = j_pick(jcfg)
        assert rec["optimizer"] == name and rec["microbatches"] == j_micro(jcfg, jshape, jmesh)
        state = jopt.state_like(abstract)
        assert rec["state_bytes_per_device"] == _ref_bytes(
            jopt.state_specs(pspecs, abstract), state, jmesh)
        batch, bspecs = jis.train_inputs(jcfg, jshape, jmesh)
        assert rec["batch_bytes_per_device"] == _ref_bytes(bspecs, batch, jmesh)
        # the step's peak besides the blocks: the whole model gathered, the
        # whole gradient, float32 sums of at most a device's blocks
        whole = _ref_bytes(jax.tree.map(lambda _: JP(), pspecs,
                                        is_leaf=lambda x: isinstance(x, JP)), abstract, jmesh)
        assert rec["gather_bytes_per_replica"] == rec["grad_bytes_per_replica"] == whole
        f32 = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, np.float32), abstract)
        assert rec["grad_sum_bytes_per_device"] == _ref_bytes(pspecs, f32, jmesh)
    else:
        tokens, tspec, _, caches, cspecs = jis.decode_inputs(jcfg, jcfg.attention, jshape,
                                                             jmesh)
        assert rec["batch_bytes_per_device"] == _ref_bytes({"t": tspec}, {"t": tokens}, jmesh)
        assert rec["cache_bytes_per_device"] == _ref_bytes(cspecs, caches, jmesh)
    with pytest.raises(ValueError, match="reference"):
        dryrun.run_cell(arch, shape, multi, mode, out_dir=dryrun.REFERENCE_DIR)


def test_dryrun_lists_a_failing_cell(tmp_path, monkeypatch):
    """A cell that cannot be traced fails the run and is listed, none is
    skipped quietly."""
    def boom(*a, **k):
        raise RuntimeError("cannot trace")

    monkeypatch.setattr(dryrun, "trace_cell", boom)
    with pytest.raises(SystemExit, match=r"1 dryrun failures: \[\('xlstm-125m', 'decode_32k'"):
        dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert dryrun.cells(True, None, None, None)[3] == ("deepseek-v2-lite-16b", "long_500k",
                                                       "retrieval")
    assert len(dryrun.cells(True, None, None, None)) == 40
