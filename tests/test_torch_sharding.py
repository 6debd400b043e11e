"""The port's mesh and partition specs (``repro_torch.distributed`` and
``repro_torch.launch.mesh``) against the JAX package's: ``resolve``,
``fit_spec_to_shape``, ``batch_axes`` and the four rule sets on the same
inputs; the paged arenas' spec trees, which mirror ``init_paged_caches``
and equal the reference's per layer, in the eight (arch, mode, tiered)
cases of the reference's own spec test; the mesh constructors' errors; and
``validate_serve_mesh``'s refusals, with the reference's messages. Specs
are compared as tuples. No multi-device JAX run: the reference's functions
here read only a mesh's axis names and shape."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch as T
from repro import configs as jconfigs
from repro.distributed import rules as jrules
from repro.distributed import sharding as jsharding
from repro.launch import mesh as jmesh
from repro_torch.distributed import rules, sharding
from repro_torch.distributed.cache_specs import paged_cache_pspecs, paged_layer_cache_specs
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import make_serve_mesh, mesh_shape_dict, parse_mesh_arg
from repro_torch.models import model as M
from repro_torch.params import init_params
from repro_torch.serving import paged_cache as pgc
from repro_torch.serving.sharded import validate_serve_mesh

RULE_SETS = [("param_rules", (False,)), ("param_rules", (True,)), ("act_rules", (False,)),
             ("act_rules", (True, "data")), ("serve_paged_rules", ()),
             ("serve_paged_rules", ("data",))]


@pytest.mark.parametrize("name,args", RULE_SETS)
def test_rule_sets_and_resolve_match_the_reference(name, args):
    mine, ref = getattr(rules, name)(*args), getattr(jrules, name)(*args)
    assert mine == ref
    rng = np.random.default_rng(len(name) + len(args))
    names = sorted(ref) + [None]
    for _ in range(20):
        axes = tuple(names[i] for i in rng.integers(0, len(names), size=int(rng.integers(1, 5))))
        assert tuple(sharding.resolve(mine, axes)) == tuple(jsharding.resolve(ref, axes)), axes


def test_fit_spec_to_shape_and_batch_axes_match_the_reference():
    rng = np.random.default_rng(0)
    axes = ["data", "model", "pod", ("pod", "data"), ("data", "model"), None]
    for shape in ((1, 2), (2, 4), (4, 2), (2, 2, 2)):
        names = ("pod", "data", "model")[-len(shape):]
        grid = np.empty(shape, dtype=object)
        grid.reshape(-1)[:] = ["cpu"] * grid.size
        mesh = sharding.Mesh(grid, names)
        ref_mesh = SimpleNamespace(axis_names=names, devices=np.empty(shape))
        for _ in range(30):
            rank = int(rng.integers(1, 5))
            spec = tuple(axes[i] for i in rng.integers(0, len(axes), size=int(rng.integers(0,
                                                                                       rank + 1))))
            dims = tuple(int(d) for d in rng.choice([1, 2, 3, 4, 6, 8, 16], size=rank))
            got = sharding.fit_spec_to_shape(P(*spec), dims, mesh)
            want = jsharding.fit_spec_to_shape(jsharding.PartitionSpec(*spec), dims, ref_mesh)
            assert tuple(got) == tuple(want), (spec, dims, shape)
    for multi, n, ms in ((True, 256, {"pod": 2, "data": 16, "model": 16}),
                         (False, 1, {"data": 16, "model": 16}),
                         (True, 2, {"pod": 2, "data": 16, "model": 16}),
                         (False, 12, {"data": 4, "model": 2})):
        assert rules.batch_axes(multi, n, ms) == jrules.batch_axes(multi, n, ms)


SPEC_CASES = [  # the reference's tests/test_serving_sharded.py spec cases
    ("qwen1.5-0.5b", "dense", False),
    ("qwen1.5-0.5b", "decomposed", False),
    ("qwen1.5-0.5b", "cpq", False),
    ("qwen1.5-0.5b", "retrieval", False),
    ("qwen1.5-0.5b", "decomposed_cpq", False),
    ("qwen1.5-0.5b", "dense", True),
    ("deepseek-v2-lite-16b", "decomposed", False),
    ("jamba-1.5-large-398b", "dense", False),
]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    out = []
    pgc.tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("arch,mode,tiered", SPEC_CASES)
def test_paged_spec_trees_mirror_the_arenas_and_equal_the_reference(arch, mode, tiered):
    import jax
    from jax.sharding import PartitionSpec as JP

    from repro.distributed.cache_specs import paged_cache_pspecs as jspecs

    jcfg = jconfigs.smoke_config(jconfigs.get_config(arch)).with_attention(mode)
    cfg = T.smoke_config(T.get_config(arch)).with_attention(mode)
    kw = dict(num_slots=2, page_size=4, num_pages=9, max_blocks_per_slot=4)
    specs = paged_cache_pspecs(cfg, cfg.attention, T.ServingCfg(**kw), tiered)
    arenas = M.init_paged_caches(cfg, cfg.attention, T.ServingCfg(**kw), "meta", tiered)
    # the same tree: one spec a tensor, each of the tensor's rank or less
    for layer_spec, arena in zip(M.per_layer(cfg, specs), M.per_layer(cfg, arenas)):
        pairs = []
        pgc.tree_map(lambda s, a: pairs.append((s, a)), layer_spec, arena)
        assert pairs and all(isinstance(s, P) and len(s) <= a.ndim for s, a in pairs)
    # per layer, the reference's spec (its stacked blocks lose their layer axis)
    ref = jspecs(jcfg, jcfg.attention, jconfigs.ServingCfg(**kw), tiered)
    is_spec = lambda x: isinstance(x, JP)  # noqa: E731
    want = [tuple(s) for s in jax.tree.leaves(ref["prefix"], is_leaf=is_spec)]
    for stacked in ref["blocks"]:
        one = [tuple(s)[1:] for s in jax.tree.leaves(stacked, is_leaf=is_spec)]
        want += one  # the blocks of one pattern position share their specs
    got = [tuple(s) for s in _leaves(specs["prefix"])]
    for position in specs["blocks"]:
        got += [tuple(s) for s in _leaves(position[0])]
        assert all(_leaves(b) == _leaves(position[0]) for b in position)
    assert got == want


def test_serve_paged_rules_split_the_head_and_latent_axes():
    cfg = T.smoke_config(T.ARCHS["qwen1.5-0.5b"])
    serving = T.ServingCfg(num_slots=2, page_size=4, num_pages=9, max_blocks_per_slot=4)
    dense = paged_layer_cache_specs(cfg, cfg.attention, ("attn", "dense"), serving)
    assert dense.k == P(None, None, "model", None)
    x = paged_layer_cache_specs(cfg, cfg.with_attention("decomposed").attention,
                                ("attn", "dense"), serving)
    assert x.x == P(None, None, "model") and x.k_rope == P(None, None, "model", None)
    jamba = T.smoke_config(T.get_config("jamba-1.5-large-398b"))
    mamba = paged_layer_cache_specs(jamba, cfg.attention, ("mamba", "dense"), serving)
    assert all(sp == P() for sp in _leaves(mamba))


def test_mesh_constructors_raise_the_references_errors():
    for dp, mp in ((1, 2), (2, 2)):
        with pytest.raises(ValueError) as mine:
            make_serve_mesh(dp, mp, devices=["cpu"])
        with pytest.raises(ValueError) as ref:
            jmesh.make_serve_mesh(dp, mp)
        head = f"mesh ({dp},{mp}) needs {dp * mp} devices, have 1 "
        assert str(mine.value).startswith(head) and str(ref.value).startswith(head)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match=r"mesh \(1,2\) needs 2 devices, have 0 "):
            make_serve_mesh(1, 2)
    for arg in ("1x2", "2", "a,b", "1,2,3"):
        with pytest.raises(ValueError) as mine:
            parse_mesh_arg(arg, devices="cpu")
        with pytest.raises(ValueError) as ref:
            jmesh.parse_mesh_arg(arg)
        assert str(mine.value) == str(ref.value)
    mesh = parse_mesh_arg("1,4", devices="cpu")
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 4}
    assert mesh_shape_dict(mesh) == {"data": 1, "model": 4}
    assert [str(d) for d in mesh.axis_devices("model")] == ["cpu"] * 4
    assert mesh == make_serve_mesh(1, 4, devices=["cpu"] * 4) and mesh != make_serve_mesh(
        1, 2, devices="cpu")


@pytest.mark.parametrize("arch,mode,mp", [
    ("qwen1.5-0.5b", "dense", 8),           # 4 query heads: num_heads refuses
    ("qwen1.5-0.5b", "decomposed", 8),
    ("qwen1.5-0.5b", "decomposed_cpq", 8),
    ("deepseek-v2-lite-16b", "decomposed", 8),
    ("qwen1.5-0.5b", "dense", 2),           # accepted: 2 model shards
])
def test_validate_serve_mesh_matches_the_reference(arch, mode, mp):
    from repro.serving import sharded as jsharded
    from repro.serving.scheduler import SchedulerConfigError as JError

    cfg = T.smoke_config(T.get_config(arch)).with_attention(mode)
    jcfg = jconfigs.smoke_config(jconfigs.get_config(arch)).with_attention(mode)
    mesh = make_serve_mesh(1, mp, devices="cpu")
    stand_in = SimpleNamespace(axis_names=("data", "model"), shape={"data": 1, "model": mp})
    rt = dataclasses.replace(cfg.attention, mesh=mesh)
    jrt = dataclasses.replace(jcfg.attention, mesh=stand_in)
    try:
        want = jsharded.validate_serve_mesh(jcfg, jrt)
    except JError as e:
        with pytest.raises(T.SchedulerConfigError) as mine:
            validate_serve_mesh(cfg, rt)
        assert str(mine.value) == str(e)
        with pytest.raises(T.SchedulerConfigError, match=str(e)):
            T.ContinuousServeEngine(cfg, init_params(cfg, 0, device="cpu"), mesh=mesh)
        return
    assert validate_serve_mesh(cfg, rt) == want == mp


@pytest.mark.parametrize("mp", [2, 4])
def test_a_shard_plans_its_launches_as_the_whole_call(monkeypatch, mp):
    """Given its ``single_query.Whole`` a model shard's launch is planned as
    the unsharded call over every head would be (B1's cluster ranks, the
    tensor-core chunks' key splits of B2/B6 and B4, B3's splits), so each
    head's keys split alike and its arithmetic is the unsharded call's."""
    from repro_torch.kernels import single_query
    from repro_torch.kernels.decomposed_attn import ops as t1_ops
    from repro_torch.kernels.paged_attn import ops

    monkeypatch.setattr(single_query, "_sm_count", lambda device: 132)
    dev = torch.device("cpu")
    for B, KV, G, cap in ((8, 16, 1, 1024), (8, 8, 4, 1024), (2, 16, 1, 4096), (1, 8, 1, 300)):
        whole = ops.decode_plan(B, KV, G, cap, dev)
        assert ops.decode_plan(B, KV // mp, G, cap, dev, single_query.Whole(mp)) == whole
        whole = ops.chunk_plan(16, G, KV, cap, 64, dev)[:2]
        assert ops.chunk_plan(16, G, KV // mp, cap, 64, dev,
                              single_query.Whole(mp))[:2] == whole
    for B, H, kv_r, cap in ((8, 16, 16, 1024), (8, 16, 1, 1024), (1, 16, 16, 333),
                            (1, 16, 16, 40), (1, 16, 1, 4000)):
        decode = t1_ops.t1_decode_plan(B, H, 1024, cap, dev, "capacity")
        chunk = t1_ops.t1_chunk_plan(16, H, kv_r, cap, dev)
        split_rope = mp if kv_r > 1 else 1  # MLA's one roped key is held whole
        for shard in range(mp):  # B3 places each shard's roped columns apart
            part = single_query.Whole(mp, split_rope, shard)
            assert t1_ops.t1_decode_plan(B, H // mp, 1024, cap, dev, "capacity",
                                         part) == decode
            assert t1_ops.t1_chunk_plan(16, H // mp, kv_r // split_rope, cap, dev,
                                        part) == chunk
    assert single_query.WHOLE == single_query.Whole(1, 1, 0)
