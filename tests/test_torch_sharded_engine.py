"""Mesh-native paged serving of the port (``serving/sharded.py``): the
continuous engine over ``make_serve_mesh(1, mp)`` (its shards all on the
CPU) against the port unsharded and the JAX engine unsharded, at float32:
results, output events and every counter identical, with the paged kernels
(their plain versions here) and with the gather path, in every mode (dense,
cpq, decomposed, retrieval, decomposed_cpq, tiered), for MLA (the smoke
deepseek-v2-lite at 2 blocks, one-shot: its MoE layers), and with prefix
sharing (copy-on-write, defrag), speculation and preemption.

The mesh statistics (``model_shards``, ``arena_bytes_total``,
``arena_bytes_per_device``, ``interconnect_bytes``, ``escalations``) are held
to the JAX engine's SHARDED run: one subprocess with 8 emulated host devices
serves dense, cpq, decomposed and tiered under ``make_serve_mesh(1, 2)`` and
``jax.set_mesh`` (the gather path; its own ``[mla]`` case cannot run here,
see ROADMAP) and prints them. MLA's interconnect is held to the reference's
formula, worked below."""
import dataclasses
import json

import numpy as np
import pytest

from repro_torch.launch.mesh import make_serve_mesh

from conftest import run_with_devices
from torch_paged_cases import assert_same, packages, share_compiled, smoke_pair

MESH_KEYS = ("model_shards", "arena_bytes_per_device", "interconnect_bytes",
             "interconnect_bytes_per_token")
TIERED = dict(num_slots=3, page_size=4, num_pages=13, escalated_pages=33,
              max_blocks_per_slot=8, prefill_bucket=4, prefill_chunk=16, low_watermark=0.5,
              critical_watermark=0.25, enable_escalation=True)
BASE = dict(num_slots=2, page_size=4, num_pages=33, max_blocks_per_slot=8, prefill_bucket=4,
            prefill_chunk=4)
SPEC = dict(num_slots=3, page_size=4, num_pages=65, max_blocks_per_slot=12, prefill_bucket=4,
            prefill_chunk=4)


@pytest.fixture(scope="module")
def qwen():
    return smoke_pair()


@pytest.fixture(scope="module")
def mla():
    return smoke_pair("deepseek-v2-lite-16b")


def prompts(sizes, seed=0, lo=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, 256, size=s).astype(np.int32) for s in sizes]


def greedy(ps, max_new):
    def requests(ns):
        return [ns.Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(ps)]
    return requests


def runtime(ns, rt: dict):
    """``ns``'s AttentionRuntime from keyword arguments; a ``retrieval``
    dict becomes the package's own RetrievalCfg."""
    if "retrieval" in rt:
        cls = type(ns.AttentionRuntime(mode="retrieval").retrieval)
        rt = dict(rt, retrieval=cls(**rt["retrieval"]))
    return ns.AttentionRuntime(**rt)


def serve(ns, model, requests, serving, gen, rt, mesh=None, drive=None):
    """One engine of ``ns``'s package: (results, stats, output events)."""
    cfg, tcfg, params, tparams = model
    jax_side = not ns.device
    kw = dict(**ns.device, **({} if mesh is None else {"mesh": mesh}))
    eng = ns.Engine(cfg if jax_side else tcfg, params if jax_side else tparams,
                    rt=runtime(ns, rt), serving=ns.ServingCfg(**serving), **kw)
    if jax_side:
        share_compiled(eng)
    g = ns.GenerationConfig(**gen)
    if drive is None:
        res, stats = eng.serve(requests(ns), g)
    else:
        eng.reset(g)
        res, stats = drive(eng, ns), eng.stats()
    return res, stats, [dataclasses.astuple(e) for e in eng.pending_outputs()]


def mesh_parity(model, requests, serving, *, gen, rt=None, mps=(2,), drive=None):
    """The port over each ``make_serve_mesh(1, mp)`` against the port
    unsharded, and the port unsharded against the JAX engine: results,
    events and stats identical (the mesh's own statistics apart). Returns
    {mp: stats}, the unsharded run's at mp 1."""
    J, Pt = packages()
    rt = rt or {}
    jres, jst, jev = serve(J, model, requests, serving, gen, rt, drive=drive)
    tres, tst, tev = serve(Pt, model, requests, serving, gen, rt, drive=drive)
    assert_same(jres, tres, "results")
    assert_same(jst, tst, "stats")
    assert jev == tev
    out = {1: tst}
    for mp in mps:
        mesh = make_serve_mesh(1, mp, devices="cpu")
        mres, mst, mev = serve(Pt, model, requests, serving, gen, rt, mesh, drive)
        assert_same(tres, mres, f"results at mp {mp}")
        assert_same({k: v for k, v in tst.items() if k not in MESH_KEYS},
                    {k: v for k, v in mst.items() if k not in MESH_KEYS}, f"stats at mp {mp}")
        assert mev == tev
        assert mst["model_shards"] == mp and mst["dense_pages_leaked"] == 0
        assert mst["arena_bytes_total"] == tst["arena_bytes_total"]
        out[mp] = mst
    return out


T3 = dict(mode="retrieval", retrieval=dict(top_k=12, recent_window=4))
MODES = [  # id, rt, serving, (prompt sizes, seed), max_new
    ("dense", dict(mode="dense"), BASE, ((5, 9, 3, 7), 0), 6),
    ("cpq", dict(mode="cpq"), BASE, ((5, 9, 3, 7), 0), 6),
    ("decomposed", dict(mode="decomposed"), BASE, ((5, 9, 3, 7), 0), 6),
    # past 12 keys a row really selects (test_torch_engine_retrieval's T3)
    ("retrieval", T3, dict(BASE, max_blocks_per_slot=12), ((14, 22, 9, 17), 0), 8),
    ("decomposed_cpq", dict(mode="decomposed_cpq"), BASE, ((5, 9, 3, 7), 0), 6),
    ("tiered", dict(mode="dense"), TIERED, ((8, 10, 6, 7, 9), 2), 10),
]


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "gather"])
@pytest.mark.parametrize("case", MODES, ids=[m[0] for m in MODES])
def test_modes_serve_over_the_mesh_as_unsharded(qwen, case, fused):
    """Every mode at mp 2 and 4 (the smoke config's 4 query and 4 kv heads
    and d_model 64 divide both)."""
    name, rt, serving, (sizes, seed), max_new = case
    stats = mesh_parity(qwen, greedy(prompts(sizes, seed), max_new),
                        dict(serving, use_paged_kernels=fused),
                        gen=dict(max_new_tokens=max_new), rt=rt, mps=(2, 4))
    for mp in (2, 4):
        st = stats[mp]
        assert st["arena_bytes_per_device"] < st["arena_bytes_total"]
        # the CPQ-X pools replicate and are not charged, as in the reference
        assert (st["interconnect_bytes"] > 0) == (name != "decomposed_cpq")
    if name == "tiered":
        assert stats[1]["escalations"] >= 1


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "gather"])
def test_mla_serves_over_the_mesh_as_unsharded(mla, fused):
    """deepseek-v2-lite's smoke MLA (one-shot admission: MoE) at mp 2: the
    latent split on its feature axis and gathered for B3, the one shared
    roped key held whole in every shard."""
    stats = mesh_parity(mla, greedy(prompts((5, 9, 3, 7)), 6),
                        dict(BASE, use_paged_kernels=fused), gen=dict(max_new_tokens=6))
    st, cfg = stats[2], mla[1]
    # the reference's accounting (engine.py's concat and latent gather),
    # worked here: every layer is MLA with a split latent
    L, H, Dv = cfg.num_layers, cfg.num_heads, cfg.mla.v_head_dim
    concat_bpt = (2 - 1) / 2 * H * Dv * 4 * L
    latent = BASE["num_pages"] * BASE["page_size"] * cfg.mla.kv_lora_rank * 4 * L
    gather_bps = latent * (2 - 1) / 2
    assert st["prefill_chunks"] == 0  # one-shot admission: no chunk, no pack charge
    rows = st["generated_tokens"] - 4    # each request's first token is its admission's
    assert st["interconnect_bytes"] == rows * concat_bpt + st["decode_steps"] * gather_bps
    assert st["arena_bytes_per_device"] < st["arena_bytes_total"]


def _loopy(n=5, motif=3, reps=3, seed=0):
    """test_torch_speculative's prompts: a repeated motif plus two tokens,
    so prompt-lookup drafts are accepted."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = rng.integers(1, 256, size=motif).astype(np.int32)
        out.append(np.concatenate([np.tile(m, reps),
                                   rng.integers(1, 256, size=2).astype(np.int32)]))
    return out


def _cow_drive(pa, pb):
    """A late arrival diverging two tokens into a shared page: it mounts the
    page and splits it on its first tail write (test_torch_prefix's
    schedule)."""
    def drive(eng, ns):
        eng.add_request(ns.Request(rid=0, prompt=pa, max_new_tokens=16))
        for _ in range(12):
            eng.step()
        eng.add_request(ns.Request(rid=1, prompt=pb, max_new_tokens=8))
        while eng.has_unfinished():
            eng.step()
        return eng.results()
    return drive


@pytest.mark.parametrize("mode", ["dense", "decomposed"])
def test_sharing_cow_defrag_and_speculation_over_the_mesh(qwen, mode):
    """Prefix sharing with a copy-on-write split and defrag every two
    retirements, and speculation on a loopy trace: the page copies and pool
    permutations reach every shard."""
    rng = np.random.default_rng(1)
    sys_p = rng.integers(1, 256, size=24).astype(np.int32)
    pa = np.concatenate([sys_p, rng.integers(1, 256, size=8).astype(np.int32)])
    pb = np.concatenate([sys_p[:22], rng.integers(1, 256, size=6).astype(np.int32)])
    st = mesh_parity(qwen, None, dict(SPEC, num_slots=2, share_prefix=True, defrag_every=1),
                     gen=dict(max_new_tokens=16), rt=dict(mode=mode), drive=_cow_drive(pa, pb))
    assert st[2]["cow_copies"] >= 1 and st[2]["defrags"] >= 1
    st = mesh_parity(qwen, greedy(_loopy(), 12), dict(SPEC, spec_len=3),
                     gen=dict(max_new_tokens=12), rt=dict(mode=mode))
    assert st[2]["spec_steps"] > 0 and st[2]["spec_accepted"] > 0


def test_preemption_and_speculation_over_the_mesh(qwen):
    """A tight arena: recompute preemption (pages freed, the stream replayed)
    while rows speculate."""
    st = mesh_parity(qwen, greedy(_loopy(n=4, motif=4, reps=2, seed=7), 12),
                     dict(SPEC, num_pages=14, max_blocks_per_slot=8, spec_len=3),
                     gen=dict(max_new_tokens=12))
    assert st[2]["preemptions"] > 0 and st[2]["spec_steps"] > 0


def _mla_chunked():
    """test_torch_mla's dense-MLP MLA stack (2 blocks, kv_lora_rank 16, one
    roped key of 4), whose admission runs in chunks, in both packages."""
    import jax

    from repro.configs.base import MLACfg as JMLACfg, ModelConfig as JModelConfig
    from repro.models import model as JM
    from repro_torch.configs import MLACfg, ModelConfig
    from repro_torch.params import from_jax

    kw = dict(name="mla-dense-test", family="dense", d_model=32, num_heads=4,
              num_kv_heads=4, head_dim=8, d_ff=64, vocab_size=256,
              block_pattern=(("mla", "dense"),), num_blocks=2, dtype="float32")
    mla_kw = dict(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8)
    cfg = JModelConfig(**kw, mla=JMLACfg(**mla_kw))
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    return (cfg, ModelConfig(**kw, mla=MLACfg(**mla_kw)), params,
            from_jax(jax.tree.map(np.asarray, params), device="cpu"))


@pytest.mark.parametrize("arch", ["qwen", "mla"])
def test_cpq_latents_write_every_copy_over_the_mesh(qwen, arch):
    """T1+T2 and MLA's CPQ latent (chunked admission) at mp 2 keep
    global-semantics compute: each shard writes the new codes into its own
    copy of the pools it holds whole, and the attend runs once on the lead
    device over the pages the rows map. The results are the unsharded
    engine's and the JAX engine's, and after the serve every copy equals
    the lead shard's."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving import paged_cache as pgc

    model = qwen if arch == "qwen" else _mla_chunked()
    rt = dict(mode="decomposed_cpq" if arch == "qwen" else "cpq")
    requests, serving = greedy(prompts((5, 12, 3, 21)), 8), dict(BASE, num_slots=3)
    mesh_parity(model, requests, serving, gen=dict(max_new_tokens=8), rt=rt)
    _, Pt = packages()
    eng = Pt.Engine(model[1], model[3], rt=runtime(Pt, rt), serving=Pt.ServingCfg(**serving),
                    mesh=make_serve_mesh(1, 2, devices="cpu"))
    _, st = eng.serve(requests(Pt), Pt.GenerationConfig(max_new_tokens=8))
    assert st["prefill_chunks"] > 0
    layers = [c for c in M.per_layer(model[1], eng._st.caches)
              if isinstance(c, pgc.ShardedPagedCache)]
    assert layers and all(isinstance(c.logical, pgc.PagedCPQXCache) for c in layers)
    for c in layers:
        lead, other = c.shards

        def same(spec, a, b):
            if pgc.model_dim(spec) is None:
                assert torch.equal(a, b)
        pgc.tree_map(same, c.specs, lead, other)


REFERENCE = """
import dataclasses, json
import numpy as np, jax
from repro.configs import ServingCfg, get_config, smoke_config
from repro.launch.mesh import make_serve_mesh
from repro.models import model as M
from repro.serving.engine import ContinuousServeEngine, GenerationConfig
from repro.serving.scheduler import Request

cases = json.loads({cases!r})
cfg0 = dataclasses.replace(smoke_config(get_config("qwen1.5-0.5b")), dtype="float32",
                           num_blocks=2)
params = M.init_params(cfg0, jax.random.PRNGKey(0))
mesh = make_serve_mesh(1, 2)
out = {{}}
for name, (mode, serving, sizes, seed, max_new) in cases.items():
    cfg = cfg0.with_attention(mode)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, size=n).astype(np.int32),
                    max_new_tokens=max_new) for i, n in enumerate(sizes)]
    with jax.set_mesh(mesh):
        eng = ContinuousServeEngine(cfg, params, rt=dataclasses.replace(
            cfg.attention, paged_kernels=False), serving=ServingCfg(**serving), mesh=mesh)
        res, st = eng.serve(reqs, GenerationConfig(max_new_tokens=max_new))
    out[name] = dict({{k: float(st[k]) for k in (
        "model_shards", "arena_bytes_total", "arena_bytes_per_device", "interconnect_bytes",
        "escalations")}}, tokens={{str(r): v["tokens"].tolist() for r, v in res.items()}})
print("STATS " + json.dumps(out))
"""


def test_mesh_stats_equal_the_reference_sharded_engine(qwen):
    """model_shards, arena bytes in all and a device, interconnect bytes and
    escalations equal the JAX engine's over its own 2-way mesh (and so do
    its token streams)."""
    cases = {m[0]: (m[1]["mode"], dict(m[2], use_paged_kernels=False), m[3][0], m[3][1],
                    m[4]) for m in MODES if m[0] in ("dense", "cpq", "decomposed", "tiered")}
    line = [l for l in run_with_devices(REFERENCE.format(cases=json.dumps(cases))).splitlines()
            if l.startswith("STATS ")][0]
    ref = json.loads(line[len("STATS "):])
    _, Pt = packages()
    for name, (mode, serving, sizes, seed, max_new) in cases.items():
        res, st, _ = serve(Pt, qwen, greedy(prompts(sizes, seed), max_new), serving,
                           dict(max_new_tokens=max_new), dict(mode=mode),
                           make_serve_mesh(1, 2, devices="cpu"))
        want = ref[name]
        for key in ("model_shards", "arena_bytes_total", "arena_bytes_per_device",
                    "interconnect_bytes", "escalations"):
            assert float(st[key]) == want[key], (name, key, st[key], want[key])
        assert {str(r): v["tokens"].tolist() for r, v in res.items()} == want["tokens"], name
