"""The port's serving auto-tuner (``repro_torch.tuning``) against the JAX
package's ``repro.tuning``: the frontier functions, the knob space, the
search (records, frontiers, presets documents and checkpoints crossing both
ways), the energy model against ``benchmarks/``' records, the objective end
to end on the smoke model at float32 with the same weights, and the preset
loader, on the reference's committed presets and on the port's own. CPU."""
import dataclasses
import inspect
import json
import os
import sys

import numpy as np
import pytest

import repro.tuning as J
import repro_torch
import repro_torch.tuning as P
from repro.configs import ServingCfg as JServingCfg
from repro.tuning import evolution as jevo
from repro_torch.configs import ServingCfg
from repro_torch.tuning import energy as tenergy
from repro_torch.tuning import evolution as tevo

from torch_paged_cases import share_compiled, smoke_pair

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)  # the reference's energy objective imports benchmarks/

REF_PRESETS = JServingCfg.preset_path()


# ---------------------------------------------------------------- frontier


def _points(seed):
    """A seeded point set of 2-4 objectives on a coarse grid (ties), with
    some points repeated (duplicates)."""
    rng = np.random.default_rng(seed)
    n, d = int(rng.integers(3, 16)), int(rng.integers(2, 5))
    pts = [tuple(float(x) for x in rng.integers(0, 5, size=d) * 0.5) for _ in range(n)]
    pts += [pts[int(i)] for i in rng.integers(0, n, size=int(rng.integers(0, 4)))]
    return pts


@pytest.mark.parametrize("seed", range(30))
def test_frontier_functions_match_the_reference(seed):
    pts = _points(seed)
    assert [[P.dominates(a, b) for b in pts] for a in pts] == \
        [[J.dominates(a, b) for b in pts] for a in pts]
    assert P.pareto_front(pts) == J.pareto_front(pts)
    assert P.non_dominated_sort(pts) == J.non_dominated_sort(pts)
    ref = [max(p[i] for p in pts) + 0.5 for i in range(len(pts[0]))]
    got, want = P.hypervolume(pts, ref), J.hypervolume(pts, ref)
    assert got == want and type(got) is type(want)


# ------------------------------------------------------------------- space


def _random_dict(rng, space):
    """A dict with unknown keys, off-choice values, bools where numbers go
    and watermark inversions."""
    d = {}
    for k in space.knobs:
        r = rng.random()
        if r < 0.15:
            continue                                   # missing: filled from the default
        if r < 0.45:
            d[k.name] = k.choices[int(rng.integers(len(k.choices)))]
        elif r < 0.6:
            d[k.name] = bool(rng.integers(2))
        elif r < 0.8:
            d[k.name] = float(rng.normal(0.5, 4.0))
        else:
            d[k.name] = ["lifo", None, -3, 17, 0.33][int(rng.integers(5))]
    if rng.random() < 0.5:
        d["low_watermark"], d["critical_watermark"], d["high_watermark"] = 0.05, 0.9, 0.0
    d["not_a_knob"] = 1
    return d


@pytest.mark.parametrize("max_len", [48, 87, 300])
def test_space_operators_match_the_reference(max_len):
    ts, js = P.KnobSpace(max_len=max_len), J.KnobSpace(max_len=max_len)
    assert ts.budget_tokens == js.budget_tokens
    assert ts.default_genome() == js.default_genome()
    tr, jr = np.random.default_rng(max_len), np.random.default_rng(max_len)
    for _ in range(60):
        a, b = ts.sample(tr), ts.sample(tr)
        assert (a, b) == (js.sample(jr), js.sample(jr))
        for p in (0.0, 0.35, 0.9):
            assert ts.mutate(a, tr, p) == js.mutate(a, jr, p)
        assert ts.crossover(a, b, tr) == js.crossover(a, b, jr)
        assert ts.genome_key(a) == js.genome_key(a)
        assert dataclasses.asdict(ts.to_serving(a)) == dataclasses.asdict(js.to_serving(a))
    assert tr.bit_generator.state == jr.bit_generator.state


@pytest.mark.parametrize("seed", range(4))
def test_validate_and_repair_matches_the_reference(seed):
    ts, js = P.KnobSpace(max_len=64), J.KnobSpace(max_len=64)
    rng = np.random.default_rng(seed)
    for _ in range(80):
        d = _random_dict(rng, ts)
        g = ts.validate_and_repair(dict(d))
        assert g == js.validate_and_repair(dict(d))
        assert [type(v) for v in g.values()] == [type(v) for v in js.validate_and_repair(d).values()]
        assert dataclasses.asdict(ts.to_serving(g)) == dataclasses.asdict(js.to_serving(g))


def test_space_for_trace_and_restricted_spaces_match():
    from repro.serving import trace as jtrace
    from repro_torch.serving import trace as ttrace

    work = ttrace.make_workload(0, 6, 64, 2.0)
    assert P.space_for_trace(work) == P.KnobSpace(max_len=J.space_for_trace(
        jtrace.make_workload(0, 6, 64, 2.0)).max_len)
    knobs = (P.Knob("num_slots", (2, 4)), P.Knob("policy", ("fifo", "slo")))
    ts = P.KnobSpace(max_len=40, knobs=knobs, budget_slots=2, budget_page=4)
    js = J.KnobSpace(max_len=40, knobs=tuple(J.Knob(k.name, k.choices) for k in knobs),
                     budget_slots=2, budget_page=4)
    for g in ({}, {"num_slots": 3, "policy": "lifo"}, {"num_slots": 4}):
        assert ts.validate_and_repair(g) == js.validate_and_repair(g)
        assert dataclasses.asdict(ts.to_serving(g)) == dataclasses.asdict(js.to_serving(g))
    assert tevo.make_space_from_signature(tevo._space_signature(ts)) == ts
    assert tevo._space_signature(ts) == jevo._space_signature(js)


# ---------------------------------------------------------------- evolution


def _synthetic(space):
    """The reference tests' cheap deterministic objective."""
    def ev(g):
        s = space.to_serving(g)
        obj = (-float(s.num_slots * (1 + 0.3 * s.spec_len)),
               float(s.prefill_chunk + 10 * (s.policy == "fifo")),
               float(s.page_size + s.num_slots))
        return obj, {"num_slots": s.num_slots, "ratio": s.page_size / 3}
    return ev


def _doc(pkg, search):
    return json.dumps(pkg.materialize(search, trace={"kind": "synthetic"}), sort_keys=True)


@pytest.mark.parametrize("seed,mu,lam,budget", [(0, 6, 6, 24), (3, 4, 4, 20), (5, 2, 3, 17)])
def test_search_matches_the_reference(seed, mu, lam, budget):
    ts, js = P.KnobSpace(max_len=48), J.KnobSpace(max_len=48)
    t = P.ParetoSearch(ts, _synthetic(ts), seed=seed, mu=mu, lam=lam)
    j = J.ParetoSearch(js, _synthetic(js), seed=seed, mu=mu, lam=lam)
    tf, jf = t.run(budget), j.run(budget)
    assert [dataclasses.astuple(r) for r in t.records] == \
        [dataclasses.astuple(r) for r in j.records]
    assert [dataclasses.astuple(r) for r in tf] == [dataclasses.astuple(r) for r in jf]
    assert t.frontier_hypervolume() == j.frontier_hypervolume()
    assert {k: dataclasses.astuple(r) for k, r in P.select_presets(ts, tf).items()} == \
        {k: dataclasses.astuple(r) for k, r in J.select_presets(js, jf).items()}
    assert _doc(P, t) == _doc(J, j)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_checkpoints_cross_between_the_packages(tmp_path, first):
    """A checkpoint written after 7 evaluations by one package resumes in the
    other: the same file after every later evaluation, and the same records
    and frontier as a straight run."""
    ts, js = P.KnobSpace(max_len=48), J.KnobSpace(max_len=48)
    make = {"jax": lambda ck: J.ParetoSearch(js, _synthetic(js), seed=2, mu=4, lam=4,
                                             checkpoint=ck),
            "torch": lambda ck: P.ParetoSearch(ts, _synthetic(ts), seed=2, mu=4, lam=4,
                                               checkpoint=ck)}
    second = "torch" if first == "jax" else "jax"
    ck, straight_ck = str(tmp_path / "ck.json"), str(tmp_path / "straight.json")
    make[first](ck).run(7)
    resumed = make[second](ck)
    assert len(resumed.records) == 7
    front = resumed.run(19)
    straight = make[first](straight_ck)
    straight_front = straight.run(19)
    assert open(ck).read() == open(straight_ck).read()
    assert [dataclasses.astuple(r) for r in resumed.records] == \
        [dataclasses.astuple(r) for r in straight.records]
    assert [r.objectives for r in front] == [r.objectives for r in straight_front]


def test_checkpoint_mismatch_and_memo_as_the_reference(tmp_path):
    ts = P.KnobSpace(max_len=48)
    ck = str(tmp_path / "ck.json")
    P.ParetoSearch(ts, _synthetic(ts), seed=5, checkpoint=ck).run(3)
    with pytest.raises(ValueError, match="seed"):
        P.ParetoSearch(ts, _synthetic(ts), seed=6, checkpoint=ck)
    with pytest.raises(ValueError, match="knob space"):
        P.ParetoSearch(P.KnobSpace(max_len=64), _synthetic(ts), seed=5, checkpoint=ck)
    tiny = P.KnobSpace(max_len=48, knobs=(ts.knobs[0],))
    calls = []
    search = P.ParetoSearch(tiny, lambda g: (calls.append(g) or ((float(g["num_slots"]),), {})),
                            seed=0, mu=2, lam=2)
    search.run(12)
    assert len(search.records) == 12 and len(calls) <= 4


# ------------------------------------------------------------------- energy


@pytest.mark.parametrize("record", ["TPU_V5E", "A100", "FLIGHTLLM", "PIM"])
def test_decode_token_cost_matches_the_reference(record):
    from benchmarks import bench_e2e_energy as be, hw

    ref = getattr(hw, record)
    dev = tenergy.Device(**dataclasses.asdict(ref))
    rng = np.random.default_rng(len(record))
    for _ in range(50):
        # the fields the tuner sets; the reference's others stay at their
        # defaults, which the port's model fixes
        kw = dict(batch=int(rng.integers(1, 64)),
                  kv_bytes_per_token_layer=float(rng.uniform(0, 1e4)),
                  prefill_ctx=int(rng.integers(0, 4096)), gen_tokens=int(rng.integers(0, 512)),
                  prefill_write_bytes_per_token_layer=float(rng.uniform(0, 1e4)),
                  slot_util=float(rng.uniform(-0.2, 1.2)))
        n, L = float(rng.uniform(1e8, 1e11)), int(rng.integers(1, 96))
        assert tenergy.decode_token_cost(dev, n, L, tenergy.TrafficCfg(**kw)) == \
            be.decode_token_cost(ref, n, L, be.TrafficCfg(**kw))


def test_the_cards_record_and_the_paper_scale():
    from repro.tuning import objectives as jobj
    from repro_torch.tuning import objectives as tobj

    h100 = tenergy.H100_SXM
    assert (h100.peak_flops, h100.hbm_bw, h100.power_w) == (989e12, 3.35e12, 700.0)
    assert h100.mac_pj == pytest.approx(700.0 / 989e12 * 1e12 / 2)
    assert h100.idle_w == pytest.approx(0.3 * 700.0) and h100.mem_pj_per_byte == 30.0
    default = inspect.signature(P.ServingObjective).parameters["device_model"].default
    assert default is h100
    assert tobj._paper_scale()["n_params"] == jobj._paper_scale()["n_params"]
    assert tobj._paper_scale()["L"] == jobj._paper_scale()["L"]
    for page in (4, 8, 16):
        assert tobj._kv_paged_bytes(page) == jobj._kv_paged_bytes(page)


# ---------------------------------------------------------------- objective

# the genomes chip_smoke.py phase 10 (u2) holds the card to: what, knobs set
# apart from DEFAULT_GENOME, and the space's budget rows (None: the trace's
# own space; 1: one row's arena, where a tiered genome admits into CPQ)
GENOMES = [
    ("default", {}, None),
    ("spec 2 slo", {"spec_len": 2, "policy": "slo"}, None),
    ("tiered pages 4", {"enable_escalation": True, "page_size": 4}, None),
    ("chunks 4 pages 16", {"chunk_pages": 4, "page_size": 16}, None),
    ("tiered pages 4, one row's arena", {"enable_escalation": True, "page_size": 4,
                                         "chunk_pages": 1, "low_watermark": 0.4}, 1),
]


@pytest.fixture(scope="module")
def objectives():
    """The smoke config at float32 (one block), the same weights on both
    sides; the port prices energy on the reference's TPU record."""
    from benchmarks.hw import TPU_V5E

    cfg, tcfg, params, tparams = smoke_pair(num_blocks=1)
    tpu = tenergy.Device(**dataclasses.asdict(TPU_V5E))
    jo = J.ServingObjective(cfg, params)
    to = P.ServingObjective(tcfg, tparams, device_model=tpu, device="cpu")

    def pair(rows):
        if rows is None:
            return jo, to
        js = J.KnobSpace(max_len=jo.space.max_len, budget_slots=rows)
        ts = P.KnobSpace(max_len=to.space.max_len, budget_slots=rows)
        return (J.ServingObjective(cfg, params, space=js),
                P.ServingObjective(tcfg, tparams, space=ts, device_model=tpu, device="cpu"))
    return pair


@pytest.mark.parametrize("what,knobs,rows", GENOMES, ids=[g[0] for g in GENOMES])
def test_objective_matches_the_reference(objectives, what, knobs, rows):
    jo, to = objectives(rows)
    genome = {**P.DEFAULT_GENOME, **knobs}
    # the JAX engines of both arena kinds adopt the process's donor
    for tiered in (False, True):
        serving = dataclasses.replace(jo.space.to_serving(genome), enable_escalation=tiered)
        share_compiled(jo._donor(serving))
    jobj, jmet = jo(genome)
    tobj, tmet = to(genome)
    assert tobj == jobj, what
    assert tmet == jmet and list(tmet) == list(jmet), what
    assert all(type(v) in (int, float) for v in tmet.values())


def test_objective_names_and_trace_spec():
    assert P.OBJECTIVE_NAMES == J.OBJECTIVE_NAMES
    for spec in (P.TraceSpec(), P.TraceSpec(kind="mixed", seed=3, n_requests=5, rate=1.0)):
        jw, js = J.TraceSpec(**dataclasses.asdict(spec)).build(256)
        tw, ts = spec.build(256)
        items = lambda work: [(w.rid, w.prompt.tolist(), w.target, w.arrival)  # noqa: E731
                              for w in work]
        assert items(tw) == items(jw)
        assert (ts is None) == (js is None)
    with pytest.raises(ValueError, match="trace kind"):
        P.TraceSpec(kind="burst").build(256)


# ------------------------------------------------------------------ presets


def test_presets_of_the_reference_file_load_as_the_reference():
    names = ServingCfg.list_presets(REF_PRESETS)
    assert names == JServingCfg.list_presets()
    for name in names:
        assert dataclasses.asdict(ServingCfg.from_preset(name, path=REF_PRESETS)) == \
            dataclasses.asdict(JServingCfg.from_preset(name))
    over = dict(num_slots=2, num_pages=9, max_blocks_per_slot=2)
    got = ServingCfg.from_preset("latency", path=REF_PRESETS, **over)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JServingCfg.from_preset("latency", **over))
    assert (got.num_slots, got.num_pages, got.max_blocks_per_slot) == (2, 9, 2)
    with pytest.raises(ValueError, match="unknown serving preset.*latency"):
        ServingCfg.from_preset("no-such-preset", path=REF_PRESETS)
    with pytest.raises(ValueError, match="unknown serving preset.*default"):
        ServingCfg.from_preset("no-such-preset")


def test_the_ports_committed_presets():
    path = ServingCfg.preset_path()
    assert path == os.path.join(os.path.dirname(repro_torch.__file__), "serving_presets.json")
    doc = P.load_presets(path)
    assert doc["version"] == 1 and doc["objective_names"] == list(P.OBJECTIVE_NAMES)
    trace = doc["trace"]
    assert trace["device_model"] == tenergy.H100_SXM.name and trace["device"] == "cuda"
    assert trace["card"].startswith("NVIDIA H100") and trace["card"].endswith(" W")
    assert ServingCfg.list_presets() == ["default", "energy", "latency", "throughput"]
    objs = [tuple(p["objectives"][n] for n in doc["objective_names"])
            for p in doc["frontier"]]
    assert len(P.pareto_front(objs)) == len(objs)
    base = doc["presets"]["default"]["objectives"]
    for name in ("throughput", "latency", "energy"):
        assert doc["presets"][name]["objectives"][name] <= base[name]
    space = P.KnobSpace(max_len=trace["max_len"])
    assert ServingCfg.from_preset("default") == space.to_serving(P.DEFAULT_GENOME)
    for name, preset in doc["presets"].items():
        s = ServingCfg.from_preset(name)
        assert s == space.to_serving(preset["genome"])
        assert s.prefill_chunk % s.page_size == 0


def test_the_committed_presets_regenerate_on_the_cpu(tmp_path, capsys):
    """The committed presets were written on the card by ``python -m
    repro_torch.launch.tune --budget 24 --seed 0``; the same command on the
    CPU writes the same document, but for where it ran (``trace.device``,
    ``trace.card``) and for the speculative genomes. Their draft acceptance
    follows the bf16 token streams, which round one way on the CPU and
    another on the card; every other genome's objectives follow scheduling
    alone. So the presets, the frontier's points without speculation and
    the rest of the document are identical."""
    from repro_torch.launch import tune

    out = tmp_path / "presets.json"
    assert tune.main(["--budget", "24", "--seed", "0", "--device", "cpu",
                      "--out", str(out)]) == 0
    capsys.readouterr()
    got, want = P.load_presets(str(out)), P.load_presets(ServingCfg.preset_path())
    assert (got["trace"].pop("device"), got["trace"].pop("card")) == ("cpu", "cpu")
    assert want["trace"].pop("device") == "cuda" and want["trace"].pop("card")

    def plain(doc):
        return [p for p in doc["frontier"] if p["genome"]["spec_len"] == 0]

    assert plain(got) == plain(want) and plain(want)
    rest = ("frontier", "hypervolume")
    assert {k: v for k, v in got.items() if k not in rest} == \
        {k: v for k, v in want.items() if k not in rest}


def test_write_presets_is_the_reference_format(tmp_path):
    ts = P.KnobSpace(max_len=48)
    t = P.ParetoSearch(ts, _synthetic(ts), seed=1, mu=4, lam=4)
    t.run(10)
    doc = P.materialize(t, trace={"kind": "synthetic"})
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    P.write_presets(a, doc)
    J.write_presets(b, doc)
    assert open(a).read() == open(b).read()
    assert P.load_presets(a) == doc
