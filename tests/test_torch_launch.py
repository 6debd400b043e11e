"""The port's serve and tune entry points (``repro_torch.launch.serve`` and
``repro_torch.launch.tune``) at smoke size on the CPU: the static engine in
each mode and for each kind of input, the continuous engine under each of
the port's committed presets (the ServingCfg it derives, and the default
preset's output against a direct engine run), the router with injected
faults, every argument error of the reference's launcher with the
reference's own message, and a tune --smoke search that writes where it is
told and nowhere else."""
import dataclasses
import hashlib
import re

import numpy as np
import pytest
import torch

import repro_torch as T
from repro.launch import serve as jserve
from repro_torch.launch import serve, tune
from repro_torch.serving.paged_cache import pages_needed

SMALL = ["--batch", "2", "--prompt", "24", "--new", "6", "--device", "cpu"]
PRESETS = ("default", "latency", "throughput", "energy")


@pytest.mark.parametrize("mode", ["dense", "decomposed", "cpq", "retrieval", "decomposed_cpq"])
def test_static_modes_on_audio_frames(mode):
    out = serve.main(["--arch", "musicgen-large", "--smoke", "--mode", mode, *SMALL])
    assert out.shape == (2, 6) and out.dtype == np.int32
    assert out.min() >= 0 and out.max() < 256


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama-3.2-vision-11b"])
def test_static_tokens_and_patches(arch):
    out = serve.main(["--arch", arch, "--smoke", *SMALL])
    assert out.shape == (2, 6) and out.min() >= 0


class _Capture(T.ContinuousServeEngine):
    """The engine the launcher builds, with the ServingCfg it was given kept."""
    built: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _Capture.built.append(self.serving)


@pytest.mark.parametrize("preset", PRESETS)
def test_continuous_presets(monkeypatch, preset):
    monkeypatch.setattr(serve, "ContinuousServeEngine", _Capture)
    _Capture.built.clear()
    out = serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--continuous", "--preset",
                      preset, *SMALL])
    assert out.shape == (2, 6)
    # the reference's formula: the tuned knobs, the arena sized for --prompt/--new
    n_max, base = 24 + 6, T.ServingCfg.from_preset(preset)
    want = T.ServingCfg.from_preset(
        preset, num_pages=base.num_slots * pages_needed(n_max, base.page_size) + 1,
        max_blocks_per_slot=pages_needed(n_max, base.page_size),
        prefill_bucket=base.prefill_chunk or base.page_size, probe_interval=4,
        auto_drain=False, deadline_scale=0.0)
    assert _Capture.built == [want]
    if preset == "default":
        from repro_torch.configs import ShapeCfg
        from repro_torch.data import DataConfig, SyntheticLMData

        cfg = T.smoke_config(T.ARCHS["qwen1.5-0.5b"])
        batch = SyntheticLMData(cfg, ShapeCfg("serve", 24, 2, "prefill"),
                                DataConfig(seed=0)).batch(0)
        eng = T.ContinuousServeEngine(cfg, T.init_params(cfg, 0, device="cpu"),
                                      serving=want, device="cpu")
        direct, _ = eng.generate({"tokens": batch["tokens"]},
                                 T.GenerationConfig(max_new_tokens=6))
        np.testing.assert_array_equal(out, direct)


def test_continuous_modes_and_hand_tuned_knobs():
    base = ["--arch", "qwen1.5-0.5b", "--smoke", "--continuous", *SMALL]
    dense = serve.main(base)
    for extra in (["--mode", "decomposed"], ["--prefill-chunk", "0"],
                  ["--speculate", "2", "--policy", "slo"]):
        out = serve.main(base + extra)
        assert out.shape == (2, 6)
        if extra[0] != "--mode":  # greedy streams do not depend on admission or drafts
            np.testing.assert_array_equal(out, dense)


def test_router_with_injected_faults(capsys):
    base = ["--arch", "qwen1.5-0.5b", "--smoke", "--continuous", *SMALL]
    single = serve.main(base)
    out = serve.main(base + ["--replicas", "2", "--inject-faults", "0"])
    text = capsys.readouterr().out
    assert "router: 2 replicas" in text and "fault injection seed=0" in text
    np.testing.assert_array_equal(out, single)   # recompute replay is exact


ERRORS = [  # argument lists the reference's launcher refuses, in its order
    ["--policy", "slo"],
    ["--replicas", "0"],
    ["--replicas", "2"],
    ["--speculate", "2"],
    ["--continuous", "--speculate", "-1"],
    ["--continuous", "--speculate", "2", "--prefill-chunk", "0"],
    ["--preset", "latency"],
    ["--continuous", "--preset", "latency", "--policy", "slo"],
    ["--continuous", "--preset", "latency", "--prefill-chunk", "32"],
    ["--continuous", "--preset", "latency", "--speculate", "2"],
    ["--deadline-scale", "1.0"],
    ["--continuous", "--deadline-scale", "-1"],
    ["--continuous", "--auto-drain"],
    ["--continuous", "--inject-faults", "0"],
    ["--mesh", "1,1"],
    # two faults at once: the first in the reference's order is named
    ["--policy", "slo", "--replicas", "0"],
    ["--preset", "latency", "--speculate", "-1"],
    ["--continuous", "--auto-drain", "--deadline-scale", "-1"],
]


def _refusal(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(["--arch", "qwen1.5-0.5b", "--smoke", *argv])
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", ERRORS, ids=[" ".join(a) for a in ERRORS])
def test_argument_errors_match_the_reference(argv, capsys):
    want = _refusal(jserve.main, argv, capsys)
    got = _refusal(serve.main, argv + ["--device", "cpu"], capsys)
    assert "error: " in want and got == want


def test_mesh_is_refused_naming_its_roadmap_item(capsys):
    """``--mesh`` serves the continuous engine over the mesh (the shards share
    the CPU under ``--device cpu``) and prints the reference launcher's
    mesh and arena lines; without ``--continuous`` it is still refused
    (``ERRORS``), and without a device of its own it needs distinct GPUs."""
    argv = ["--arch", "qwen1.5-0.5b", "--smoke", "--continuous", "--mesh", "1,2", *SMALL]
    out = serve.main(argv)
    assert out.shape == (2, 6)
    lines = capsys.readouterr().out.splitlines()
    assert "[serve] mesh: data=1 model=2 (arenas sharded over the kv-head axis)" in lines
    arena = [ln for ln in lines if ln.startswith("[serve] arena: ")]
    assert len(arena) == 1 and re.fullmatch(
        r"\[serve\] arena: \d+\.\d\d MiB/device of \d+\.\d\d MiB total; interconnect "
        r"\d+\.\d B/token \(per-head partial concat \+ latent pool gathers\)", arena[0])
    np.testing.assert_array_equal(out, serve.main([a for a in argv if a not in ("--mesh",
                                                                               "1,2")]))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match=r"mesh \(1,2\) needs 2 devices, have 0"):
            serve.main(argv[:-2])


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_tune_smoke_writes_only_its_out(tmp_path, capsys):
    from repro.configs import ServingCfg as JServingCfg

    committed = [T.ServingCfg.preset_path(), JServingCfg.preset_path()]
    before = [_digest(p) for p in committed]
    out = tmp_path / "presets.json"
    ck = tmp_path / "ck.json"
    assert tune.main(["--budget", "7", "--smoke", "--device", "cpu", "--out", str(out),
                      "--checkpoint", str(ck)]) == 0
    assert "smoke PASS" in capsys.readouterr().out
    assert [_digest(p) for p in committed] == before
    doc = T.ServingCfg.list_presets(str(out))
    assert doc == ["default", "energy", "latency", "throughput"]
    from repro_torch.tuning import load_presets

    trace = load_presets(str(out))["trace"]
    assert (trace["device"], trace["card"], trace["device_model"]) == ("cpu", "cpu", "h100-sxm")
    # a resumed search replays the checkpoint and writes the same document
    again = tmp_path / "again.json"
    assert tune.main(["--budget", "7", "--device", "cpu", "--out", str(again),
                      "--checkpoint", str(ck)]) == 0
    assert "resumed 7 evaluated points" in capsys.readouterr().out
    assert _digest(again) == _digest(out)
    with pytest.raises(SystemExit):
        tune.main(["--budget", "0", "--device", "cpu", "--out", str(out)])
    assert dataclasses.asdict(T.ServingCfg.from_preset("default", path=str(out))) == \
        dataclasses.asdict(T.ServingCfg.from_preset("default"))
