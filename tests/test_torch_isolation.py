"""The port stands alone: every ``repro_torch`` module and ``chip_smoke``
import with JAX and the JAX package made unimportable, and no JAX module is
loaded afterwards. Entry points (the engines, the router, the tuner's
objective, the train, serve and tune launchers) run on the GPU unless told
otherwise: with no GPU and no explicit device they raise instead of running
on the CPU; the train launcher trains over a mesh of the device it is given
and refuses a mesh it has too few CUDA devices for, naming the count."""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import repro_torch as T
from repro_torch.params import init_params, resolve_device
from repro_torch.serving.router import ReplicaRouter

ROOT = os.path.join(os.path.dirname(__file__), "..")

ISOLATED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None       # any import of jax or repro now fails
sys.modules["repro"] = None
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
for name in ("serving.trace", "serving.prng", "serving.speculative", "models.moe",
             "models.mla", "models.mamba", "models.xlstm", "serving.router",
             "serving.faults", "serving.health", "launch.train", "train.step",
             "optim.optimizers", "optim.schedule", "optim.compression", "data.pipeline",
             "checkpoint.manager", "checkpoint.msgpack_lite", "tuning.space",
             "tuning.frontier", "tuning.evolution", "tuning.objectives", "tuning.presets",
             "tuning.energy", "launch.serve", "launch.tune", "launch.mesh",
             "distributed.sharding", "distributed.rules", "distributed.cache_specs",
             "distributed.collectives", "distributed.pipeline", "serving.sharded",
             "launch.dryrun", "launch.input_specs", "train.sharded"):
    assert "repro_torch." + name in names, name
sys.path.insert(0, sys.argv[1])
import chip_smoke
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", ISOLATED, ROOT], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 26  # every module of the port was imported


def test_entry_points_need_a_gpu_or_an_explicit_device():
    cfg = dataclasses.replace(T.smoke_config(T.ARCHS["qwen1.5-0.5b"]), dtype="float32")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, 0)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.ContinuousServeEngine(cfg, params)
    eng = T.ContinuousServeEngine(cfg, params, device="cpu")
    assert eng.device.type == "cpu"


def test_router_needs_a_gpu_or_an_explicit_device_and_refuses_a_mesh():
    """The router forwards a mesh to every replica (each splits its own
    arenas, all share one weight tree) and refuses what is not a mesh."""
    from repro_torch.launch.mesh import make_serve_mesh

    cfg = dataclasses.replace(T.smoke_config(T.ARCHS["qwen1.5-0.5b"]), dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(T.SchedulerConfigError, match="mesh must be a"):
        ReplicaRouter(cfg, params, num_replicas=2, mesh=object(), device="cpu")
    mesh = make_serve_mesh(1, 2, devices="cpu")
    router = ReplicaRouter(cfg, params, num_replicas=2, mesh=mesh)
    assert all(e.mesh == mesh and e.model_shards == 2 for e in router.engines)
    assert router.engines[1].params is router.engines[0].params
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaRouter(cfg, params, num_replicas=2)
    router = ReplicaRouter(cfg, params, num_replicas=2, device="cpu")
    assert [e.device.type for e in router.engines] == ["cpu", "cpu"]


def test_train_entry_point_needs_a_gpu_or_an_explicit_device_and_refuses_a_mesh():
    from repro_torch.launch.train import main

    args = ["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1", "--batch", "2",
            "--seq", "8"]
    for mesh, n in (("single", 256), ("multi", 512)):
        assert main(args + ["--mesh", mesh, "--device", "cpu"]) > 0
        if torch.cuda.device_count() < n:
            have = torch.cuda.device_count()
            with pytest.raises(ValueError, match=rf"needs {n} devices, have {have} "):
                main(args + ["--mesh", mesh])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
    assert main(args + ["--device", "cpu"]) > 0


def test_tuner_and_launchers_need_a_gpu_or_an_explicit_device():
    from repro_torch.launch import serve, tune
    from repro_torch.tuning import ServingObjective

    cfg = dataclasses.replace(T.smoke_config(T.ARCHS["qwen1.5-0.5b"]), dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    serve_args = ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "1", "--prompt", "4",
                  "--new", "2"]
    tune_args = ["--budget", "1", "--out", os.devnull]
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingObjective(cfg, params)
    assert ServingObjective(cfg, params, device="cpu").device.type == "cpu"
    for main, args in ((serve.main, serve_args), (serve.main, serve_args + ["--continuous"]),
                       (tune.main, tune_args)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(args)
    assert serve.main(serve_args + ["--device", "cpu"]).shape == (1, 2)
