"""The port stands alone: every ``repro_torch`` module and ``chip_smoke``
import with JAX and the JAX package made unimportable, and no JAX module is
loaded afterwards. Entry points run on the GPU unless told otherwise: with
no GPU and no explicit device they raise instead of running on the CPU."""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import repro_torch as T
from repro_torch.params import init_params, resolve_device

ROOT = os.path.join(os.path.dirname(__file__), "..")

ISOLATED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None       # any import of jax or repro now fails
sys.modules["repro"] = None
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
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
    assert int(r.stdout.split()[-1]) >= 15  # every module of the port was imported


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
