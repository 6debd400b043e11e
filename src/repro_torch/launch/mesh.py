"""Production and serving meshes (the JAX package's ``launch/mesh.py``).
Functions, not module-level constants, so that importing this module
touches no device."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.distributed.sharding import Mesh


Devices = Optional[Union[Sequence, str, torch.device]]


def _grid(shape: tuple, axes: tuple, devices: Devices) -> Mesh:
    """A mesh of ``shape`` over ``devices``: the visible CUDA devices, each
    once, by default; a list may repeat a device (the shards then share
    it); a single device stands for every position of the grid. Too few
    devices raise, naming the count: the grid never shrinks."""
    n_need = math.prod(shape)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * n_need
    devices = list(devices)
    if n_need > len(devices):
        dims = ",".join(str(n) for n in shape)
        raise ValueError(f"mesh ({dims}) needs {n_need} devices, have {len(devices)} "
                         "(on one card or on the CPU pass devices=, repeating a device)")
    grid = np.empty(shape, dtype=object)
    grid.reshape(-1)[:] = devices[:n_need]
    return Mesh(grid, axes)


def make_production_mesh(multi_pod: bool = False, devices: Devices = None) -> Mesh:
    """The training mesh: (16, 16) over ("data", "model"), or with
    ``multi_pod`` (2, 16, 16) over ("pod", "data", "model") (the
    reference's). ``devices`` as ``make_serve_mesh`` takes them."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, devices)


def make_serve_mesh(dp: int = 1, mp: int = 1, devices: Devices = None) -> Mesh:
    """Serving mesh ("data", "model"): ``mp``-way model sharding splits
    every paged arena's kv-head (or latent feature) axis, so each device
    holds 1/mp of the cache and sweeps only its head shard
    (serving/sharded.py); ``dp`` replicates the engine. The devices are the
    visible CUDA devices, each once, unless ``devices`` lists them: a list
    may repeat a device (the shards then share it; the CPU tests repeat
    ``cpu``, one card repeats ``cuda:0``), and a single device stands for
    every position of the grid."""
    return _grid((dp, mp), ("data", "model"), devices)


def parse_mesh_arg(arg: str, devices: Devices = None) -> Mesh:
    """CLI ``--mesh dp,mp`` -> Mesh (e.g. "1,2")."""
    try:
        dp, mp = (int(x) for x in arg.split(","))
    except ValueError as e:
        raise ValueError(f"--mesh wants 'dp,mp' (e.g. 1,2); got {arg!r}") from e
    return make_serve_mesh(dp, mp, devices)


def mesh_shape_dict(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))
