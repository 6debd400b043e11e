"""Serving meshes (the JAX package's ``launch/mesh.py``). A function, not a
module-level constant, so that importing this module touches no device.
``make_production_mesh`` (the training mesh) waits for ROADMAP A21b."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.distributed.sharding import Mesh


def make_serve_mesh(dp: int = 1, mp: int = 1,
                    devices: Optional[Union[Sequence, str, torch.device]] = None) -> Mesh:
    """Serving mesh ("data", "model"): ``mp``-way model sharding splits
    every paged arena's kv-head (or latent feature) axis, so each device
    holds 1/mp of the cache and sweeps only its head shard
    (serving/sharded.py); ``dp`` replicates the engine. The devices are the
    visible CUDA devices, each once, unless ``devices`` lists them: a list
    may repeat a device (the shards then share it; the CPU tests repeat
    ``cpu``, one card repeats ``cuda:0``), and a single device stands for
    every position of the grid."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * (dp * mp)
    devices = list(devices)
    n = len(devices)
    if dp * mp > n:
        raise ValueError(f"mesh ({dp},{mp}) needs {dp * mp} devices, have {n} "
                         "(on one card or on the CPU pass devices=, repeating a device)")
    grid = np.empty((dp, mp), dtype=object)
    grid.reshape(-1)[:] = devices[:dp * mp]
    return Mesh(grid, ("data", "model"))


def parse_mesh_arg(arg: str,
                   devices: Optional[Union[Sequence, str, torch.device]] = None) -> Mesh:
    """CLI ``--mesh dp,mp`` -> Mesh (e.g. "1,2")."""
    try:
        dp, mp = (int(x) for x in arg.split(","))
    except ValueError as e:
        raise ValueError(f"--mesh wants 'dp,mp' (e.g. 1,2); got {arg!r}") from e
    return make_serve_mesh(dp, mp, devices)


def mesh_shape_dict(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))
