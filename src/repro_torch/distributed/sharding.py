"""The port's device mesh and partition specs (the JAX package's
``distributed/sharding.py`` and the part of ``jax.sharding`` it uses).

A ``Mesh`` is a grid of ``torch.device``s with named axes. A
``PartitionSpec`` names, for each dimension of an array, the mesh axis (or
tuple of axes) it is split over, or None where it is held whole.
``resolve`` turns logical axis names into a spec through a rule set
(``distributed/rules.py``); ``fit_spec_to_shape`` drops the mesh axes that
do not divide their dimension. The training-side context (``constrain``,
``sharding_context``) is not ported yet (ROADMAP A21b)."""
from __future__ import annotations

import numpy as np
import torch


class PartitionSpec(tuple):
    """Per-dimension mesh axes: a tuple of axis names, tuples of names or
    None. Trailing dimensions it does not name are held whole."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def canonical_device(d) -> torch.device:
    """``d`` as a torch.device with its index made explicit for CUDA."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A grid of devices with named axes (the port's ``jax.sharding.Mesh``):
    ``devices`` is a numpy array of ``torch.device`` of one dimension per
    axis, ``axis_names`` their names and ``shape`` the axis sizes by name.
    A device may appear more than once: its shards then share it (the
    port's counterpart of XLA's emulated host devices)."""

    def __init__(self, devices, axis_names: tuple):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a mesh of {grid.ndim} dimensions given {len(axis_names)} "
                             f"axis names {axis_names}")
        flat = [canonical_device(d) for d in grid.reshape(-1)]
        self.devices = np.empty(grid.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        index = [0] * len(self.axis_names)
        out = []
        for i in range(self.devices.shape[k]):
            index[k] = i
            out.append(self.devices[tuple(index)])
        return out

    def _key(self):
        return self.axis_names, tuple(str(d) for d in self.devices.reshape(-1)), \
            self.devices.shape

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def resolve(rules: dict, axes: tuple) -> PartitionSpec:
    """Logical axes tuple -> PartitionSpec, dropping mesh-axis reuse."""
    used: set[str] = set()
    out = []
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        if m is None:
            out.append(None)
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        ms = tuple(a for a in ms if a not in used)
        used.update(ms)
        out.append(ms if len(ms) > 1 else (ms[0] if ms else None))
    return PartitionSpec(*out)


def fit_spec_to_shape(spec: PartitionSpec, shape: tuple, mesh: Mesh) -> PartitionSpec:
    """Drop mesh axes that do not evenly divide the corresponding dim."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        ms = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        kept, prod = [], 1
        for a in ms:
            k = sizes.get(a, 1)
            if dim % (prod * k) == 0:
                kept.append(a)
                prod *= k
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return PartitionSpec(*out)


def axis_dim(spec: PartitionSpec, axis: str):
    """The dimension ``spec`` splits over mesh axis ``axis``, or None."""
    for d, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return d
    return None
