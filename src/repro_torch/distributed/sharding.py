"""The port's device mesh and partition specs (the JAX package's
``distributed/sharding.py`` and the part of ``jax.sharding`` it uses).

A ``Mesh`` is a grid of ``torch.device``s with named axes. A
``PartitionSpec`` names, for each dimension of an array, the mesh axis (or
tuple of axes) it is split over, or None where it is held whole.
``resolve`` turns logical axis names into a spec through a rule set
(``distributed/rules.py``); ``fit_spec_to_shape`` drops the mesh axes that
do not divide their dimension.

``sharding_context(mesh, rules)`` activates a mesh and an activation rule
set, as the reference's does for its jit traces; ``constrain(x, *axes)``
is the identity outside one and, inside, checks the rank and resolves and
fits the spec as the reference does. The reference then hands the spec to
XLA's partitioner, which derives the tensor-parallel compute from it; the
port's training mesh (``train/sharded.py``) shards storage only and runs
each data replica's compute whole on its device, so the resolved spec is
returned for the caller and ``x`` passes unchanged (the tensor-parallel
compute is ROADMAP A21c)."""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

import numpy as np
import torch


class PartitionSpec(tuple):
    """Per-dimension mesh axes: a tuple of axis names, tuples of names or
    None. Trailing dimensions it does not name are held whole. A tuple of
    one name is that name, as in JAX's ``PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                          for p in parts))

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


_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_ctx", default=None)


@contextlib.contextmanager
def sharding_context(mesh: Mesh, rules: dict):
    """Activate (mesh, activation rules) for ``constrain``."""
    tok = _CTX.set((mesh, dict(rules)))
    try:
        yield
    finally:
        _CTX.reset(tok)


def constrained_spec(x: torch.Tensor, *axes) -> Optional[PartitionSpec]:
    """The fitted spec ``constrain`` gives ``x`` in the active context (None
    outside one). Raises the reference's ``ValueError`` when the rank of
    ``x`` is not the number of axes."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    mesh, rules = ctx
    if x.ndim != len(axes):
        raise ValueError(f"rank {x.ndim} vs axes {axes}")
    return fit_spec_to_shape(resolve(rules, tuple(axes)), tuple(x.shape), mesh)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` unchanged; inside a context, its rank checked and its spec
    resolved as the reference's ``constrain`` resolves it."""
    constrained_spec(x, *axes)
    return x


def active_mesh() -> Optional[Mesh]:
    ctx = _CTX.get()
    return ctx[0] if ctx else None


# ------------------------------------------------------------ sharded arrays


def spec_parts(spec: PartitionSpec, ndim: int, mesh: Mesh) -> tuple:
    """The number of blocks ``spec`` cuts each of ``ndim`` dimensions into."""
    out = []
    for entry in tuple(spec) + (None,) * (ndim - len(spec)):
        ms = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        out.append(int(np.prod([mesh.shape[a] for a in ms], dtype=np.int64)))
    return tuple(out)


def position_index(spec: PartitionSpec, ndim: int, mesh: Mesh, pos: tuple) -> tuple:
    """The block (one part index a dimension) that grid position ``pos``
    holds: along a dimension split over several mesh axes the first is the
    major one, as in JAX's ``NamedSharding``."""
    coord = dict(zip(mesh.axis_names, pos))
    out = []
    for entry in tuple(spec) + (None,) * (ndim - len(spec)):
        ms = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        i = 0
        for a in ms:
            i = i * mesh.shape[a] + coord[a]
        out.append(i)
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def block_layout(spec: PartitionSpec, ndim: int, mesh: Mesh) -> dict:
    """{block index: the distinct devices of the grid positions holding
    it, in grid order}. Cached: callers must not change it."""
    out: dict = {}
    for pos in np.ndindex(*mesh.devices.shape):
        devs = out.setdefault(position_index(spec, ndim, mesh, pos), [])
        if mesh.devices[pos] not in devs:
            devs.append(mesh.devices[pos])
    return out


class ShardedArray:
    """An array of ``shape`` split over ``mesh`` by the fitted ``spec``:
    ``blocks`` maps each block index to its copies, one on each distinct
    device of the grid positions that hold it ({str(device): tensor}).
    Positions that share a device share its copy (a device repeated in the
    mesh holds one copy of a block, not one a position). The first copy is
    the block's ``home``: the math on a block runs there and its result is
    copied to the other devices that hold it."""

    __slots__ = ("shape", "dtype", "spec", "mesh", "blocks")

    def __init__(self, shape, dtype, spec: PartitionSpec, mesh: Mesh, blocks: dict):
        self.shape, self.dtype, self.spec, self.mesh = tuple(shape), dtype, spec, mesh
        self.blocks = blocks

    @classmethod
    def from_homes(cls, shape, dtype, spec, mesh, homes: dict) -> "ShardedArray":
        """From each block index's tensor (on any device), copied to every
        device that holds the block."""
        lay = block_layout(spec, len(shape), mesh)
        blocks = {}
        for idx, devs in lay.items():
            t = homes[idx]
            blocks[idx] = {str(d): t.to(d) for d in devs}
        return cls(shape, dtype, spec, mesh, blocks)

    @property
    def parts(self) -> tuple:
        return spec_parts(self.spec, len(self.shape), self.mesh)

    @property
    def block_shape(self) -> tuple:
        return tuple(n // p for n, p in zip(self.shape, self.parts))

    def home(self, idx) -> torch.Tensor:
        return next(iter(self.blocks[idx].values()))

    def homes(self) -> dict:
        return {idx: self.home(idx) for idx in self.blocks}

    def at(self, pos: tuple) -> torch.Tensor:
        """The block grid position ``pos`` holds, on its device."""
        idx = position_index(self.spec, len(self.shape), self.mesh, pos)
        return self.blocks[idx][str(self.mesh.devices[pos])]

    def map(self, fn, *others: "ShardedArray") -> "ShardedArray":
        """``fn`` over the home blocks of this and ``others`` (arrays of one
        layout), block by block."""
        homes = {idx: fn(t, *(o.home(idx) for o in others)) for idx, t in self.homes().items()}
        return ShardedArray.from_homes(self.shape, next(iter(homes.values())).dtype,
                                       self.spec, self.mesh, homes)


def shard_array(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> ShardedArray:
    """``x`` split by ``spec`` (fitted to its shape) into blocks, each
    copied to the devices that hold it."""
    lay = block_layout(spec, x.ndim, mesh)
    parts = spec_parts(spec, x.ndim, mesh)
    size = [n // p for n, p in zip(x.shape, parts)]
    blocks = {}
    for idx, devs in lay.items():
        blk = x[tuple(slice(i * s, (i + 1) * s) for i, s in zip(idx, size))]
        blocks[idx] = {str(d): blk.to(d, copy=True) for d in devs}
    return ShardedArray(x.shape, x.dtype, spec, mesh, blocks)


def gather_array(a: ShardedArray, device) -> torch.Tensor:
    """The whole array on ``device``, assembled from its blocks (the copy
    already on ``device`` where there is one)."""
    key = str(canonical_device(device))
    parts = a.parts

    def block(idx):
        copies = a.blocks[idx]
        return copies[key] if key in copies else next(iter(copies.values())).to(device)

    def cat(prefix: tuple) -> torch.Tensor:
        d = len(prefix)
        if d == len(parts):
            return block(prefix)
        if parts[d] == 1:
            return cat(prefix + (0,))
        return torch.cat([cat(prefix + (i,)) for i in range(parts[d])], dim=d)

    out = cat(())
    return out.clone() if all(p == 1 for p in parts) and str(out.device) == key else out
