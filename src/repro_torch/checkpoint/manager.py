"""Checkpoints of the port in the JAX package's on-disk layout
(``checkpoint/manager.py``), so that a checkpoint crosses between the two:

  <dir>/step_<k>/meta.msgpack        tree description, shapes, dtypes, step, user meta
  <dir>/step_<k>/leaf_<i>.npz.zst    one compressed ``np.save`` array per leaf
  <dir>/step_<k>/COMMIT              written last: a step without it is ignored

The leaves are those of ``params.ref_leaves``, ``jax.tree.flatten``'s
order, so a tree in the reference's layout writes the leaves the reference
writes for its own tree. ``train_state`` makes a training state that tree
(the reference's ``{"params", "opt"}``) and ``split_train_state`` takes it
back apart: the only place that knows the checkpoint's layout. The port compresses leaves with zlib,
which the reference's loader reads; it reads zstd leaves (the reference
writes those where ``zstandard`` is installed) only where ``zstandard``
is. bfloat16 leaves are stored as a uint16 bit view under the dtype name
``bfloat16``, as the reference stores them. The meta is packed by
``msgpack_lite`` to the bytes ``msgpack`` would give; its ``treedef`` holds
a description of the port's tree (the reference's restore checks only
``num_leaves``; the port's checks every shape too).

``save_async`` snapshots every leaf to the host, then writes on a
background thread; a step is written under a temporary name and renamed
once complete; only the newest ``keep`` complete steps are kept.
"""
from __future__ import annotations

import concurrent.futures as cf
import io
import shutil
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite
from repro_torch.params import ref_leaves, ref_unflatten, stack_blocks, unstack_blocks

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _dump_leaf(path: Path, arr: np.ndarray) -> None:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    path.write_bytes(zlib.compress(buf.getvalue(), 3))


def _load_leaf(path: Path) -> np.ndarray:
    blob = path.read_bytes()
    if blob[:4] == _ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError:
            raise RuntimeError(f"{path} is zstd-compressed but zstandard is not "
                               "installed") from None
        raw = zstandard.ZstdDecompressor().decompress(blob, max_output_size=1 << 38)
    else:
        raw = zlib.decompress(blob)
    return np.load(io.BytesIO(raw), allow_pickle=False)


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A snapshot of a leaf as numpy (a copy) and its dtype name."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    shape = a.shape  # ascontiguousarray makes a 0-d leaf 1-d
    a = np.ascontiguousarray(a)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(a.astype(np.dtype(dtype), copy=False)).reshape(shape)


def describe(tree) -> str:
    """The structure of a tree, its leaves as ``*``: the meta's treedef."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(describe(v) for v in tree)
        if hasattr(tree, "_fields"):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "None" if tree is None else "*"


def train_state(params, opt_state) -> dict:
    """A training state as a checkpoint holds it: the reference's
    ``{"params", "opt"}`` tree, the port's per-layer parameters stacked into
    (num_blocks, ...) leaves. The optimizer states already are in the
    reference's layout (``optim.optimizers``)."""
    return {"params": stack_blocks(params), "opt": opt_state}


def split_train_state(state: dict) -> tuple[Any, Any]:
    """The inverse of ``train_state``: (the port's parameters, the
    optimizer state)."""
    return unstack_blocks(state["params"]), state["opt"]


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[cf.Future] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        """Blocking save (waits for any pending async write first)."""
        self.wait()
        if step in self.all_steps():
            return  # already durably saved (e.g. by an earlier save_async)
        self._write(step, describe(tree), [_to_host(t) for t in ref_leaves(tree)],
                    extra or {})

    def save_async(self, step: int, tree: Any, extra: dict | None = None) -> None:
        """Snapshot every leaf to the host now, write in the background."""
        self.wait()
        host = [_to_host(t) for t in ref_leaves(tree)]
        self._pending = self._pool.submit(self._write, step, describe(tree), host,
                                          extra or {})

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        """Finish any pending write and stop the writer thread."""
        self.wait()
        self._pool.shutdown()

    def _write(self, step: int, treedef: str, host: list, extra: dict) -> None:
        tmp = self.dir / f".tmp_step_{step}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        meta = {
            "step": step,
            "treedef": treedef,
            "num_leaves": len(host),
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [dtype for _, dtype in host],
            "extra": extra,
        }
        for i, (arr, _) in enumerate(host):
            _dump_leaf(tmp / f"leaf_{i}.npz.zst", arr)
        (tmp / "meta.msgpack").write_bytes(msgpack_lite.packb(meta))
        (tmp / "COMMIT").write_bytes(b"ok")
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMIT").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.all_steps()
        return s[-1] if s else None

    def meta(self, step: int) -> dict:
        return msgpack_lite.unpackb((self.dir / f"step_{step}" / "meta.msgpack").read_bytes())

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like`` (a tree of tensors, or of
        anything with a shape); each leaf goes to its ``like`` leaf's device
        (the CPU for a leaf that is not a tensor)."""
        d = self.dir / f"step_{step}"
        if not (d / "COMMIT").exists():
            raise FileNotFoundError(f"incomplete checkpoint {d}")
        meta = self.meta(step)
        protos = ref_leaves(like)
        if meta["num_leaves"] != len(protos):
            raise ValueError(f"{d}: {meta['num_leaves']} leaves, the tree has {len(protos)}")
        out = []
        for i, proto in enumerate(protos):
            t = _from_host(_load_leaf(d / f"leaf_{i}.npz.zst"), meta["dtypes"][i])
            if tuple(t.shape) != tuple(proto.shape):
                raise ValueError(f"{d}: leaf {i} is {tuple(t.shape)}, the tree's "
                                 f"{tuple(proto.shape)}")
            out.append(t.to(getattr(proto, "device", "cpu")))
        return ref_unflatten(like, out)
