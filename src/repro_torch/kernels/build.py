"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``build/repro_torch_kernels/`` at the root of the checkout, and loaded with
``ctypes``. A library's file name carries a hash of its flags and of every
CUDA source of the kernels package (a source may include another kernel
family's header), so an edited source is rebuilt and an unchanged one is
reused. Nothing here
runs at import time: this module is imported on machines with no GPU and no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
BUILD_LOGS: dict[str, str] = {}  # nvcc's output (ptxas register/smem report)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def _target(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(KERNELS_DIR.glob("*/csrc/*.cu*")):  # sources and headers
        h.update(str(f.relative_to(KERNELS_DIR)).encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: list[Path]) -> list[Path]:
    """Compile every source not yet built, one ``nvcc`` process each, all
    started together. Returns the library paths in source order."""
    targets = [_target(s) for s in sources]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seen = [], set()
    for src, tgt in zip(sources, targets):
        if tgt.exists() or tgt in seen:  # built, or named twice
            continue
        seen.add(tgt)
        tmp = tgt.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tgt, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tgt, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, tgt)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    key = str(source)
    if key not in _loaded:
        (path,) = build([source])
        _loaded[key] = ctypes.CDLL(str(path))
    return _loaded[key]


def c_function(source: Path, name: str, argtypes: list):
    """The C entry point ``name`` of one source's library (built first if
    needed), typed with ``argtypes`` and returning a CUDA error code."""
    key = (str(source), name)
    if key not in _fns:
        fn = getattr(load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]
