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

Run as a script (or through ``compare``, as ``chip_smoke.py --against``
does), it compiles every source of this checkout (and, with ``--against
DIR``, of another checkout of the repository at DIR, with the same flags;
one nvcc per source, a tree's all started together) and prints nvcc's time
per source, ptxas's report of each kernel (registers, spills, shared
memory), and whether the two builds' reports of each kernel they share are
identical:

    PYTHONPATH=src python -m repro_torch.kernels.build [--against DIR] [--out FILE]
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
BUILD_LOGS: dict[str, str] = {}  # nvcc's output (ptxas register/smem report)
BUILD_SECONDS: dict[str, float] = {}  # nvcc's wall time


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def _target(source: Path, out_dir: Path) -> Path:
    kernels_dir = source.parents[2]  # <kernels>/<family>/csrc/<name>.cu
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(kernels_dir.glob("*/csrc/*.cu*")):  # sources and headers
        h.update(str(f.relative_to(kernels_dir)).encode())
        h.update(f.read_bytes())
    return out_dir / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: list[Path], out_dir: Path = BUILD_DIR) -> list[Path]:
    """Compile every source not yet built in ``out_dir``, one ``nvcc``
    process each, all started together; each one's output goes to
    ``BUILD_LOGS`` and its wall time to ``BUILD_SECONDS``, by source stem.
    Returns the library paths in source order."""
    targets = [_target(s, out_dir) for s in sources]
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs, seen = [], set()
    for src, tgt in zip(sources, targets):
        if tgt.exists() or tgt in seen:  # built, or named twice
            continue
        seen.add(tgt)
        jobs.append((src, tgt, tgt.with_suffix(f".{os.getpid()}.tmp")))

    def nvcc(job):
        src, _, tmp = job
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as pool:
        done = list(pool.map(nvcc, jobs))
    failed = []
    for (src, tgt, tmp), (proc, seconds) in zip(jobs, done):
        BUILD_LOGS[src.stem], BUILD_SECONDS[src.stem] = proc.stdout, seconds
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{proc.stdout}")
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


def ptxas_report(log: str) -> dict[str, list[str]]:
    """ptxas's lines about each entry function of one nvcc log, by its
    (mangled) name."""
    report, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            report[cur] = []
        elif cur and ("registers" in line or "spill" in line or "stack frame" in line):
            report[cur].append(line.split(":", 1)[-1].strip() if "ptxas" in line
                               else line.strip())
    return report


def reports(sources: list[Path], kernels_dir: Path = KERNELS_DIR) -> dict | None:
    """The ptxas report of each source that this process built (its
    ``BUILD_LOGS``), by source path, with nvcc's wall time under
    ``"nvcc s"``; None if one of them was not built here."""
    if not all(src.stem in BUILD_LOGS for src in sources):
        return None
    return {str(src.relative_to(kernels_dir.parent)): {
        "nvcc s": [f"{BUILD_SECONDS[src.stem]:.1f}"], **ptxas_report(BUILD_LOGS[src.stem])}
        for src in sources}


def _reports(kernels_dir: Path, out_dir: Path) -> dict[str, dict[str, list[str]]]:
    """Build every source under ``kernels_dir`` afresh into ``out_dir`` and
    return ``reports`` of them."""
    sources = sorted(kernels_dir.glob("*/csrc/*.cu"))
    BUILD_LOGS.clear()
    build(sources, out_dir)
    return reports(sources, kernels_dir)


def compare(against: str | None, mine: dict | None = None) -> dict:
    """Build every source of this checkout (unless ``mine`` holds their
    ``reports`` already), and of the checkout at ``against`` if given,
    afresh with the same flags; returns the reports (``this``, ``against``)
    and, for each kernel both builds compile, whether its ptxas report is
    identical (``compared``)."""
    with tempfile.TemporaryDirectory() as mine_dir, tempfile.TemporaryDirectory() as other_dir:
        mine = mine or _reports(KERNELS_DIR, Path(mine_dir))
        other = {}
        if against:
            other = _reports(Path(against) / "src" / "repro_torch" / "kernels",
                             Path(other_dir))
    compared = {f"{src} {name}": other[src][name] == lines
                for src, kernels in mine.items() for name, lines in kernels.items()
                if name != "nvcc s" and name in other.get(src, {})}
    return {"this": mine, "against": other, "compared": compared}


def verdict(result: dict) -> str:
    """One line: how many kernels both builds compile, and how many of
    their ptxas reports are identical."""
    same = result["compared"]
    return (f"ptxas: {sum(same.values())} of {len(same)} kernels that both builds "
            f"compile are identical")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ptxas report of the port's CUDA kernels")
    ap.add_argument("--against", default=None, help="root of another checkout to compare")
    ap.add_argument("--out", default=None, help="also write the reports as JSON here")
    args = ap.parse_args(argv)
    result = compare(args.against)
    for src, kernels in result["this"].items():
        for name, lines in kernels.items():
            print(f"ptxas {src} {name}: {'; '.join(lines)}")
            if not result["compared"].get(f"{src} {name}", True):
                print(f"  differs from {args.against}: "
                      f"{'; '.join(result['against'][src][name])}")
    if args.against:
        print(verdict(result))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
