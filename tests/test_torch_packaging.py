"""The port's CUDA sources ship with its package: every file under
``src/repro_torch/kernels/*/csrc/`` matches a package-data glob of its
package in ``pyproject.toml``, and every ``#include "..."`` in those sources
resolves to such a file. An installed port builds its kernels from these
files with nvcc on first use, so a source left out of the package data is a
kernel that an installed port cannot build. (Read from ``pyproject.toml``;
no wheel is built, which would write ``build/`` into the checkout.)"""
import fnmatch
import re
import tomllib
from pathlib import Path, PurePosixPath

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
SOURCES = sorted((SRC / "repro_torch" / "kernels").glob("*/csrc/*"))
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _package_data() -> dict[str, list[str]]:
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    return cfg["tool"]["setuptools"]["package-data"]


def _glob_matches(rel: PurePosixPath, pattern: str) -> bool:
    """setuptools' package-data glob: each path part against its pattern
    part (``*`` does not cross a ``/``)."""
    parts = PurePosixPath(pattern).parts
    return len(parts) == len(rel.parts) and all(
        fnmatch.fnmatchcase(p, g) for p, g in zip(rel.parts, parts))


def _packaged(path: Path) -> bool:
    """Whether ``path`` lies in a package (a directory with ``__init__.py``)
    whose package-data globs match it, with no package between the two."""
    for pkg, globs in _package_data().items():
        pkg_dir = SRC.joinpath(*pkg.split("."))
        if not (pkg_dir / "__init__.py").exists() or not path.is_relative_to(pkg_dir):
            continue
        rel = PurePosixPath(path.relative_to(pkg_dir).as_posix())
        if any((pkg_dir / sub / "__init__.py").exists() for sub in rel.parents if str(sub) != "."):
            continue  # a subpackage owns it
        if any(_glob_matches(rel, g) for g in globs):
            return True
    return False


def test_the_kernels_have_sources():
    assert len([s for s in SOURCES if s.suffix == ".cu"]) >= 10


@pytest.mark.parametrize("source", SOURCES, ids=lambda s: str(s.relative_to(SRC)))
def test_cuda_source_is_package_data(source):
    assert _packaged(source), (
        f"{source.relative_to(ROOT)} is not in pyproject.toml's package data")


@pytest.mark.parametrize("source", SOURCES, ids=lambda s: str(s.relative_to(SRC)))
def test_cuda_includes_resolve_to_package_data(source):
    for name in INCLUDE.findall(source.read_text()):
        target = (source.parent / name).resolve()
        assert target.exists(), f"{source.name} includes {name}, which does not exist"
        assert _packaged(target), f"{source.name} includes {name}, which is not package data"
