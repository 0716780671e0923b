"""The kernel library's sources against its ctypes bindings, on the CPU.

``kernels/_build.py`` compiles ``SOURCES`` into one library and declares
the argtypes of its ``extern "C"`` entry points in ``library()``. A source
deleted, added or renamed without its bindings fails only when the
library loads on a card, or when a launcher first calls a missing entry
point. Here, with no nvcc and no card (``library()`` runs against a
recorder in place of the loaded library):

* every entry point that a listed source defines has its argtypes
  declared, and no other listed source defines it;
* every declared entry point is defined in exactly one listed source;
* every ``csrc/*.cu`` is listed, and every listed source exists.

The file imports no JAX.
"""

import ctypes
import re
import types

import pytest

from yocto_raytracing_tpu_torch.kernels import _build

ENTRY = re.compile(r'extern\s+"C"\s+[^(;{]*?\b(yrt_\w+)\s*\(')


def _defined(source: str) -> list:
    return ENTRY.findall((_build.CSRC / source).read_text())


class _Recorder:
    """Stands in for the loaded library: each attribute is a namespace
    that keeps what ``library()`` sets on it."""

    def __init__(self, path):
        self.path = path
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, types.SimpleNamespace())


@pytest.fixture(scope="module")
def declared():
    """{entry point: argtypes} as ``_build.library()`` declares them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "_lib", None)
        mp.setattr(_build, "build",
                   lambda: _build.BuildInfo(_build.BUILD_DIR / "none.so",
                                            0.0, ""))
        mp.setattr(ctypes, "CDLL", _Recorder)
        lib = _build.library()
    assert isinstance(lib, _Recorder)
    return {name: ns.argtypes for name, ns in lib.entries.items()
            if hasattr(ns, "argtypes")}


@pytest.mark.parametrize("source", _build.SOURCES)
def test_source_entry_points_are_declared(declared, source):
    names = _defined(source)
    assert names, f"{source} defines no entry point"
    assert len(set(names)) == len(names), names
    for name in names:
        assert name in declared, f"{source}: {name} has no argtypes"
        assert isinstance(declared[name], list), name
    others = {n for s in _build.SOURCES if s != source for n in _defined(s)}
    assert not others & set(names), sorted(others & set(names))


def test_declared_entry_points_are_defined_once(declared):
    counts = {}
    for source in _build.SOURCES:
        for name in _defined(source):
            counts[name] = counts.get(name, 0) + 1
    assert {n: counts.get(n, 0) for n in declared} == dict.fromkeys(
        declared, 1)


def test_every_cuda_source_is_listed():
    on_disk = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.SOURCES) == on_disk
    assert len(set(_build.SOURCES)) == len(_build.SOURCES)
    for header in _build.HEADERS:
        assert (_build.CSRC / header).is_file(), header
