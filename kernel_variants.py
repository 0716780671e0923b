"""Copies of a kernel source with a constant or a part changed, built side
by side, for the ablation scripts (``shade_bwd_ablation.py``,
``lights_ablation.py``) on an NVIDIA GPU.

* ``edited``: a source with its edits applied, each checked to be there;
* ``build``: every copy compiled at once, one nvcc each, with the package's
  flags, into a directory the caller gives (a temporary one);
* ``load``: a built copy, with the argument types of the package's library
  for the entry points named;
* ``in_package``: the package's wrappers launching a built copy for the
  length of a ``with`` block.

Nothing here changes the repository.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess


def edited(text: str, edits, what: str) -> str:
    """``text`` with each (old, new) of ``edits`` replaced; raises if an old
    text is not in it (``what`` names the copy)."""
    for old, new in edits:
        if old not in text:
            raise AssertionError(f"{what}: {old!r} not in the source")
        text = text.replace(old, new)
    return text


def build(tmp: str, sources: dict) -> dict:
    """{name: (shared library path, ptxas register and spill lines)} for
    ``sources`` {name: CUDA source text}, one nvcc each, all started
    together; the headers come from the package's ``csrc``."""
    from yocto_raytracing_tpu_torch.kernels import _build

    procs = {}
    for name, text in sources.items():
        src = os.path.join(tmp, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(tmp, f"lib{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
               str(_build.CSRC), "-o", so, src]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    try:
        for name, (so, proc) in procs.items():
            log, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {name} failed:\n{log}")
            out[name] = (so, [ln.strip() for ln in log.splitlines()
                              if "registers" in ln or "spill" in ln])
    finally:
        for _, proc in procs.values():   # stop every compiler on the way out
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def load(so: str, names) -> ctypes.CDLL:
    """The library ``so`` with the package library's result and argument
    types on each entry point of ``names``."""
    from yocto_raytracing_tpu_torch.kernels import _build

    ref = _build.library()
    lib = ctypes.CDLL(so)
    for fn in names:
        getattr(lib, fn).restype = getattr(ref, fn).restype
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
    return lib


@contextlib.contextmanager
def in_package(lib: ctypes.CDLL):
    """Within the block the package's wrappers launch through ``lib`` (a
    ``load``ed copy that holds every entry point they call); the package's
    own library is back after it."""
    from yocto_raytracing_tpu_torch.kernels import _build

    ref = _build.library()
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = ref
