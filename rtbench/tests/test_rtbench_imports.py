"""Nothing the harness loads is JAX or the JAX package (whole top-level
names: the port's name begins with the JAX package's), and a run without a
card exits without a result."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "rtbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "yocto_raytracing_tpu"}


def _imported_top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    assert not FORBIDDEN & set(_imported_top_names(path))


def test_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "ref").rglob("*.py")):
        names = set(_imported_top_names(path))
        assert "yocto_raytracing_tpu_torch" not in names, path


def test_a_run_loads_no_jax():
    """Every module of the harness loaded and a small frame run on the CPU,
    in a fresh process: no forbidden module in ``sys.modules``."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
from rtbench.core import common, runner, spec
for kind in ("frames", "steps", "queries"):
    spec.load_module(spec.BENCH / "drive" / (kind + ".py"), "d_" + kind)
for path in sorted((spec.BENCH / "metrics").glob("*.py")):
    spec.metric_reader(path.stem)
cell = spec.cell("lines.frame")
runner.run_cell(cell, 5, 0.01, False, "cpu", time.time(),
                dict(resolution=16, samples=1, keep_frames=1,
                     check_pixels=8, warm_hits=0))
print(common.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_names():
    code = f"""
import sys, types
sys.path.insert(0, {str(ROOT)!r})
from rtbench.core import common
import yocto_raytracing_tpu_torch
assert common.forbidden_modules() == [], common.forbidden_modules()
sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
sys.modules["yocto_raytracing_tpu.scene"] = types.ModuleType("x")
print(common.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['jax.numpy', 'yocto_raytracing_tpu.scene']"


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "lines.frame",
         "--seed", "3000000017", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
