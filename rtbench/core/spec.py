"""What a run measures, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, a traffic mix
and the chips it needs. Everything that belongs to one item sits in files
of its own, found by its name:

* ``rtbench/configs/<config>.json``: the configuration as it is run (the
  scene's generator and its sizes, the render settings);
* ``rtbench/traffic/<traffic>.json``: the mix's parameters; its ``kind``
  names the driver, ``rtbench/drive/<kind>.py``;
* ``rtbench/limits/<cell>.json``: the limit of each number that decides
  ``correct``;
* ``rtbench/metrics/<metric>.py``: the reader of a per-layer metric.

So a new cell, mix or per-layer metric is new files and new entries of
``BENCHMARK.json``, never an edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file: names may hold dots
    (``metrics/k1_roofline.frame.py``), which ``import`` cannot take."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # rtbench/configs/<config>.json
    traffic: dict         # rtbench/traffic/<traffic>.json
    limits: dict          # rtbench/limits/<cell>.json
    end_to_end: list      # BENCHMARK.json's end-to-end metrics of the cell
    per_layer: list       # its per-layer metrics

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def driver(self):
        """The module that drives the cell's kind of traffic."""
        return load_module(BENCH / "drive" / f"{self.kind}.py",
                           f"rtbench_drive_{self.kind}")


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(workload: str, bench_file: Path | None = None) -> Cell:
    """The cell named ``workload`` with everything it reads."""
    bench = load_json(bench_file or ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(
        name=workload, chips=int(entry["chips"]),
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{workload}.json"),
        end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``read(trace) -> float |
    None`` (None where it finds nothing to read)."""
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "rtbench_metric_" + name.replace(".", "_"))
