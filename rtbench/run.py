"""Run one cell of the benchmark once and print its result line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic and its limits come from
``BENCHMARK.json`` and the files it names (``rtbench/core/spec.py``). The
run needs as many CUDA cards as the cell asks for and measures on them
alone: without them it exits with code 2 and prints no result. It sets
up, warms up, measures for ``--seconds`` and checks the window's answers
against the plain reference; with ``--trace 1`` it also profiles a
window of requests and prints the cell's per-layer metrics instead of its
end-to-end ones. The last line of standard output is the result, one
JSON object; the last lines of standard error are the numbers compared,
each beside its limit. It exits with code 3 and prints no result if JAX
or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rtbench.core import common  # noqa: E402  (the process's start first)

T_START = common.process_start()


def _finite(x):
    return x if isinstance(x, (int, str)) or math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from rtbench.core import runner, spec

    torch_s = time.time() - T_START
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"rtbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible; no result",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.set_num_threads(1)     # one process, few threads: a steadier host
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T_START)
    found = common.forbidden_modules()
    if found:
        print(f"rtbench: the process loaded {found}; no result",
              file=sys.stderr)
        return 3
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=cell.chips, power_limit=common.power_limit())
    line = runner.result(cell, out, bool(args.trace), info)
    for name, c in line["compared"].items():
        c["value"] = _finite(c["value"])
    sys.stdout.flush()
    print(f"rtbench: {args.workload} seed {args.seed} on {info['kind']} "
          f"(count {torch.cuda.device_count()}, power limit "
          f"{info['power_limit']})", file=sys.stderr)
    notes = dict(out.notes, torch_imported_s=torch_s)
    print("rtbench: notes " + json.dumps(notes, default=str), file=sys.stderr)
    for name, (value, limit) in out.compared.items():
        print(f"rtbench: {name} {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
