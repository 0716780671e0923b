"""The readings that a cell's limits are set from: the numbers compared in
sound runs of the program on many seeds, and the control's, in one
process on the card.

    python3 rtbench/readings.py --workload <cell> --seeds <n> \
        --first-seed <s> --seconds <s> [--control bfloat16]

Each seed runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, the comparison with the plain reference); with
``--control`` the reference computed in that dtype stands in the
program's place as well, on the same sample (and, for training steps, the
faults planted in the reference). One JSON line a seed: the numbers
compared, the window's requests, and ``correct`` as ``runner.correct``
decides it against the cell's limits, for the program and for the
control and each fault, whose numbers are under ``notes``. The limits in
``rtbench/limits/<cell>.json`` lie between the largest program reading and
the smallest control reading (PERF.md gives both).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)

    import torch

    from rtbench.core import runner, spec

    if not torch.cuda.is_available():
        print("rtbench: readings need a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    sizes = {"control": args.control} if args.control else {}
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        out = runner.run_cell(cell, seed, args.seconds, False, "cuda",
                              time.time(), sizes)
        verdicts = {k: v["correct"] for k, v in out.notes.items()
                    if isinstance(v, dict) and "correct" in v}
        print(json.dumps(dict(
            workload=args.workload, seed=seed, attempted=out.attempted,
            correct=runner.correct(out.compared), planted_correct=verdicts,
            compared={n: v for n, (v, _) in out.compared.items()},
            metrics=out.metrics, notes=out.notes), default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
