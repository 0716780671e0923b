"""The SASS of K13 and its first form, read for how their loads and stores
interleave (on the machine with the card; needs nvcc and cuobjdump).

    python3 records_sass.py [--out PATH]

Builds the package's kernel library (``kernels._build``), runs
``cuobjdump -sass`` on it and, for each record-packing kernel
(``records.cu``'s ``records_kernel`` and ``records_empty_kernel``,
``records_simple.cu``'s ``simple::records_kernel``), prints its
instructions, its global loads (LDG) and stores (STG), and how often a load
comes after a store in the code ("load after store"): a store that the
compiler cannot move past the next load (pointers that may alias) makes
that load wait for it, so a row copied word by word through such pointers
shows one for nearly every word. Also the registers ptxas gave each. The
kernels' SASS goes to ``--out`` (by default ``records_sass.txt`` in the
package's git-ignored build directory). Nothing is launched.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess

import chip_smoke as cs


def summary(lines) -> dict:
    """Instructions, LDG, STG and loads that follow a store, of one
    function's SASS lines."""
    ops = [m.group(1) for m in (re.match(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                                         r"([A-Z0-9_.]+)", line)
                                for line in lines) if m]
    loads = [i for i, op in enumerate(ops) if op.startswith("LDG")]
    stores = [i for i, op in enumerate(ops) if op.startswith("STG")]
    after, seen_store = 0, False
    for op in ops:
        if op.startswith("STG"):
            seen_store = True
        elif op.startswith("LDG") and seen_store:
            after += 1
            seen_store = False
    return dict(instructions=len(ops), ldg=len(loads), stg=len(stores),
                load_after_store=after,
                loads_before_first_store=sum(i < stores[0] for i in loads)
                if stores else len(loads))


def main() -> None:
    from yocto_raytracing_tpu_torch.kernels import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    info = _build.build()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(info.path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = {k: v for k, v in cs.sass_functions(text).items()
             if "records" in k}
    if len(funcs) != 3:
        raise SystemExit(f"records_sass: {len(funcs)} record kernels in the "
                         f"library's SASS, not 3: {sorted(funcs)}")
    out = args.out or str(_build.BUILD_DIR / "records_sass.txt")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        for name, lines in funcs.items():
            f.write(f"Function : {name}\n" + "\n".join(lines) + "\n\n")
    for name, lines in funcs.items():
        s = summary(lines)
        cs.log(f"SASS {name}: {s['instructions']} instructions, "
               f"{s['ldg']} LDG, {s['stg']} STG, "
               f"{s['loads_before_first_store']} loads before the first "
               f"store, {s['load_after_store']} loads after a store")
    entry = ""
    for line in info.log.splitlines():   # ptxas -v: an entry, then its use
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif "records" in entry and "Used" in line:
            cs.log(f"ptxas {entry}: {line.split(':', 1)[1].strip()}")
    cs.log(f"SASS written to {out}")


if __name__ == "__main__":
    main()
