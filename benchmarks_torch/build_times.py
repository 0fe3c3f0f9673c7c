#!/usr/bin/env python3
"""Each kernel source's nvcc build time alone, for one or more trees.

    python3 benchmarks_torch/build_times.py SRC_DIR [SRC_DIR ...]

For every ``SRC_DIR`` (the ``src`` of this checkout, or of an older commit
unpacked with ``git archive``), in turn, imports that tree's
``repro_torch.kernels.build`` in a fresh interpreter and compiles each
source of its ``SOURCES`` on its own into a new directory under this
checkout's ``build/`` (removed afterwards), so nothing is cached and no
nvcc shares the host with another.  Prints
one line per (tree, source): seconds, kernels compiled, kernels that
spill.  Needs ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

SCRATCH = Path(__file__).resolve().parents[1] / "build" / "build_times"

CHILD = """
import shutil, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import build
Path(sys.argv[2]).mkdir(parents=True, exist_ok=True)
build.BUILD_DIR = Path(tempfile.mkdtemp(dir=sys.argv[2]))
for name in build.SOURCES:
    t0 = time.perf_counter()
    info = build.build_all((name,))
    kern = build.ptxas_summary(info[name]["ptxas"])
    spills = [k["kernel"] for k in kern if k["spill_stores"] or k["spill_loads"]]
    print(f"{sys.argv[1]} {name}: {time.perf_counter() - t0:.2f} s alone, "
          f"{len(kern)} kernels, {len(spills)} spill", flush=True)
shutil.rmtree(build.BUILD_DIR)
"""


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for src in sys.argv[1:]:
        rc = subprocess.run([sys.executable, "-c", CHILD, src, str(SCRATCH)]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
