"""The readings that a cell's limits are set from, on the chip at the
cell's own size, several seeds in one process.

    python3 benchmark/control.py --workload NAME --seeds 1 2 3 ...
        [--seconds S] [--control-seeds N]

For each seed: the cell's inputs are written (benchmark/generate.py), the
port is set up on them and runs its warm-up unit and then whole units for
``--seconds`` (one unit at least), as a run does; then the numbers that
``correct`` compares are read twice: of the port's last outputs against
the reference (the lower readings), and, for the first ``--control-seeds``
seeds, of the reference computed in bfloat16 put in the port's place (the
control: the upper readings).  One JSON line a seed on standard output.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload: str, seed: int, seconds: float, control: bool,
             root: str = ROOT, device: str = "cuda") -> dict:
    import torch

    from benchmark import run
    from benchmark.core import manifest
    m = manifest.load(root)
    w = manifest.cell(m, workload)
    cfg = manifest.config(m, w["config"], root)
    traffic = manifest.traffic(w["traffic"], root)
    entry = manifest.entry(traffic["entry"])
    threads = len(os.sched_getaffinity(0))
    workdir = tempfile.mkdtemp(prefix="nanomod_control_")
    try:
        t0 = time.perf_counter()
        inputs = run._generate(workload, seed, os.path.join(workdir, "in"),
                               threads, root)
        ctx = SimpleNamespace(
            root=root, config=cfg, traffic=traffic, seed=seed,
            seconds=seconds, device=device, threads=threads, inputs=inputs,
            workdir=workdir, generator=manifest.generator(
                traffic["generator"]))
        state = entry.setup(ctx)
        window_s, work, _, _, unit_s = run._window(entry, state, seconds,
                                                   None, device, torch)
        entry.release(state)
        gc.collect()
        t1 = time.perf_counter()
        program, info = entry.check(state)
        out = {"seed": seed, "units": len(unit_s), "work": work,
               "run_s": t1 - t0, "program": program, "info": info,
               "check_s": time.perf_counter() - t1}
        if control:
            t2 = time.perf_counter()
            out["control"], _ = entry.check(state, control=True)
            out["control_s"] = time.perf_counter() - t2
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    a = ap.parse_args(argv)
    from benchmark import run
    run._environment(ROOT)
    for i, seed in enumerate(a.seeds):
        print(json.dumps(readings(a.workload, seed, a.seconds,
                                  i < a.control_seeds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
