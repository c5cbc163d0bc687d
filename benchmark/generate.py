"""Write one cell's inputs from its seed, in a process of their own, so
that the memory the generator takes does not reach the peak that the run
reads of the process that runs the port.

    python -m benchmark.generate --workload NAME --seed N --out DIR
        [--threads T]

Prints one JSON line: {"folders": {group: folder}, "files": n,
"bytes": total size}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from benchmark.core import manifest


def tree_bytes(folder: str):
    """(files, bytes) under ``folder``."""
    n = size = 0
    for dirpath, _, files in os.walk(folder):
        for f in files:
            n += 1
            size += os.path.getsize(os.path.join(dirpath, f))
    return n, size


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--root", default=manifest.ROOT)
    a = ap.parse_args(argv)
    m = manifest.load(a.root)
    w = manifest.cell(m, a.workload)
    cfg = manifest.config(m, w["config"], a.root)
    traffic = manifest.traffic(w["traffic"], a.root)
    gen = manifest.generator(traffic["generator"])
    folders = gen.write(cfg, traffic, a.seed, a.out, a.threads)
    files, size = tree_bytes(a.out)
    print(json.dumps({"folders": folders, "files": files, "bytes": size}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
