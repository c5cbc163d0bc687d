"""Time the CUDA kernels of two checkouts of the repository on one card.

    python3 nanomod_tpu_torch/kernels/ab_time.py DIR_A DIR_B [--json OUT]

DIR_A and DIR_B are roots of checkouts, for example an unpacked ``git
archive`` of a parent commit and the working tree.  They run alternately,
A, B, B, A, each in its own process with its checkout first on sys.path, so
that each builds and loads its own kernels.  Every kernel runs on the same
seeded inputs in both, at the main path's shapes: K1 ``banded_sw`` and K2
``walk`` at B 256, M 1024, W 128 (reads are their reference window with 5 %
substitutions; the walk's time is that of the packed codes, so a checkout
whose walk writes unpacked codes is timed with ``pack_codes2`` after it);
K3 ``battery`` on a 16,384 x 128 int16 tile, counts 30..100; K6
``capped_ks`` on 976 x 512 int16 pools, counts 400..512, cov 200, R 100.

Two yardsticks, each the median of 3 samples after a warm-up: single
launches (one call between two CUDA events, so the host's launch overhead
counts) and 10-launch means (10 calls back to back between two events,
divided by 10).  The outputs' digests must agree between the checkouts.
Prints the card's name and power limit, one JSON line a run, then the
times per checkout and kernel.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

B, M, W = 256, 1024, 128
K3_P, K3_CAP = 16384, 128
K6_P, K6_CAP = 976, 512
K6_KW = dict(cov=200, repeats=100, quantile_idx=25, seed=0)


def _inputs():
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 4, (B, M + W)).astype(np.uint8)
    read = ref[:, W // 2: W // 2 + M].copy()
    sub = rng.random((B, M)) < 0.05
    read[sub] = rng.integers(0, 4, int(sub.sum()))
    k3 = [(rng.integers(-40, 41, (K3_P, K3_CAP)) * 25).astype(np.int16),
          rng.integers(30, 101, K3_P).astype(np.int32),
          (rng.integers(-40, 41, (K3_P, K3_CAP)) * 25).astype(np.int16),
          rng.integers(30, 101, K3_P).astype(np.int32)]
    k6 = [(rng.integers(-30, 31, (K6_P, K6_CAP)) * 25).astype(np.int16),
          rng.integers(400, K6_CAP + 1, K6_P).astype(np.int32),
          (rng.integers(-30, 31, (K6_P, K6_CAP)) * 25).astype(np.int16),
          rng.integers(400, K6_CAP + 1, K6_P).astype(np.int32),
          np.arange(K6_P, dtype=np.int32)]
    return [read, ref, np.full(B, M, np.int32)], k3, k6


def _time_ms(torch, fn, n):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / n)
    return float(np.median(ts))


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(root):
    """Time the kernels of the checkout at ``root``; prints one JSON line."""
    sys.path[0] = root
    import torch
    from nanomod_tpu_torch.resquiggle import banded
    from nanomod_tpu_torch.resquiggle.banded_kernel import banded_sw_cuda
    from nanomod_tpu_torch.stats import kernels
    dev = torch.device("cuda", 0)
    dp, k3, k6 = ([torch.from_numpy(x).to(dev) for x in group]
                  for group in _inputs())
    tb, best, bi, bk = banded_sw_cuda(*dp)
    if hasattr(banded, "walk_packed_cuda"):
        def walk():
            return banded.walk_packed_cuda(tb, bi, bk)
    else:
        def walk():
            return banded.pack_codes2(banded.walk_cuda(tb, bi, bk))
    fns = {
        "banded_sw": lambda: banded_sw_cuda(*dp),
        "walk": walk,
        "battery": lambda: kernels.battery_rows_cuda(*k3, milli=True),
        "capped_ks": lambda: kernels.capped_ks_d_cuda(*k6, **K6_KW),
    }
    outs = {"banded_sw": [tb, best, bi, bk], "walk": [walk()],
            "battery": [fns["battery"]()], "capped_ks": [fns["capped_ks"]()]}
    res = {"root": root}
    for name, fn in fns.items():
        res[name] = {"single_ms": _time_ms(torch, fn, 1),
                     "mean10_ms": _time_ms(torch, fn, 10),
                     "digest": _digest(outs[name])}
    print(json.dumps(res), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--json", help="write every run's times here")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(os.path.abspath(args.dir_a))
        return 0
    roots = [os.path.abspath(args.dir_a), os.path.abspath(args.dir_b)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print("card:", card, flush=True)
    runs = []
    for root in (roots[0], roots[1], roots[1], roots[0]):
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, root,
             "--worker"], cwd=root, env=env, capture_output=True, text=True,
            timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"{root} failed:\n{out.stdout}\n{out.stderr}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for name in ("banded_sw", "walk", "battery", "capped_ks"):
        digests = {r[name]["digest"] for r in runs}
        if len(digests) != 1:
            raise AssertionError(f"{name}: outputs differ between the "
                                 f"checkouts: {digests}")
        for label, root in zip("AB", roots):
            times = [r[name] for r in runs if r["root"] == root]
            print(f"{name} {label}: single "
                  f"{[t['single_ms'] for t in times]} ms, 10-launch mean "
                  f"{[t['mean10_ms'] for t in times]} ms", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
