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
``walk_header``, the DP batch's rows as the host fetches them (K2 with the
12-byte header where K2 writes it, else the walk and ``pack_outputs``);
K1's wide kernel at B 256, M 1024, W 1025, 2048 and 4096 and at B 64,
M 4096, W 2048 (``banded_sw_w*``, ``banded_sw_b64_m4096_w2048``), and
where its launch plan depends on the batch (``K1_BATCH``: W 512 at B 64,
M 4096 and at B 8, M 1024; W 449 and 3072 at B 64, M 1024; W 4096 at B
64, M 4096); the walk at W 130 (unpacked codes), 1025,
2048 and 4096 (the windowed walk) at B 256, M 1024, and at B 64, M 4096,
W 2048 and 4096 (``walk_b64_m4096_w*``);
K3 ``battery`` on a 16,384 x 128 int16 tile, counts 30..100,
``battery_f32`` on the same shape in f32 (rank rows only) and
``battery_deep`` on a 512 x 1,024 int16 tile at 645 + 645; K6
``capped_ks`` on an input like the capped detect's: 976 x 512 int16 pools,
cov 200, R 100, eight distinct values a group and row (the smoke data's
eight reads a strand, each copied 64 times), counts 400..512 in about
96 % of the rows (capped) and 100..200 in the others (not capped); K7
``stencil``, the whole sharded stencil step (``sharded_stencil``: the
halo exchange and every shard's stencil) of 1,048,576 positions in 4
shards on the card, k 2, cov 200; K9 ``accumulate`` at a genome of
4,641,652 positions and 2^22 events, 10 % not ok, at uniform positions,
and ``accumulate_read_major`` at 4,096 reads of 1,024 consecutive
positions (one or two events a base) starting uniformly over the genome,
as distributed_detect_step gets them (their digests cover the counts,
since the f32 sums depend on the order of the atomics).  A checkout
without a kernel skips it.

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
# K1's wide kernel (a block of warps a read): (name, B, M, W); and the walk
# at the other band widths of the main-path bucket (unpacked codes at 130,
# the windowed walk at 2048)
K1_WIDE = (("banded_sw_w1025", 256, 1024, 1025),
           ("banded_sw_w2048", 256, 1024, 2048),
           ("banded_sw_w4096", 256, 1024, 4096),
           ("banded_sw_b64_m4096_w2048", 64, 4096, 2048))
# K1 where the launch plan depends on the batch as well as the band width
K1_BATCH = (("banded_sw_b64_m4096_w512", 64, 4096, 512),
            ("banded_sw_b8_w512", 8, 1024, 512),
            ("banded_sw_b64_w449", 64, 1024, 449),
            ("banded_sw_b64_w3072", 64, 1024, 3072),
            ("banded_sw_b64_m4096_w4096", 64, 4096, 4096))
WALK_WIDTHS = (("walk_w130", 256, 1024, 130), ("walk_w1025", 256, 1024, 1025),
               ("walk_w2048", 256, 1024, 2048),
               ("walk_w4096", 256, 1024, 4096),
               ("walk_b64_m4096_w2048", 64, 4096, 2048),
               ("walk_b64_m4096_w4096", 64, 4096, 4096))
K3_P, K3_CAP = 16384, 128
K3_DEEP_P, K3_DEEP_CAP = 512, 1024
K6_P, K6_CAP = 976, 512
K6_KW = dict(cov=200, repeats=100, quantile_idx=25, seed=0)
K6_LEVELS = 8         # distinct values a group and row
K6_CAPPED = 0.96      # share of capped rows
KERNELS = (("banded_sw",) + tuple(k[0] for k in K1_WIDE + K1_BATCH)
           + ("walk", "walk_header") + tuple(k[0] for k in WALK_WIDTHS)
           + ("battery", "battery_f32", "battery_deep", "capped_ks",
              "stencil", "accumulate", "accumulate_read_major"))
K7_P, K7_SHARDS, K7_K, K7_COV = 1 << 20, 4, 2, 200
K9_G, K9_EVENTS, K9_READ_LEN = 4_641_652, 1 << 22, 1024


def _dp_inputs(rng, b, m, w):
    ref = rng.integers(0, 4, (b, m + w)).astype(np.uint8)
    read = ref[:, w // 2: w // 2 + m].copy()
    sub = rng.random((b, m)) < 0.05
    read[sub] = rng.integers(0, 4, int(sub.sum()))
    return [read, ref, np.full(b, m, np.int32)]


def _inputs():
    rng = np.random.default_rng(0)
    read, ref, _ = _dp_inputs(rng, B, M, W)
    k3 = [(rng.integers(-40, 41, (K3_P, K3_CAP)) * 25).astype(np.int16),
          rng.integers(30, 101, K3_P).astype(np.int32),
          (rng.integers(-40, 41, (K3_P, K3_CAP)) * 25).astype(np.int16),
          rng.integers(30, 101, K3_P).astype(np.int32)]
    k3_f32 = [k3[0].astype(np.float32) / np.float32(1000), k3[1],
              k3[2].astype(np.float32) / np.float32(1000), k3[3]]
    k3_deep = [(rng.integers(-8, 9, (K3_DEEP_P, K3_DEEP_CAP)) * 125
                ).astype(np.int16), np.full(K3_DEEP_P, 645, np.int32),
               (rng.integers(-8, 9, (K3_DEEP_P, K3_DEEP_CAP)) * 125
                ).astype(np.int16), np.full(K3_DEEP_P, 645, np.int32)]
    k6 = []
    capped = rng.random(K6_P) < K6_CAPPED
    for _ in range(2):
        levels = rng.integers(-400, 401, (K6_P, K6_LEVELS)) * 5
        pick = rng.integers(0, K6_LEVELS, (K6_P, K6_CAP))
        counts = np.where(capped,
                          rng.integers(400, K6_CAP + 1, K6_P),
                          rng.integers(100, K6_KW["cov"] + 1, K6_P))
        k6 += [np.take_along_axis(levels, pick, 1).astype(np.int16),
               counts.astype(np.int32)]
    k6.append(np.arange(K6_P, dtype=np.int32))
    k7 = [rng.integers(0, 1 << 20, K7_P), rng.integers(0, 1 << 20, K7_P),
          rng.integers(1, 2 * K7_COV + 1, K7_P),
          rng.integers(1, 2 * K7_COV + 1, K7_P),
          np.cumsum(rng.integers(1, 3, K7_P))]
    k7 = [x.astype(np.int32) for x in k7] + [np.arange(K7_P) < K7_P - 1000]
    k9 = [rng.integers(0, K9_G, K9_EVENTS).astype(np.int32),
          rng.normal(0, 1, K9_EVENTS).astype(np.float32),
          rng.random(K9_EVENTS) >= 0.1]
    reads = K9_EVENTS // K9_READ_LEN
    start = rng.integers(0, K9_G - K9_READ_LEN, (reads, 1))
    k9_rm = [(start + np.cumsum(rng.integers(0, 2, (reads, K9_READ_LEN)),
                                axis=1)).astype(np.int32),
             rng.normal(0, 1, (reads, K9_READ_LEN)).astype(np.float32),
             rng.random((reads, K9_READ_LEN)) >= 0.1]
    wide = [_dp_inputs(rng, b, m, w) for _, b, m, w in K1_WIDE + K1_BATCH]
    walks = [_dp_inputs(rng, b, m, w) for _, b, m, w in WALK_WIDTHS]
    return ([read, ref, np.full(B, M, np.int32)], k3, k3_f32, k3_deep, k6,
            k7, k9, k9_rm, wide, walks)


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
    dp, k3, k3_f32, k3_deep, k6, k7, k9, k9_rm, wide, walks = _inputs()
    dp, k3, k3_f32, k3_deep, k6, k7, k9, k9_rm = (
        [torch.from_numpy(x).to(dev) for x in group]
        for group in (dp, k3, k3_f32, k3_deep, k6, k7, k9, k9_rm))
    wide, walks = ([[torch.from_numpy(x).to(dev) for x in group]
                    for group in groups] for groups in (wide, walks))
    tb, best, bi, bk = banded_sw_cuda(*dp)
    if hasattr(banded, "walk"):
        def walk():
            return banded.walk(tb, bi, bk, packed=True)[0]
    elif hasattr(banded, "walk_packed_cuda"):     # PR 3 to PR 5
        def walk():
            return banded.walk_packed_cuda(tb, bi, bk)
    else:
        def walk():
            return banded.pack_codes2(banded.walk_cuda(tb, bi, bk))
    if hasattr(banded, "walk_outputs"):
        def walk_header():
            return banded.walk_outputs(tb, best, bi, bk, packed=True)[0]
    else:                          # before the header was K2's: the plain
        def walk_header():         # pack_outputs after the walk
            return banded.pack_outputs(walk(), best, bi, bk)
    fns = {
        "banded_sw": lambda: banded_sw_cuda(*dp),
        "walk": walk,
        "walk_header": walk_header,
        "battery": lambda: kernels.battery_rows_cuda(*k3, milli=True),
        "battery_f32": lambda: kernels.battery_rows_cuda(*k3_f32,
                                                         milli=False),
        "battery_deep": lambda: kernels.battery_rows_cuda(*k3_deep,
                                                          milli=True),
        "capped_ks": lambda: kernels.capped_ks_d_cuda(*k6, **K6_KW),
    }
    for (name, *_), args in zip(K1_WIDE + K1_BATCH, wide):
        fns[name] = lambda args=args: banded_sw_cuda(*args)
    for (name, *_), args in zip(WALK_WIDTHS, walks):
        out = banded_sw_cuda(*args)
        fns[name] = lambda out=out: banded.walk(out[0], out[2], out[3])[0]
    try:
        from nanomod_tpu_torch.parallel import mesh, sharded
    except ImportError:            # a checkout from before K7 and K9
        mesh = sharded = None
    if sharded is not None:
        length = K7_P // K7_SHARDS
        shards = [tuple(x[s * length:(s + 1) * length] for x in k7)
                  for s in range(K7_SHARDS)]
        fns["stencil"] = lambda: sharded.sharded_stencil(shards, K7_K,
                                                         K7_COV)
        fns["accumulate"] = lambda: mesh.accumulate_cuda(*k9, K9_G)
        fns["accumulate_read_major"] = lambda: mesh.accumulate_cuda(
            *k9_rm, K9_G)
    outs = {}
    for name, fn in fns.items():
        out = fn()
        if name == "stencil":                  # a tuple a shard
            out = tuple(t for shard in out for t in shard)
        outs[name] = list(out) if isinstance(out, tuple) else [out]
    outs["banded_sw"] = [tb, best, bi, bk]
    for name in ("accumulate", "accumulate_read_major"):
        if name in outs:
            outs[name] = outs[name][:1]        # the counts
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
    for name in KERNELS:
        if any(name not in r for r in runs):
            print(f"{name}: not in every checkout, skipped", flush=True)
            continue
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
