"""Time every candidate launch plan of K1's wide kernel on one card, beside
the library's own plan, the narrow kernel to W 1024 and, optionally,
another checkout's K1.

    python3 nanomod_tpu_torch/kernels/k1_plans.py [--parent DIR] [--json OUT]
                                                  [--crossover | --batches]

``kernels/k1_plans.cu`` (which includes ``csrc/banded_sw.cu``) is built
alone by nvcc with the library's flags under
``nanomod_tpu_torch/_build/k1_plans/``; with ``--parent`` so is DIR's
``csrc/banded_sw.cu`` (for example an unpacked ``git archive`` of the
parent commit).  At each shape, B reads of M codes (windows of random
codes, the reads taken from them with 5 % substitutions, one in four
shorter than M) at band width W, every plan whose block of
ceil(W / (32 lanes)) warps fits its threads bound runs on the same
inputs, and its outputs must equal the library's (``nm_banded_sw``) and
the parent's.  Times: the median of 3 samples of 10 back-to-back
launches (mean10) and of single launches, CUDA events.  The shapes: first
the narrow/wide crossover (``CROSSOVER``: W 128-1024, where the narrow
kernel, one warp a read, runs beside every wide plan, through
``k1p_narrow`` whatever the library's edge; B 256, M 1024, B 64 at M 2048
and 4096, and B 8), then (unless ``--crossover``) B 256,
M 1024 (the main path's bucket) at W 1025, 1280, 1536, 2048, 3072
and 4096; B 64, M 4096 (``tools/bench_dp_buckets.py``) at W 2048 and 4096;
and above W 4096, where the lane arrays spill, B 16, M 512 at W 8192,
16384 and 32768.  ``--batches`` times instead the wide plans at the batch
sizes the main path launches (``BATCHES``: a DP sub-batch is a power of
two from 8 to 256, ``pipeline._fit_batch`` halves it, and a length bucket
with fewer reads launches whatever it holds) at every plan row's edges
(``BATCH_WIDTHS``), 10-launch means only: the table K1's launch plan by
band width and batch (csrc/banded_sw.cu WIDE_PLANS, FULL_BATCH) is read
from.  A plan whose outputs differ is reported, not timed, and the run
exits 1 at its end.

Also: each plan's registers and spills (ptxas) and the SASS instructions
of its row loop, a row and a cell (``sass_ab.row_loop``); and the price of
a barrier a row (``k1p_barriers``): a block barrier against a cluster
barrier of two blocks on two SMs, with and without a read of the other
block's shared memory, in SM clocks and ns a barrier; and the SM clocks of
a dependent shared-memory load (``k1p_lds_chain``: a chain of byte loads,
each at the address the last gave, as K2's walk steps).  Prints the card's
name and power limit and one JSON line a shape.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = [(256, 1024, 1025), (256, 1024, 1280),
          (256, 1024, 1536), (256, 1024, 2048), (256, 1024, 3072),
          (256, 1024, 4096),
          (64, 4096, 2048), (64, 4096, 4096), (16, 512, 8192),
          (16, 512, 16384), (16, 512, 32768)]
# the narrow/wide crossover: the narrow kernel beside every wide plan at
# B 256, M 1024 (the main path's bucket; pipeline._fit_batch keeps a full
# sub-batch of 256 at these widths), B 64 at M 2048 and 4096
# (tools/bench_dp_buckets.py's batch) and a small tail batch, B 8
CROSSOVER = [(256, 1024, w) for w in (128, 192, 256, 257, 272, 288, 320,
                                      384, 448, 512, 513, 576, 640, 704,
                                      768, 832, 896, 960, 1000, 1024)] \
    + [(64, m, w) for m in (2048, 4096)
       for w in (256, 257, 288, 320, 384, 448, 512, 513, 640, 768, 896,
                 1024)] \
    + [(8, 1024, w) for w in (256, 257, 320, 384, 512, 513, 768, 1024)]
# the batches of the main path beside the card's 132 SMs: every power of
# two from 8 to 256 and the batches around a block an SM at M 1024, and B
# 8, 64 and 256 at M 2048 and 4096 (the longer buckets); band widths either
# side of each plan row's edge; above 4096 (the spill range) M 1024 only
BATCH_WIDTHS = (257, 320, 384, 385, 448, 449, 512, 513, 640, 768, 769, 896,
                1024, 1025, 1152, 1280, 1281, 1536, 2048, 2049, 3072, 4096)
BATCHES = [(b, 1024, w) for b in (8, 16, 32, 64, 96, 128, 160, 192, 256)
           for w in BATCH_WIDTHS] \
    + [(b, m, w) for m in (2048, 4096) for b in (8, 64, 256)
       for w in BATCH_WIDTHS] \
    + [(b, 1024, w) for b in (8, 64, 256) for w in (6144, 8192, 12288,
                                                     16384)]
SCORES = (2.0, -3.0, -5.0, -2.0)   # match, mismatch, gap open, extend
BARRIER_ITERS = 4096
LDS_ITERS = 1 << 16


def build(parent=None):
    """The plans' library and, with ``parent``, the parent's K1, built at
    once; returns ({"plans": lib, ["parent": lib]}, plans object, log)."""
    from nanomod_tpu_torch.kernels import build as kbuild
    out = os.path.join(kbuild.BUILD_DIR, "k1_plans")
    os.makedirs(out, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    srcs = {"plans": os.path.join(here, "k1_plans.cu")}
    if parent:
        srcs["parent"] = os.path.join(parent, "nanomod_tpu_torch", "csrc",
                                      "banded_sw.cu")
    objs = {k: os.path.join(out, f"{k}.o") for k in srcs}
    runs = kbuild._run_all([[kbuild._nvcc()] + kbuild.NVCC_FLAGS
                            + ["-c", srcs[k], "-o", objs[k]] for k in srcs])
    for cmd, rc, log in runs:
        if rc:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{log}")
    libs = {k: os.path.join(out, f"{k}.so") for k in srcs}
    for k in srcs:
        subprocess.run([kbuild._nvcc(), "-shared", "-o", libs[k], objs[k]],
                       check=True)
    return libs, objs["plans"], runs[0][2]


def inputs(rng, b, m, w):
    ref = rng.integers(0, 4, (b, m + w)).astype(np.uint8)
    read = ref[:, w // 2: w // 2 + m].copy()
    sub = rng.random((b, m)) < 0.05
    read[sub] = rng.integers(0, 4, int(sub.sum()))
    lens = np.full(b, m, np.int32)
    lens[::4] = rng.integers(m // 2, m + 1, len(lens[::4]))
    return read, ref, lens


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout's root: its K1 too")
    ap.add_argument("--json", help="write the results here")
    ap.add_argument("--crossover", action="store_true",
                    help="only the narrow/wide crossover's shapes")
    ap.add_argument("--batches", action="store_true",
                    help="only the wide plans at the main path's batches")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from nanomod_tpu_torch.kernels import build as kbuild
    from nanomod_tpu_torch.kernels import sass_ab
    from nanomod_tpu_torch.resquiggle.banded_kernel import tb_pitch
    if not torch.cuda.is_available():
        print("k1_plans.py needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print("card:", card, flush=True)
    paths, plans_obj, log = build(args.parent)
    libs = {k: ctypes.CDLL(p) for k, p in paths.items()}
    vp, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    k1_args = [vp] * 7 + [i_] * 4 + [f_] * 4 + [vp]
    plans = libs["plans"]
    plans.k1p_launch.argtypes = [i_] + k1_args
    plans.k1p_narrow.argtypes = k1_args
    plans.k1p_plan.argtypes = [i_, vp]
    plans.k1p_barriers.argtypes = [i_, i_, i_, i_, vp, vp]
    plans.k1p_lds_chain.argtypes = [i_, vp, vp]
    lib = kbuild.lib()
    for dll in [libs.get("parent")]:
        if dll is not None:
            dll.nm_banded_sw.argtypes = k1_args
    cands = []
    for idx in range(plans.k1p_count()):
        out = (ctypes.c_int * 3)()
        plans.k1p_plan(idx, out)
        cands.append(tuple(out))
    sass = sass_ab.wide_stats(plans_obj, kbuild._nvcc(), log)
    print("sass", json.dumps(sass), flush=True)

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)

    def time_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(n):
                fn()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) / n)
        return float(np.median(ts))

    results = {"card": card, "sass": sass, "shapes": [], "differs": []}
    shapes = BATCHES if args.batches else \
        CROSSOVER + ([] if args.crossover else SHAPES)
    for b, m, w in shapes:
        read, ref, lens = (torch.from_numpy(x).to(dev)
                           for x in inputs(rng, b, m, w))
        pitch = tb_pitch(w)

        def runner(call):
            tb = torch.empty((b, m, pitch), dtype=torch.uint8, device=dev)
            outs = [torch.empty(b, dtype=t, device=dev) for t in
                    (torch.float32, torch.int32, torch.int32)]
            a = [read.data_ptr(), ref.data_ptr(), lens.data_ptr(),
                 tb.data_ptr()] + [o.data_ptr() for o in outs] + [
                b, m, w, pitch, *SCORES, stream]

            def fn():
                rc = call(*a)
                if rc:
                    raise RuntimeError(f"K1 launch failed: {rc}")
            return fn, [tb[..., :w]] + outs

        runs = {"library": runner(lib.nm_banded_sw)}
        if "parent" in libs:
            runs["parent"] = runner(libs["parent"].nm_banded_sw)
        if w <= 1024 and not args.batches:
            runs["narrow"] = runner(plans.k1p_narrow)
        if w >= 128:
            for idx, (lp, maxt, minb) in enumerate(cands):
                if 32 * -(-w // (32 * lp)) <= maxt:
                    runs[f"lp{lp}_t{maxt}_b{minb}"] = runner(
                        lambda *a, idx=idx: plans.k1p_launch(idx, *a))
        want = None
        res = {"B": b, "M": m, "W": w, "mean10_ms": {}, "single_ms": {}}
        for name, (fn, outs) in list(runs.items()):
            fn()
            torch.cuda.synchronize()
            if want is None:
                want = [o.clone() for o in outs]
            elif not all(torch.equal(x, y) for x, y in zip(outs, want)):
                # reported and not timed; the run fails at its end
                results["differs"].append(f"{name} at B {b}, M {m}, W {w}")
                del runs[name]
        for name, (fn, _) in runs.items():
            res["mean10_ms"][name] = time_ms(fn, 10)
            if not args.batches:
                res["single_ms"][name] = time_ms(fn, 1)
        del runs, want
        results["shapes"].append(res)
        print("shape", json.dumps(res), flush=True)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    barriers = {}
    for kind, name in enumerate(("block", "cluster", "cluster_remote")):
        blocks, threads = 2 * sms, 256
        clocks = torch.zeros(blocks, dtype=torch.int64, device=dev)

        def go(kind=kind, blocks=blocks, threads=threads, clocks=clocks):
            rc = plans.k1p_barriers(kind, blocks, threads, BARRIER_ITERS,
                                    clocks.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"barrier kernel failed: {rc}")
        ms = time_ms(go, 1)
        barriers[name] = {
            "clocks_a_barrier": float(clocks.double().median())
            / BARRIER_ITERS,
            "ns_a_barrier": ms * 1e6 / BARRIER_ITERS}
    results["barriers"] = barriers
    print("barriers", json.dumps(barriers), flush=True)
    clocks = torch.zeros(2, dtype=torch.int64, device=dev)
    rc = plans.k1p_lds_chain(LDS_ITERS, clocks.data_ptr(), stream)
    torch.cuda.synchronize()
    if rc:
        raise RuntimeError(f"lds chain kernel failed: {rc}")
    results["lds_chain"] = {"clocks_a_load": float(clocks[0]) / LDS_ITERS}
    print("lds_chain", json.dumps(results["lds_chain"]), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    if results["differs"]:
        print("differs from the library's K1:", results["differs"],
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
