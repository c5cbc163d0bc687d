"""Time K9 (csrc/accumulate.cu) against the binned design measured in its
place (kernels/k9_binned.cu), on one card.

    python3 nanomod_tpu_torch/kernels/k9_ab.py [--json OUT]

Both sources are built alone by nvcc (K9's flags) into their own libraries
under ``nanomod_tpu_torch/_build/k9_ab/`` and called through ctypes on the
same inputs: a genome of 4,641,652 positions (E. coli K-12's length), 2^22
events, 10 % not ok, at uniform positions and read-major (4,096 reads of
1,024 consecutive positions, one or two events a base, starting uniformly
over the genome: distributed_detect_step's shape).  A is K9 as the port
runs it (its [G, 4] accumulator zeroed, then float4 atomics); B is the
binned design (count, scatter, tile; its scratch allocated once).  They
run in turns, A B B A at each shape; each turn gives the median of 5
samples of 10 back-to-back calls (mean10) and of single calls, and one
profile of 50 calls gives the device time of each kernel (averaged over
the calls the trace holds).  Both must give
the plain version's counts exactly and its sums within rtol 1e-5, atol
1e-5.  Prints the card's name and power limit and one JSON line a shape.
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
G, EVENTS, READ_LEN = 4_641_652, 1 << 22, 1024
# the binned design's plan: slices of at most MAX_SUB positions, two tile
# blocks an SM, at most MAX_TILES tiles; chunks of whole BATCHes over at
# most BLOCKS blocks
MAX_SUB, TILE_BLOCKS_PER_SM, MAX_TILES = 8192, 2, 4096
BLOCKS, BATCH = 512, 8192


def binned_plan(n, genome_len, sms):
    """(tile_w, sub, ntiles, nblocks, chunk, scratch int32 words)."""
    wave = sms * TILE_BLOCKS_PER_SM
    waves = max(1, -(-genome_len // (wave * MAX_SUB)))
    per_tile = -(-genome_len // (wave * waves))
    sub = min(MAX_SUB, max(256, -(-per_tile // 256) * 256))
    slices = 1
    while -(-genome_len // (sub * slices)) > MAX_TILES:
        slices *= 2
    tile_w = sub * slices
    ntiles = max(1, -(-genome_len // tile_w))
    per_block = -(-n // BLOCKS)
    chunk = max(1, -(-per_block // BATCH)) * BATCH
    nblocks = max(1, -(-n // chunk))
    return tile_w, sub, ntiles, nblocks, chunk, 2 * n + 3 * ntiles + 2


def build():
    """Both libraries, built at once; returns {"A": path, "B": path}."""
    from nanomod_tpu_torch.kernels import build as kbuild
    out = os.path.join(kbuild.BUILD_DIR, "k9_ab")
    os.makedirs(out, exist_ok=True)
    srcs = {"A": os.path.join(kbuild.SRC_DIR, "accumulate.cu"),
            "B": os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "k9_binned.cu")}
    libs = {k: os.path.join(out, f"{k}.so") for k in srcs}
    runs = kbuild._run_all([[kbuild._nvcc()] + kbuild.NVCC_FLAGS
                            + ["-shared", "-o", libs[k], srcs[k]]
                            for k in srcs])
    for cmd, rc, log in runs:
        if rc:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{log}")
    return libs


def _device_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0))


def draws(seed=7):
    rng = np.random.default_rng(seed)
    uniform = (rng.integers(0, G, EVENTS).astype(np.int32),
               rng.normal(0, 1, EVENTS).astype(np.float32),
               rng.random(EVENTS) >= 0.1)
    r = EVENTS // READ_LEN
    start = rng.integers(0, G - READ_LEN, (r, 1))
    read_major = ((start + np.cumsum(rng.integers(0, 2, (r, READ_LEN)),
                                     axis=1)).astype(np.int32).ravel(),
                  rng.normal(0, 1, EVENTS).astype(np.float32),
                  rng.random(EVENTS) >= 0.1)
    return {"uniform": uniform, "read_major": read_major}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="write the results here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nanomod_tpu_torch.parallel import mesh
    if not torch.cuda.is_available():
        print("k9_ab.py needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print("card:", card, flush=True)
    libs = {k: ctypes.CDLL(p) for k, p in build().items()}
    vp, i_ = ctypes.c_void_p, ctypes.c_int
    libs["A"].nm_accumulate.argtypes = [vp, vp, vp, i_, i_, vp, vp]
    libs["B"].nm_accumulate.argtypes = [vp, vp, vp] + [i_] * 7 + [vp] * 3
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = binned_plan(EVENTS, G, sms)
    stream = torch.cuda.current_stream(dev).cuda_stream
    acc = torch.empty((G, 4), device=dev)
    out = torch.empty((3, G), device=dev)
    scratch = torch.empty(plan[-1], dtype=torch.int32, device=dev)

    def calls(pos, val, ok):
        ptrs = pos.data_ptr(), val.data_ptr(), ok.data_ptr()

        def a():
            acc.zero_()
            if libs["A"].nm_accumulate(*ptrs, EVENTS, G, acc.data_ptr(),
                                       stream):
                raise RuntimeError("K9 failed to launch")
            return acc[:, 0], acc[:, 1], acc[:, 2]

        def b():
            if libs["B"].nm_accumulate(*ptrs, EVENTS, G, *plan[:-1],
                                       scratch.data_ptr(), out.data_ptr(),
                                       stream):
                raise RuntimeError("the binned design failed to launch")
            return out.unbind(0)
        return {"A": a, "B": b}

    def time_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(n):
                fn()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) / n)
        return float(np.median(ts))

    results = {"card": card, "plan_B": dict(zip(
        ("tile_w", "sub", "ntiles", "nblocks", "chunk", "words"), plan))}
    for shape, arrays in draws().items():
        pos, val, ok = (torch.from_numpy(x).to(dev) for x in arrays)
        want = mesh.accumulate_plain(pos, val, ok, G)
        fns = calls(pos, val, ok)
        res = {}
        for k, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"{k} at {shape}: counts differ")
            for g, w in zip(got[1:], want[1:]):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
            res[k] = {"mean10_ms": [], "single_ms": []}
        for k in "ABBA":
            res[k]["mean10_ms"].append(time_ms(fns[k], 10))
            res[k]["single_ms"].append(time_ms(fns[k], 1))
        for k, fn in fns.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
            # each operation averaged over the calls the trace holds (the
            # tracer can miss some)
            res[k]["device_us"] = {
                e.key[:60]: round(_device_us(e) / e.count, 2)
                for e in prof.key_averages() if _device_us(e)}
        results[shape] = res
        print(shape, json.dumps(res), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
