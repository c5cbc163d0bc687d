#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (nanomod_tpu_torch) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phase 0  prints the card (nvidia-smi name and power limit), the PyTorch and
         CUDA versions; builds the CUDA kernels (nvcc, sm_90a) and the
         native host libraries from the sources in the checkout.
Phase 1  K1 (banded DP) and K2 (the traceback walk, codes packed four a
         byte) against their plain PyTorch versions on the card: B = 256
         synthetic reads (genome windows with ~5 % substitutions and
         indels, some reads shorter than their bucket, some N codes),
         W = 128, M = 1024 (the bucket of the main path's reads), 2048,
         4096, 8192; then a batch rich in ties (tandem repeats whose best
         score is reached at several cells), an all-mismatch batch (best 0
         at (0, 0)), a ragged B = 37, and W = 32 and W = 1024 at M = 256.
         tb, best, best_i, best_k and the packed walk codes must be
         array-equal.  Each kernel's time is printed beside its bound and
         the range of single launches recorded for the first kernels
         (PERF.md).
Phase 2  K3 (battery components) at detect scale: P = 1,048,576 positions
         in tiles of 16,384, counts 30..100 per group (capacity 128), int16
         milli values with heavy ties, rows with count 0 and 1, plus a tile
         at C1 = C2 = 645 and an f32 tile.  The [9, P] rows must be
         array-equal to the plain version on the card and to the native
         host battery; run_battery on the device must equal run_battery on
         the host backend.
Phase 3  the main path through its entry points: ``python -m
         nanomod_tpu_torch.cli Annotate`` on a control and a case group of
         raw FAST5s (nanomod_tpu_torch/smoke_data, each file copied 64 times:
         1,024 reads per group, so that the pipeline's DP batches are full,
         B = 256), then ``cli detect --device cuda``.  The planted site must rank first, every
         kernel's launch count (from the CLI's metrics file) must be above
         0, and the sign-test table must equal the one the native host
         battery gives on the same corrected files.
Phase 4  K6 (coverage-capped KS) against its plain version on the card: one
         tile of P = 16,384 rows, int16 milli values with heavy ties,
         counts 60..645 per group in a 1,024-column capacity, cov = 100,
         R = 100, quantile 0.25, seed 0, row index from 2^20 (the plain
         version on the first 2,048 rows); a tile of capped and uncapped
         rows (counts 0, 1, cov, cov + 1), an f32 tile and an f32 tile with
         NaN padding, whole, and a tile at cov = 700 (one group of 650-1,000
         observations, the other at most 290), whole.  Outputs must be
         array-equal, and K6's own threefry draws equal to the plain
         replica's.
Phase 5  the new entry points on phase 3's corrected groups: ``cli detect
         --coverages 200-200 --downsampling 100 --mstd 1`` (planted site
         first, K6 launched; sign-test and meanstd files byte-equal to the
         same command with NANOMOD_BATTERY_BACKEND=host), ``cli simulat2``,
         ``cli DownSampling`` and ``cli simulate`` (worker mode) writing
         their .output / .done files, then ``run_simulate`` at the smoke
         site at 0.9 with each strand as the target: in every trial one of
         the two strands ranks 1, and every trial launches K3.  The capped
         detect's rank 1 must be spel - 501, as the JAX package ranks it
         on the same data (tests/test_torch_capped_smoke.py).
Phase 6  K6 at the main path's own shapes: the capped detect again, in
         process, with K6's wrapper recording its inputs (cov = 200, the
         widths detect gives) and timing each launch with CUDA events
         inside the run; K6 against its plain version on those tensors,
         whole, both timed.  The kernels line gives K6's times at that
         input.

Kernel times are medians of 3 samples after one warm-up, each sample 10
back-to-back calls between two CUDA events, divided by 10 (the ``ms`` of
the kernels line); each kernel is also timed as single launches, one call
between two events (``*_single_ms``, the yardstick of the times recorded
for the first kernels, which includes the host's launch overhead); a plain
version's time
is one run after its comparison run.  Each kernel's bound is the larger of
the bytes it must move (inputs read once, outputs written once; for the
walk, the cells this run's walks visit) over 3.35 TB/s and its operations
over their type's peak (f32 67 TFLOP/s, INT32 16.7 TOP/s; an H100 SXM at
700 W); the battery kernels count the operations of a sort-and-merge
evaluation, not their own pairwise compares.  Any failure raises (non-zero
exit), and so does a module of the JAX package found loaded at the end.
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
W = 128
DP_BATCH = 256
DP_BUCKETS = (1024, 2048, 4096, 8192)
MAIN_PATH_BUCKET = 1024
BATTERY_P = 1 << 20
BATTERY_TILE = 16384
BATTERY_CAP = 128
COPIES = 64
SMOKE_MOD_POS = 500          # smoke_data/make_smoke_data.py MOD_POS
CAPPED_P = 16384
CAPPED_CAP = 1024
CAPPED_COV = 100
CAPPED_R = 100
CAPPED_Q = 25                # int(100 * 0.25)
CAPPED_PLAIN_ROWS = 2048
CAPPED_ROW0 = 1 << 20
# phase 5's --coverages.  Interior positions hold 512 observations a
# group (8 reads a strand, each copied 64 times), so 200 caps them all.  At
# 100 the genome's last positions (one case read against two or three
# control reads: D = 1 at every position of the neighbor window) outrank the
# planted site after the neighbor combination.  At 200 the JAX package's
# detect ranks the planted site's minus strand first on the same data
# (tests/test_torch_capped_smoke.py, on the CPU), so the card must too.
DETECT_COV = 200
CAPPED_RANK1 = ["spel", "-", str(SMOKE_MOD_POS + 1)]
PHASE3_KERNELS = ("banded_sw", "walk", "battery")
# a plain version is timed once, warmed by the comparison run just before
# (seconds a call at these shapes; the kernels take the median of 3)
PLAIN_TIMING = dict(reps=1, warm=True, n=1)
NATIVE_LIBS = ("fast5_ingest", "fast5_write", "sort_core", "traceback",
               "annotate_core", "format_core", "seed_core")
# phase 1's extra batches: M of the W = 32 / 1024 and ragged batches
DP_SMALL_M = 256
DP_RAGGED_B = 37
# phase 4's tile above the old cap of 645: widths, rows, cov
DEEP_CAPS = (1000, 290)
DEEP_P = 256
DEEP_COV = 700
# the first K1 and K2 (one block of W threads a read; one thread a walk) at
# the main path's shape on one H100 (PERF.md), ms, single launches (the
# yardstick of time_ms(..., n=1))
RECORDED_MS = {"banded_sw": (0.656, 0.677), "walk": (0.592, 0.611)}
# an H100 SXM's published peaks at 700 W: HBM3 rate, dense f32 outside the
# tensor cores; INT32 is not in the data sheet: 64 INT32 lanes an SM
# (Hopper's SM, half its 128 f32 lanes) x 132 SMs x 1.98 GHz, the clock at
# which 128 f32 lanes give 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# K1's f32 operations a DP cell: F (2 adds, 1 max), diagonal (1 add), Hnoe
# (2 max), Hnoe - ge*k (1 sub), running max (1), E (1 add), H (1 max), the
# extend tests (4 adds, 2 compares), the source (3 compares), the best (1)
K1_OPS_PER_CELL = 20
# K2's integer operations a walk step (decode, automaton, pack)
K2_OPS_PER_STEP = 12
# The battery's least work is a sort-and-merge evaluation, as the native
# host battery does it (sort_core.cpp): n log2 n compares to sort each
# group, then one merge walk over the n1 + n2 pooled values.  Operations a
# pooled value in the walk: for the KS numerator a compare, two multiplies,
# a subtract, an abs and a max; for the rank and tie sums two adds and a
# multiply.  The milli moments (rows 3-8): an add, a multiply, a shift and
# a mask a value.
WALK_KS_OPS = 6
WALK_RANK_OPS = 3
MILLI_MOMENT_OPS = 4
# integer operations a threefry2x32 block (20 rounds of add, rotate, xor
# and the key injections), two blocks a drawn index
THREEFRY_OPS = 100


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=3, warm=False, n=10) -> float:
    """Time of one fn() on the card: the median over ``reps`` samples of
    n back-to-back calls between two CUDA events, divided by n, after a
    warm-up (none when ``warm``: fn has just run, for the comparison).
    Back to back, a short kernel's launch overhead on the host hides
    behind the queue, as it does on the main path."""
    if not warm:
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / n)
    return float(np.median(ts))


def synth_reads(rng, bsz, m, w):
    """[B, M] read codes, [B, M + W] reference windows, [B] lengths."""
    read = np.full((bsz, m), 4, np.uint8)
    ref = np.empty((bsz, m + w), np.uint8)
    lens = np.empty(bsz, np.int32)
    for b in range(bsz):
        g = rng.integers(0, 4, m + w + m // 4).astype(np.uint8)
        ref[b] = g[: m + w]
        n = m if b % 4 else int(rng.integers(m // 2, m))
        s = g[w // 2:].copy()
        r = rng.random(len(s))
        sub = r < 0.03
        s[sub] = rng.integers(0, 4, int(sub.sum()))
        rep = np.where((r >= 0.03) & (r < 0.04), 0,            # deletion
                       np.where((r >= 0.04) & (r < 0.05), 2, 1))  # insertion
        seq = np.repeat(s, rep)[:n]
        seq[rng.random(n) < 0.005] = 4                          # N codes
        read[b, :n] = seq
        lens[b] = n
    return read, ref, lens


def tie_reads(rng, bsz, m, w):
    """Tandem-repeat reads on tandem-repeat windows, one break each: the
    best score is reached at several cells, across rows and within a
    row."""
    unit = np.array([0, 1, 0, 1, 2], np.uint8)
    ref = np.resize(unit, (bsz, m + w)).copy()
    read = np.resize(unit, (bsz, m)).copy()
    for b in range(bsz):
        read[b] = np.roll(read[b], b)
        cut = int(rng.integers(m // 4, m))
        read[b, cut:cut + 3] = 3
    return read, ref, np.full(bsz, m, np.int32)


def mismatch_reads(rng, bsz, m, w):
    """Every code mismatches (reads A, windows C): best 0 at (0, 0)."""
    return (np.zeros((bsz, m), np.uint8), np.ones((bsz, m + w), np.uint8),
            rng.integers(1, m + 1, bsz).astype(np.int32))


def max_abs_err(torch, pairs) -> float:
    return max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
               for a, b in pairs)


def bound(bytes_moved, f32_ops=0, int_ops=0):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their type's peak (f32 and INT32
    run on separate lanes, so the larger of the two)."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = max(f32_ops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def k1_work(read, ref, tb):
    """K1's bytes (codes and lengths read, tb and the three [B] outputs
    written) and f32 operations."""
    bsz = read.shape[0]
    return dict(bytes_moved=read.numel() + ref.numel() + 4 * bsz
                + tb.numel() + 12 * bsz,
                f32_ops=K1_OPS_PER_CELL * tb.numel())


def k2_work(torch, packed):
    """K2's bytes for this run's walks (a tb byte a step taken, best_i and
    best_k, the packed codes written) and integer operations.  The steps
    are the non-zero codes plus at most one stop step a read."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=packed.device)
    steps = int(((packed[..., None] >> shifts) & 3).ne(0).sum()) \
        + packed.shape[0]
    return dict(bytes_moved=steps + 8 * packed.shape[0] + packed.numel(),
                int_ops=K2_OPS_PER_STEP * steps)


def sort_compares(torch, n):
    """n log2 n a group of n values (0 for n <= 1), as int64 per row."""
    n = n.to(torch.float64)
    return (n * torch.log2(n.clamp(min=1))).to(torch.int64)


def ops_of(values, n):
    """{"f32_ops" or "int_ops": n}: compares of f32 values count at the f32
    peak, of int16 values at the INT32 peak."""
    return {"f32_ops" if values.is_floating_point() else "int_ops": n}


def k3_work(torch, v1, n1, v2, n2):
    """K3's bytes (values and counts read, 9 [P] int32 rows written) and
    the operations of a sort-and-merge evaluation of every row."""
    c1 = n1.to(torch.int64).clamp(0, v1.shape[1])
    c2 = n2.to(torch.int64).clamp(0, v2.shape[1])
    ops = int((sort_compares(torch, c1) + sort_compares(torch, c2)
               + (WALK_KS_OPS + WALK_RANK_OPS + MILLI_MOMENT_OPS)
               * (c1 + c2)).sum())
    return dict(bytes_moved=v1.nbytes + v2.nbytes + n1.nbytes + n2.nbytes
                + 36 * n1.shape[0], **ops_of(v1, ops))


def dp_check(torch, banded, banded_sw_cuda, read, ref, lens, what):
    """K1 and K2 against their plain versions on one batch (array-equal);
    returns K1's outputs, K2's packed codes and the two max abs errors."""
    k_out = banded_sw_cuda(read, ref, lens)
    p_out = banded.banded_sw_plain(read, ref, lens)
    torch.cuda.synchronize()
    for name, a, b in zip(("tb", "best", "best_i", "best_k"), k_out, p_out):
        if not torch.equal(a, b):
            raise AssertionError(f"K1 {name} differs from plain: {what}")
    tb, _, bi, bk = k_out
    ck = banded.walk_packed_cuda(tb, bi, bk)
    cp = banded.walk_packed_plain(tb, bi, bk)
    if not torch.equal(ck, cp):
        raise AssertionError(f"K2 packed codes differ from plain: {what}")
    return (k_out, ck, max_abs_err(torch, zip(k_out, p_out)),
            max_abs_err(torch, [(ck, cp)]))


def phase1(torch, dev):
    from nanomod_tpu_torch.resquiggle import banded
    from nanomod_tpu_torch.resquiggle.banded_kernel import banded_sw_cuda
    rng = np.random.default_rng(0)

    def on_card(arrays):
        return [torch.from_numpy(x).to(dev) for x in arrays]

    out = {}
    for m in DP_BUCKETS:
        read, ref, lens = on_card(synth_reads(rng, DP_BATCH, m, W))
        k_out, ck, e1, e2 = dp_check(torch, banded, banded_sw_cuda, read,
                                     ref, lens, f"M={m}")
        tb, _, bi, bk = k_out
        k1 = lambda: banded_sw_cuda(read, ref, lens)  # noqa: E731
        k2 = lambda: banded.walk_packed_cuda(tb, bi, bk)  # noqa: E731
        res = {
            "M": m, "B": DP_BATCH, "W": W,
            "k1_max_abs_err": e1, "k2_max_abs_err": e2,
            "k1_ms": time_ms(torch, k1),
            "k1_single_ms": time_ms(torch, k1, n=1),
            "k1_plain_ms": time_ms(
                torch, lambda: banded.banded_sw_plain(read, ref, lens),
                **PLAIN_TIMING),
            "k2_ms": time_ms(torch, k2),
            "k2_single_ms": time_ms(torch, k2, n=1),
            "k2_plain_ms": time_ms(
                torch, lambda: banded.walk_packed_plain(tb, bi, bk),
                **PLAIN_TIMING),
            "mean_best": float(k_out[1].mean()),
        }
        res["k1_bound_ms"], res["k1_bound_by"] = bound(**k1_work(read, ref,
                                                                 tb))
        res["k2_bound_ms"], res["k2_bound_by"] = bound(**k2_work(torch, ck))
        log("phase1", json.dumps(res))
        if m == MAIN_PATH_BUCKET:
            for name, key in (("banded_sw", "k1"), ("walk", "k2")):
                lo, hi = RECORDED_MS[name]
                log(f"phase1 {name} at B {DP_BATCH}, M {m}, W {W}: single "
                    f"launch {res[key + '_single_ms']:.4f} ms (first "
                    f"kernel, single launches: {lo}-{hi} ms), 10-launch mean "
                    f"{res[key + '_ms']:.4f} ms, bound "
                    f"{res[key + '_bound_ms']:.6f} ms "
                    f"({res[key + '_bound_by']})")
        out[m] = res

    extra = {
        "ties": (tie_reads(rng, DP_BATCH, MAIN_PATH_BUCKET, W), W),
        "all_mismatch": (mismatch_reads(rng, DP_BATCH, MAIN_PATH_BUCKET, W),
                         W),
        f"ragged_B{DP_RAGGED_B}": (synth_reads(rng, DP_RAGGED_B, DP_SMALL_M,
                                              W), W),
        "W32": (synth_reads(rng, DP_BATCH, DP_SMALL_M, 32), 32),
        "W1024": (synth_reads(rng, DP_BATCH, DP_SMALL_M, 1024), 1024),
    }
    errs = {}
    for what, (arrays, w) in extra.items():
        read, ref, lens = on_card(arrays)
        k_out, _, e1, e2 = dp_check(torch, banded, banded_sw_cuda, read, ref,
                                    lens, what)
        best, bi, bk = (x.cpu().numpy() for x in k_out[1:])
        if what == "all_mismatch" and (best.any() or bi.any() or bk.any()):
            raise AssertionError("all-mismatch batch: best must be 0 at (0, 0)")
        tb = k_out[0]
        errs[what] = {"k1_max_abs_err": e1, "k2_max_abs_err": e2,
                      "W": w, "B": len(best), "M": read.shape[1],
                      "max_best": float(best.max()),
                      "k1_ms": time_ms(torch, lambda: banded_sw_cuda(
                          read, ref, lens)),
                      "k2_ms": time_ms(torch, lambda: banded.walk_packed_cuda(
                          tb, k_out[2], k_out[3]))}
    log("phase1 extra", json.dumps(errs))
    out["extra"] = errs
    return out


def phase2(torch, dev):
    from nanomod_tpu_torch.stats import battery, kernels
    rng = np.random.default_rng(1)
    p, c = BATTERY_P, BATTERY_CAP
    v1 = (rng.integers(-40, 41, (p, c)) * 25).astype(np.int16)
    v2 = (rng.integers(-40, 41, (p, c)) * 25).astype(np.int16)
    n1 = rng.integers(30, 101, p).astype(np.int32)
    n2 = rng.integers(30, 101, p).astype(np.int32)
    n1[:4] = (0, 1, 0, 1)
    n2[:4] = (0, 0, 1, 1)
    tiles = [slice(lo, lo + BATTERY_TILE) for lo in range(0, p, BATTERY_TILE)]
    dv1, dn1, dv2, dn2 = (torch.from_numpy(x).to(dev) for x in (v1, n1, v2, n2))

    def run(fn):
        rows = torch.empty((9, p), dtype=torch.int32, device=dev)
        for sl in tiles:
            rows[:, sl] = fn(dv1[sl], dn1[sl], dv2[sl], dn2[sl], milli=True)
        return rows

    rows_k = run(kernels.battery_rows_cuda)
    rows_p = run(kernels.battery_rows_plain)
    torch.cuda.synchronize()
    if not torch.equal(rows_k, rows_p):
        raise AssertionError("K3 rows differ from plain")
    comp_k = battery.milli_components(rows_k.cpu().numpy())
    t0 = time.perf_counter()
    comp_h = battery.host_components(v1, n1, v2, n2)
    host_s = time.perf_counter() - t0
    if comp_h is None:
        raise RuntimeError("native host battery unavailable")
    # Rows with an empty group (D = num / (n1 * n2) undefined) are defined
    # differently by the host battery; run_battery never sends them (it
    # clamps counts to >= 1), so the host is held to the rest.
    both = (n1 > 0) & (n2 > 0)
    for key, want in comp_h.items():
        if not np.array_equal(comp_k[key][both], want[both]):
            raise AssertionError(f"K3 {key} differs from the host battery")

    # the deepest exact case (C1 = C2 = 645) and an f32 tile
    d1 = (rng.integers(-8, 9, (512, 1024)) * 125).astype(np.int16)
    d2 = (rng.integers(-8, 9, (512, 1024)) * 125).astype(np.int16)
    dc = np.full(512, 645, np.int32)
    deep = [torch.from_numpy(x).to(dev) for x in (d1, dc, d2, dc)]
    deep_k = kernels.battery_rows_cuda(*deep, milli=True)
    if not torch.equal(deep_k, kernels.battery_rows_plain(*deep, milli=True)):
        raise AssertionError("K3 rows differ from plain at C1 = C2 = 645")
    comp_d = battery.host_components(d1, dc, d2, dc)
    deep_comp = battery.milli_components(deep_k.cpu().numpy())
    for key, want in comp_d.items():
        if not np.array_equal(deep_comp[key], want):
            raise AssertionError(f"K3 {key} differs from host at 645")
    f1 = rng.normal(0, 1, (BATTERY_TILE, c)).astype(np.float32)
    f2 = rng.normal(0, 1, (BATTERY_TILE, c)).astype(np.float32)
    fl = [torch.from_numpy(x).to(dev) for x in (f1, n1[:BATTERY_TILE], f2,
                                                 n2[:BATTERY_TILE])]
    if not torch.equal(kernels.battery_rows_cuda(*fl, milli=False),
                       kernels.battery_rows_plain(*fl, milli=False)):
        raise AssertionError("K3 f32 rank rows differ from plain")

    k_ms = time_ms(torch, lambda: run(kernels.battery_rows_cuda))
    p_ms = time_ms(torch, lambda: run(kernels.battery_rows_plain),
                   **PLAIN_TIMING)
    tile = [x[tiles[1]] for x in (dv1, dn1, dv2, dn2)]
    k3 = lambda: kernels.battery_rows_cuda(*tile, milli=True)  # noqa: E731
    tile_ms = time_ms(torch, k3)
    tile_single_ms = time_ms(torch, k3, n=1)
    tile_plain_ms = time_ms(
        torch, lambda: kernels.battery_rows_plain(*tile, milli=True))
    tile_bound = bound(**k3_work(torch, *tile))

    # the whole battery (encode, H2D, K3, D2H, float64 finalize) against
    # the host backend, on pools of at least one observation per group
    pools1 = v1.astype(np.float32) / np.float32(1000)
    pools2 = v2.astype(np.float32) / np.float32(1000)
    m1 = np.maximum(n1, 1)
    m2 = np.maximum(n2, 1)
    t0 = time.perf_counter()
    res_d = battery.run_battery(pools1, m1, pools2, m2, device=dev,
                                tile_positions=BATTERY_TILE)
    torch.cuda.synchronize()
    dev_run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_h = battery.run_battery(pools1, m1, pools2, m2, backend="host")
    host_run_s = time.perf_counter() - t0
    for key in ("stu", "pu", "stt", "pt", "stks", "pks"):
        if not np.array_equal(getattr(res_d, key), getattr(res_h, key)):
            raise AssertionError(f"run_battery {key}: device != host")
    res = {
        "P": p, "tile": BATTERY_TILE, "cap": c,
        "k3_max_abs_err": max_abs_err(torch, [(rows_k, rows_p)]),
        "k3_ms": k_ms, "k3_plain_ms": p_ms, "host_components_ms": host_s * 1e3,
        "k3_tile_ms": tile_ms, "k3_tile_single_ms": tile_single_ms,
        "k3_tile_plain_ms": tile_plain_ms,
        "k3_tile_bound_ms": tile_bound[0], "k3_tile_bound_by": tile_bound[1],
        "k3_sites_per_s": p / (k_ms / 1e3),
        "plain_sites_per_s": p / (p_ms / 1e3),
        "host_sites_per_s": p / host_s,
        "run_battery_device_s": dev_run_s, "run_battery_host_s": host_run_s,
        "run_battery_device_sites_per_s": p / dev_run_s,
        "run_battery_host_sites_per_s": p / host_run_s,
    }
    log("phase2", json.dumps(res))
    return res


def _cli(args, env):
    cmd = [sys.executable, "-m", "nanomod_tpu_torch.cli"] + args
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(args[:1])} failed "
                           f"({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def _cli_all(jobs):
    """Run several CLI commands at once: {name: (args, env)} -> {name:
    stdout}; raises if any fails."""
    procs = {}
    try:
        for name, (args, env) in jobs.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "nanomod_tpu_torch.cli"] + args,
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        outs = {name: p.communicate(timeout=900) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"{name} failed ({p.returncode}):\n"
                               f"{outs[name][0]}\n{outs[name][1]}")
    return {name: out for name, (out, _) in outs.items()}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def phase3(torch, dev, tmp):
    from nanomod_tpu_torch.config import DetectConfig, RankConfig
    from nanomod_tpu_torch.detect import run_detect
    data = os.path.join(ROOT, "nanomod_tpu_torch", "smoke_data")
    env = _env()
    groups = {}
    for group in ("ctrl", "case"):
        dst = os.path.join(tmp, group)
        os.makedirs(dst)
        for name in sorted(os.listdir(os.path.join(data, group))):
            stem = name[: -len(".fast5")]
            for k in range(COPIES):
                shutil.copyfile(os.path.join(data, group, name),
                                os.path.join(dst, f"{stem}_{k:02d}.fast5"))
        groups[group] = dst
    # both groups at once, each its own CLI process on the card
    mfiles = {g: os.path.join(tmp, f"annotate_{g}.json") for g in groups}
    outs = _cli_all({g: (["Annotate", "--wrkBase1", folder,
                          "--Ref", os.path.join(data, "ref.fa"),
                          "--device", "cuda", "--metricsFile", mfiles[g]],
                         env) for g, folder in groups.items()})
    metrics = {}
    for group in groups:
        log(f"phase3 Annotate {group}:", outs[group].strip().splitlines()[-1])
        with open(mfiles[group]) as f:
            metrics[f"annotate_{group}"] = json.load(f)
    dfile = os.path.join(tmp, "detect.json")
    out_dir = os.path.join(tmp, "out")
    out = _cli(["detect", "--wrkBase1", groups["ctrl"],
                "--wrkBase2", groups["case"], "--outFolder", out_dir,
                "--min_lr", "0", "--device", "cuda",
                "--metricsFile", dfile], env)
    with open(dfile) as f:
        metrics["detect"] = json.load(f)
    rank1 = out.split("Rank 1:")[1].split("\n")[0].split()
    log("phase3 detect Rank 1:", " ".join(rank1))
    if int(rank1[2]) != SMOKE_MOD_POS + 1:
        raise AssertionError(f"planted site {SMOKE_MOD_POS + 1} is not "
                             f"ranked first: {rank1}")
    n_files = COPIES * len(os.listdir(os.path.join(data, "ctrl")))
    for group in groups:
        ok = metrics[f"annotate_{group}"]["reads_ok"]
        if ok < 0.9 * n_files:
            raise AssertionError(f"Annotate {group}: only {ok} of "
                                 f"{n_files} reads corrected")

    # the same corrected files through the native host battery must
    # give the same table byte for byte
    with open(os.path.join(out_dir, "mod_sign_test.txt"), "rb") as f:
        got = f.read()
    host_dir = os.path.join(tmp, "host")
    run_detect(DetectConfig(wrk_base1=groups["ctrl"],
                            wrk_base2=groups["case"], out_folder=host_dir,
                            min_lr=0, rank=RankConfig(window=10)),
               device=dev, backend="host")
    with open(os.path.join(host_dir, "mod_sign_test.txt"), "rb") as f:
        want = f.read()
    if got != want or len(got.splitlines()) < 1000:
        raise AssertionError("detect table differs from the host battery's")
    # 14 columns a row; the KS and combined p-values are finite and in
    # (0, 1] (a t statistic may be nan where a group has one distinct
    # value, as in the reference)
    rows = [line.split() for line in got.decode().splitlines()]
    if any(len(r) != 14 for r in rows):
        raise AssertionError("sign-test rows must have 14 columns")
    pv = np.array([(r[11], r[13]) for r in rows], dtype=np.float64)
    if not (np.isfinite(pv).all() and (pv > 0).all() and (pv <= 1).all()):
        raise AssertionError("KS / combined p-value outside (0, 1]")
    launches = {k: 0 for k in PHASE3_KERNELS}
    for m in metrics.values():
        for k in PHASE3_KERNELS:
            launches[k] += m["kernel_launches"][k]
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    res = {
        "reads_per_group": n_files,
        "annotate_reads_per_s": {
            g: metrics[f"annotate_{g}"]["reads_ok"]
            / metrics[f"annotate_{g}"]["seconds"] for g in groups},
        "detect_positions": metrics["detect"]["positions"],
        "detect_positions_per_s": metrics["detect"]["positions"]
        / metrics["detect"]["seconds"],
        "launches": launches,
        "stages": {k: {s: v["seconds"] for s, v in m["stages"].items()}
                   for k, m in metrics.items()},
    }
    log("phase3", json.dumps(res))
    return res, groups


def _capped_tile(rng, p, cap, lo, hi, cov, kind):
    """values [P, cap] (int16 milli with heavy ties, f32, or f32 with NaN
    padding), counts [P] per group in [lo, hi] with rows at 0, 1, cov and
    cov + 1."""
    vals = []
    counts = []
    for _ in range(2):
        v = (rng.integers(-30, 31, (p, cap)) * 25).astype(np.int16)
        n = rng.integers(lo, hi + 1, p).astype(np.int32)
        if kind != "i16":
            v = v.astype(np.float32) / np.float32(1000)
        vals.append(v)
        counts.append(n)
    if lo == 0:
        edge = (0, 1, cov - 1, cov, cov + 1, cov + 2)
        counts[0][: len(edge)] = edge
        counts[1][: len(edge)] = edge[::-1]
    if kind == "nan":
        for v, n in zip(vals, counts):
            v[np.arange(cap)[None, :] >= n[:, None]] = np.nan
    return vals[0], counts[0], vals[1], counts[1]


def k6_work(torch, args, kw):
    """K6's bytes (pools, counts and rows read, [P] written) and
    operations for one call, each evaluation sort-and-merge: a capped
    group draws R subsamples of cov (R cov indices of two threefry blocks
    each) and sorts each; a group at most cov is sorted once; a capped row
    merge-walks R pairs for the KS numerator and picks the quantile of the
    R numerators (R operations), an uncapped row one pair."""
    v1, n1, v2, n2, rows = args
    cov, reps = kw["cov"], kw["repeats"]
    c1 = n1.to(torch.int64).clamp(0, v1.shape[1])
    c2 = n2.to(torch.int64).clamp(0, v2.shape[1])
    capped = (c1 > cov) | (c2 > cov)
    evals = torch.where(capped, reps, 1)
    sorts = sum(sort_compares(torch, c.clamp(max=cov))
                * torch.where(c > cov, reps, 1) for c in (c1, c2))
    walk = WALK_KS_OPS * (c1.clamp(max=cov) + c2.clamp(max=cov)) * evals
    values_ops = int((sorts + walk).sum() + capped.sum() * reps)
    draws = int(((c1 > cov).sum() + (c2 > cov).sum()) * reps * cov)
    bytes_moved = (v1.nbytes + v2.nbytes + n1.nbytes + n2.nbytes
                   + rows.nbytes + 4 * n1.shape[0])
    ops = ops_of(v1, values_ops)
    ops["int_ops"] = ops.get("int_ops", 0) + 2 * THREEFRY_OPS * draws
    return dict(bytes_moved=bytes_moved, **ops)


def deep_tile(rng):
    """int16 pools above the old cap: group 1 holds 650-1,000 values, group
    2 at most 290 (the battery's pooled-width bound, 1,290)."""
    c1, c2 = DEEP_CAPS
    v1 = (rng.integers(-40, 41, (DEEP_P, c1)) * 25).astype(np.int16)
    v2 = (rng.integers(-35, 46, (DEEP_P, c2)) * 25).astype(np.int16)
    n1 = rng.integers(650, c1 + 1, DEEP_P).astype(np.int32)
    n2 = rng.integers(0, c2 + 1, DEEP_P).astype(np.int32)
    n1[:3] = (650, DEEP_COV, c1)
    return v1, n1, v2, n2


def phase4(torch, dev):
    from nanomod_tpu_torch.stats import kernels
    rng = np.random.default_rng(4)
    kw = dict(cov=CAPPED_COV, repeats=CAPPED_R, quantile_idx=CAPPED_Q, seed=0)

    def on_card(*arrays):
        return [torch.from_numpy(x).to(dev) for x in arrays]

    v1, n1, v2, n2 = _capped_tile(rng, CAPPED_P, CAPPED_CAP, 60, 645,
                                  CAPPED_COV, "i16")
    rows = np.arange(CAPPED_ROW0, CAPPED_ROW0 + CAPPED_P, dtype=np.int32)
    t = on_card(v1, n1, v2, n2, rows)
    sub = [x[:CAPPED_PLAIN_ROWS] for x in t]
    got = kernels.capped_ks_d_cuda(*t, **kw)
    want = kernels.capped_ks_d_plain(*sub, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got[:CAPPED_PLAIN_ROWS], want):
        raise AssertionError("K6 differs from plain on the main tile")
    errs = [(got[:CAPPED_PLAIN_ROWS], want)]
    for group in (0, 1):
        d = dict(cov=CAPPED_COV, repeats=CAPPED_R, seed=0, group=group)
        cnt = t[1 + 2 * group][:8]
        if not torch.equal(kernels.capped_draws_cuda(cnt, t[4][:8], **d),
                           kernels.capped_draws_plain(cnt, t[4][:8], **d)):
            raise AssertionError(f"K6 draws of group {group} differ from "
                                 f"the threefry replica")
    extra = {}
    for kind in ("i16", "f32", "nan"):
        x = on_card(*_capped_tile(rng, 2048, 256, 0, 256, CAPPED_COV, kind),
                    np.arange(2048, dtype=np.int32) + 7)
        a = kernels.capped_ks_d_cuda(*x, **kw)
        b = kernels.capped_ks_d_plain(*x, **kw)
        if not torch.equal(a, b):
            raise AssertionError(f"K6 differs from plain on the {kind} tile")
        errs.append((a, b))
        extra[kind] = int((x[1] > CAPPED_COV).sum() + (x[3] > CAPPED_COV).sum())
    x = on_card(*deep_tile(rng), np.arange(DEEP_P, dtype=np.int32) + 3)
    deep_kw = dict(kw, cov=DEEP_COV)
    a = kernels.capped_ks_d_cuda(*x, **deep_kw)
    b = kernels.capped_ks_d_plain(*x, **deep_kw)
    if not torch.equal(a, b):
        raise AssertionError(f"K6 differs from plain at cov = {DEEP_COV}")
    errs.append((a, b))
    extra[f"i16_cov{DEEP_COV}"] = int((x[1] > DEEP_COV).sum())
    res = {
        "P": CAPPED_P, "cap": CAPPED_CAP, "cov": CAPPED_COV,
        "repeats": CAPPED_R, "quantile_idx": CAPPED_Q,
        "plain_rows": CAPPED_PLAIN_ROWS,
        "capped_groups_in_extra_tiles": extra,
        "k6_max_abs_err": max_abs_err(torch, errs),
        "k6_tile_ms": time_ms(torch, lambda: kernels.capped_ks_d_cuda(*t, **kw)),
        "k6_tile_single_ms": time_ms(
            torch, lambda: kernels.capped_ks_d_cuda(*t, **kw), n=1),
        "k6_ms": time_ms(torch, lambda: kernels.capped_ks_d_cuda(*sub, **kw)),
        "k6_plain_ms": time_ms(
            torch, lambda: kernels.capped_ks_d_plain(*sub, **kw),
            **PLAIN_TIMING),
        "median_numerator": float(got.float().median()),
    }
    log("phase4", json.dumps(res))
    return res


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def phase5(torch, dev, tmp, groups):
    from nanomod_tpu_torch.config import RankConfig, SimulateConfig
    from nanomod_tpu_torch.harness.simulate import run_simulate
    from nanomod_tpu_torch.kernels import build as kbuild
    env = _env()
    capped = ["detect", "--wrkBase1", groups["ctrl"], "--wrkBase2",
              groups["case"], "--min_lr", "0", "--coverages",
              f"{DETECT_COV}-{DETECT_COV}", "--downsampling", "100",
              "--mstd", "1", "--device", "cuda"]
    dfile = os.path.join(tmp, "capped.json")
    harness = os.path.join(tmp, "harness")
    runs = {
        "simulat2": ["simulat2", "--wrkBase1", groups["ctrl"], "--wrkBase2",
                     groups["case"], "--Percentage", "0.5", "--CaseSize",
                     "200", "--FileID", "s2"],
        "DownSampling": ["DownSampling", "--wrkBase1", groups["case"],
                         "--wrkBase2", groups["ctrl"], "--CaseSize", "200",
                         "--FileID", "ds"],
        "simulate": ["simulate", "--wrkBase1", groups["ctrl"], "--wrkBase2",
                     groups["case"], "--wrkBase3", groups["ctrl"],
                     "--Percentages", "0.5,0.9", "--FileID", "sim"],
    }
    # the capped detect on both battery backends and the harness
    # subcommands, all at once (SimulateConfig's fixed target lies outside
    # the smoke genome: ranks are -1 and the .output rows carry none)
    jobs = {
        "capped": (capped + ["--outFolder", os.path.join(tmp, "capped"),
                             "--metricsFile", dfile], env),
        "capped_host": (capped + ["--outFolder",
                                  os.path.join(tmp, "capped_host")],
                        dict(env, NANOMOD_BATTERY_BACKEND="host")),
    }
    for cmd, args in runs.items():
        jobs[cmd] = (args + ["--outFolder", harness, "--device", "cuda"], env)
    t0 = time.perf_counter()
    outs = _cli_all(jobs)
    cli_s = time.perf_counter() - t0
    with open(dfile) as f:
        metrics = json.load(f)
    rank1 = outs["capped"].split("Rank 1:")[1].split("\n")[0].split()
    log("phase5 capped detect Rank 1:", " ".join(rank1))
    if rank1[:3] != CAPPED_RANK1:
        raise AssertionError(f"capped detect: rank 1 is {rank1}, not "
                             f"{CAPPED_RANK1} as the JAX package ranks it")
    launches = metrics["kernel_launches"]
    if launches["capped_ks"] <= 0 or launches["battery"] <= 0:
        raise AssertionError(f"capped detect did not launch K3 and K6: "
                             f"{launches}")
    for name in ("mod_sign_test.txt", "mod_meanstd.cvs"):
        a = _read_bytes(os.path.join(tmp, "capped", name))
        b = _read_bytes(os.path.join(tmp, "capped_host", name))
        if a != b or len(a.splitlines()) < 1000:
            raise AssertionError(f"capped {name}: device and host backends "
                                 f"differ")
    for cmd, args in runs.items():
        fid = args[args.index("--FileID") + 1]
        for ext in (".output", ".done"):
            if not os.path.isfile(os.path.join(harness, fid + ext)):
                raise AssertionError(f"{cmd} wrote no {fid}{ext}")

    # run_simulate at the smoke site.  Both strands carry the planted shift
    # and trade the first place from trial to trial, so the trials run once
    # for each strand as the target (the same seed gives the same trials):
    # in every trial one of the two must be rank 1, and every trial runs K3.
    trials = 4
    ranks = {}
    k3 = {}
    sim_s = 0.0
    for strand in ("+", "-"):
        cfg = SimulateConfig(
            wrk_base1=groups["ctrl"], wrk_base2=groups["case"],
            wrk_base3=groups["ctrl"],
            out_folder=os.path.join(tmp, "sim09" + strand),
            percentages=(0.9,), random_times=trials, target_chr="spel",
            target_pos=SMOKE_MOD_POS, target_strand=strand,
            rank=RankConfig(window=10))
        kbuild.reset_launches()
        t0 = time.perf_counter()
        ranks[strand] = run_simulate(cfg, device=dev)[0.9]
        torch.cuda.synchronize()
        sim_s += time.perf_counter() - t0
        k3[strand] = kbuild.launch_counts()["battery"]
        if k3[strand] < trials:
            raise AssertionError(f"run_simulate launched K3 {k3[strand]} "
                                 f"times in {trials} trials")
    best = [min(a, b) for a, b in zip(ranks["+"], ranks["-"])]
    if best != [1] * trials:
        raise AssertionError(f"run_simulate at 0.9: ranks {ranks}")
    res = {
        "capped_detect_positions": metrics["positions"],
        "capped_detect_s": metrics["seconds"],
        "capped_launches": launches,
        "capped_stages": {k: v["seconds"]
                          for k, v in metrics["stages"].items()},
        "cli_s": cli_s,
        "run_simulate_ranks": ranks, "run_simulate_k3_launches": k3,
        "run_simulate_s": sim_s,
    }
    log("phase5", json.dumps(res))
    return res


def phase6(torch, dev, tmp, groups):
    """K6 on the main path's own inputs: phase 5's capped detect once more,
    in this process, with K6's wrapper recording each call's tensors and
    its time on the card (CUDA events around the launch); then K6 against
    its plain version on exactly those tensors, whole, and both timed."""
    from nanomod_tpu_torch.config import DetectConfig, RankConfig, StatConfig
    from nanomod_tpu_torch.detect import run_detect
    from nanomod_tpu_torch.stats import kernels
    launch = kernels.capped_ks_d_cuda
    calls = []

    def recording(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch(*args, **kw)
        b.record()
        calls.append(([t.clone() for t in args], kw, out.clone(), a, b))
        return out

    mfile = os.path.join(tmp, "capped_inproc.json")
    out_dir = os.path.join(tmp, "capped_inproc")
    cfg = DetectConfig(
        wrk_base1=groups["ctrl"], wrk_base2=groups["case"],
        out_folder=out_dir, min_lr=0, mstd=True, metrics_file=mfile,
        stats=StatConfig(coverages=(DETECT_COV, DETECT_COV),
                         downsampling=100),
        rank=RankConfig(window=10))
    kernels.capped_ks_d_cuda = recording
    try:
        run_detect(cfg, device=dev)
    finally:
        kernels.capped_ks_d_cuda = launch
    torch.cuda.synchronize()
    # the same command as phase 5's CLI run: the same tables
    for name in ("mod_sign_test.txt", "mod_meanstd.cvs"):
        if (_read_bytes(os.path.join(out_dir, name))
                != _read_bytes(os.path.join(tmp, "capped", name))):
            raise AssertionError(f"in-process capped detect: {name} differs "
                                 f"from the CLI's")
    with open(mfile) as f:
        metrics = json.load(f)
    if not calls:
        raise AssertionError("the capped detect did not call K6")
    errs = []
    shapes = []
    for args, kw, got, _, _ in calls:
        want = kernels.capped_ks_d_plain(*args, **kw)
        if not torch.equal(got, want):
            raise AssertionError(f"K6 differs from plain on the main path's "
                                 f"input {[tuple(t.shape) for t in args]}")
        errs.append((got, want))
        shapes.append([list(t.shape) for t in args[:4:2]])
    args, kw = max(calls, key=lambda c: c[0][0].numel())[:2]
    in_run_ms = [a.elapsed_time(b) for *_, a, b in calls]
    battery_s = metrics["stages"]["test_battery"]["seconds"]
    res = {
        "calls": len(calls), "values_shapes": shapes, "kw": kw,
        "capped_rows": [int(((c[0][1] > DETECT_COV) | (c[0][3] > DETECT_COV))
                            .sum()) for c in calls],
        "k6_max_abs_err": max_abs_err(torch, errs),
        "k6_in_run_ms": in_run_ms,
        "test_battery_s": battery_s,
        "k6_share_of_test_battery": sum(in_run_ms) / 1e3 / battery_s,
        "detect_s": metrics["seconds"],
        "k6_ms": time_ms(torch, lambda: launch(*args, **kw)),
        "k6_single_ms": time_ms(torch, lambda: launch(*args, **kw), n=1),
        "k6_plain_ms": time_ms(
            torch, lambda: kernels.capped_ks_d_plain(*args, **kw),
            **PLAIN_TIMING),
    }
    res["k6_bound_ms"], res["k6_bound_by"] = bound(**k6_work(torch, args,
                                                             kw))
    log("phase6", json.dumps(res))
    return res


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "nanomod_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    card = card_line()
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])

    from nanomod_tpu_torch import native
    from nanomod_tpu_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    kbuild.lib()
    log("phase0", json.dumps({
        "kernel_build_s": time.perf_counter() - t0,
        "nvcc_s": kbuild.BUILD_INFO["seconds"],
        "rebuilt": kbuild.BUILD_INFO["rebuilt"]}))
    t0 = time.perf_counter()
    native.require(*NATIVE_LIBS)
    log("phase0", json.dumps({"native_build_s": time.perf_counter() - t0}))

    p1 = phase1(torch, dev)
    p2 = phase2(torch, dev)
    tmp = tempfile.mkdtemp(prefix="nanomod_smoke_")
    try:
        p3, groups = phase3(torch, dev, tmp)
        p4 = phase4(torch, dev)
        p5 = phase5(torch, dev, tmp, groups)
        p6 = phase6(torch, dev, tmp, groups)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    jax_package = sorted(m for m in sys.modules
                         if m == "nanomod_tpu" or m.startswith("nanomod_tpu."))
    if jax_package:
        raise AssertionError(f"JAX-package modules were loaded: {jax_package}")

    main_dp = p1[MAIN_PATH_BUCKET]
    dp_runs = [r for m, r in p1.items() if m != "extra"] \
        + list(p1["extra"].values())
    # no single PyTorch call computes any of these functions
    kernels = [
        {"name": "banded_sw", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/banded_sw.cu",
         "replaces": "nanomod_tpu/resquiggle/banded_pallas.py:133",
         "launches": p3["launches"]["banded_sw"],
         "max_abs_err": max(r["k1_max_abs_err"] for r in dp_runs),
         "ms": main_dp["k1_ms"], "plain_ms": main_dp["k1_plain_ms"],
         "bound_ms": main_dp["k1_bound_ms"],
         "bound_by": main_dp["k1_bound_by"], "library_ms": None},
        {"name": "walk", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/walk.cu",
         "replaces": "nanomod_tpu/resquiggle/banded.py:189",
         "launches": p3["launches"]["walk"],
         "max_abs_err": max(r["k2_max_abs_err"] for r in dp_runs),
         "ms": main_dp["k2_ms"], "plain_ms": main_dp["k2_plain_ms"],
         "bound_ms": main_dp["k2_bound_ms"],
         "bound_by": main_dp["k2_bound_by"], "library_ms": None},
        {"name": "battery", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/battery.cu",
         "replaces": "nanomod_tpu/stats/kernels.py:186",
         "launches": p3["launches"]["battery"],
         "max_abs_err": p2["k3_max_abs_err"],
         "ms": p2["k3_tile_ms"], "plain_ms": p2["k3_tile_plain_ms"],
         "bound_ms": p2["k3_tile_bound_ms"],
         "bound_by": p2["k3_tile_bound_by"], "library_ms": None},
        {"name": "capped_ks", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/capped_ks.cu",
         "replaces": "nanomod_tpu/stats/kernels.py:279",
         "launches": p5["capped_launches"]["capped_ks"],
         "max_abs_err": max(p4["k6_max_abs_err"], p6["k6_max_abs_err"]),
         "ms": p6["k6_ms"], "plain_ms": p6["k6_plain_ms"],
         "bound_ms": p6["k6_bound_ms"], "bound_by": p6["k6_bound_by"],
         "library_ms": None},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
