#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (nanomod_tpu_torch) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phase 0  prints the card (nvidia-smi name and power limit), the PyTorch and
         CUDA versions; builds the CUDA kernels (nvcc, sm_90a) and the
         native host libraries from the sources in the checkout.
Phase 1  K1 (banded DP) and K2 (traceback walk) against their plain PyTorch
         versions on the card: B = 256 synthetic reads (genome windows with
         ~5 % substitutions and indels, some reads shorter than their
         bucket, some N codes), W = 128, M = 1024 (the bucket of the main
         path's reads), 2048, 4096, 8192.  tb, best, best_i, best_k and the
         packed walk codes must be array-equal.
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
         NaN padding, whole.  Outputs must be array-equal, and K6's own
         threefry draws equal to the plain replica's.
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

Kernel times are medians of 3 runs after one warm-up, taken with CUDA
events; a plain version's time is one run after its comparison run.  Any
failure raises (non-zero exit).  The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel.
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
PLAIN_TIMING = dict(reps=1, warm=True)
NATIVE_LIBS = ("fast5_ingest", "fast5_write", "sort_core", "traceback",
               "annotate_core", "format_core", "seed_core")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=3, warm=False) -> float:
    """Median wall time of fn() on the card, CUDA events, after a warm-up
    (none when ``warm``: fn has just run, for the comparison)."""
    if not warm:
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
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


def max_abs_err(torch, pairs) -> float:
    return max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
               for a, b in pairs)


def phase1(torch, dev):
    from nanomod_tpu_torch.resquiggle import banded
    from nanomod_tpu_torch.resquiggle.banded_kernel import banded_sw_cuda
    rng = np.random.default_rng(0)
    out = {}
    for m in DP_BUCKETS:
        read, ref, lens = (torch.from_numpy(x).to(dev)
                           for x in synth_reads(rng, DP_BATCH, m, W))
        k_out = banded_sw_cuda(read, ref, lens)
        p_out = banded.banded_sw_plain(read, ref, lens)
        torch.cuda.synchronize()
        for name, a, b in zip(("tb", "best", "best_i", "best_k"), k_out, p_out):
            if not torch.equal(a, b):
                raise AssertionError(f"K1 {name} differs from plain at M={m}")
        tb, _, bi, bk = k_out
        ck = banded.pack_codes2(banded.walk_cuda(tb, bi, bk))
        cp = banded.pack_codes2(banded.walk_device_plain(tb, bi, bk))
        if not torch.equal(ck, cp):
            raise AssertionError(f"K2 packed codes differ from plain at M={m}")
        res = {
            "M": m, "B": DP_BATCH, "W": W,
            "k1_max_abs_err": max_abs_err(torch, zip(k_out, p_out)),
            "k2_max_abs_err": max_abs_err(torch, [(ck, cp)]),
            "k1_ms": time_ms(torch, lambda: banded_sw_cuda(read, ref, lens)),
            "k1_plain_ms": time_ms(
                torch, lambda: banded.banded_sw_plain(read, ref, lens),
                **PLAIN_TIMING),
            "k2_ms": time_ms(torch, lambda: banded.walk_cuda(tb, bi, bk)),
            "k2_plain_ms": time_ms(
                torch, lambda: banded.walk_device_plain(tb, bi, bk),
                **PLAIN_TIMING),
            "mean_best": float(k_out[1].mean()),
        }
        log("phase1", json.dumps(res))
        out[m] = res
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
    tile_ms = time_ms(torch, lambda: kernels.battery_rows_cuda(
        dv1[tiles[1]], dn1[tiles[1]], dv2[tiles[1]], dn2[tiles[1]],
        milli=True))
    tile_plain_ms = time_ms(torch, lambda: kernels.battery_rows_plain(
        dv1[tiles[1]], dn1[tiles[1]], dv2[tiles[1]], dn2[tiles[1]],
        milli=True))

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
        "k3_tile_ms": tile_ms, "k3_tile_plain_ms": tile_plain_ms,
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
    from nanomod_tpu.config import DetectConfig, RankConfig
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
    res = {
        "P": CAPPED_P, "cap": CAPPED_CAP, "cov": CAPPED_COV,
        "repeats": CAPPED_R, "quantile_idx": CAPPED_Q,
        "plain_rows": CAPPED_PLAIN_ROWS,
        "capped_groups_in_extra_tiles": extra,
        "k6_max_abs_err": max_abs_err(torch, errs),
        "k6_tile_ms": time_ms(torch, lambda: kernels.capped_ks_d_cuda(*t, **kw)),
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
    from nanomod_tpu.config import RankConfig, SimulateConfig
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
    from nanomod_tpu.config import DetectConfig, RankConfig, StatConfig
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
        "k6_plain_ms": time_ms(
            torch, lambda: kernels.capped_ks_d_plain(*args, **kw),
            **PLAIN_TIMING),
    }
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

    main_dp = p1[MAIN_PATH_BUCKET]
    kernels = [
        {"name": "banded_sw", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/banded_sw.cu",
         "replaces": "nanomod_tpu/resquiggle/banded_pallas.py:133",
         "launches": p3["launches"]["banded_sw"],
         "max_abs_err": max(r["k1_max_abs_err"] for r in p1.values()),
         "ms": main_dp["k1_ms"], "plain_ms": main_dp["k1_plain_ms"]},
        {"name": "walk", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/walk.cu",
         "replaces": "nanomod_tpu/resquiggle/banded.py:189",
         "launches": p3["launches"]["walk"],
         "max_abs_err": max(r["k2_max_abs_err"] for r in p1.values()),
         "ms": main_dp["k2_ms"], "plain_ms": main_dp["k2_plain_ms"]},
        {"name": "battery", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/battery.cu",
         "replaces": "nanomod_tpu/stats/kernels.py:186",
         "launches": p3["launches"]["battery"],
         "max_abs_err": p2["k3_max_abs_err"],
         "ms": p2["k3_tile_ms"], "plain_ms": p2["k3_tile_plain_ms"]},
        {"name": "capped_ks", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/capped_ks.cu",
         "replaces": "nanomod_tpu/stats/kernels.py:279",
         "launches": p5["capped_launches"]["capped_ks"],
         "max_abs_err": max(p4["k6_max_abs_err"], p6["k6_max_abs_err"]),
         "ms": p6["k6_ms"], "plain_ms": p6["k6_plain_ms"]},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
