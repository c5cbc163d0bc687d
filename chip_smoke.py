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

Times are medians of 3 runs after one warm-up, taken with CUDA events.  Any
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


def time_ms(torch, fn, reps=3) -> float:
    """Median wall time of fn() on the card, CUDA events, after a warm-up."""
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
                torch, lambda: banded.banded_sw_plain(read, ref, lens)),
            "k2_ms": time_ms(torch, lambda: banded.walk_cuda(tb, bi, bk)),
            "k2_plain_ms": time_ms(
                torch, lambda: banded.walk_device_plain(tb, bi, bk)),
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
    p_ms = time_ms(torch, lambda: run(kernels.battery_rows_plain))
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


def phase3(torch, dev):
    from nanomod_tpu.config import DetectConfig, RankConfig
    from nanomod_tpu_torch.detect import run_detect
    data = os.path.join(ROOT, "nanomod_tpu_torch", "smoke_data")
    tmp = tempfile.mkdtemp(prefix="nanomod_smoke_")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    try:
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
        metrics = {}
        for group, folder in groups.items():
            mfile = os.path.join(tmp, f"annotate_{group}.json")
            out = _cli(["Annotate", "--wrkBase1", folder,
                        "--Ref", os.path.join(data, "ref.fa"),
                        "--device", "cuda", "--metricsFile", mfile], env)
            log(f"phase3 Annotate {group}:", out.strip().splitlines()[-1])
            with open(mfile) as f:
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
        launches = {k: 0 for k in metrics["detect"]["kernel_launches"]}
        for m in metrics.values():
            for k, v in m["kernel_launches"].items():
                launches[k] += v
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
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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

    from nanomod_tpu.native.build import load_native
    from nanomod_tpu_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    kbuild.lib()
    log("phase0", json.dumps({
        "kernel_build_s": time.perf_counter() - t0,
        "nvcc_s": kbuild.BUILD_INFO["seconds"],
        "rebuilt": kbuild.BUILD_INFO["rebuilt"]}))
    t0 = time.perf_counter()
    for name in NATIVE_LIBS:
        if load_native(name) is None:
            raise RuntimeError(f"native library {name} failed to build")
    log("phase0", json.dumps({"native_build_s": time.perf_counter() - t0}))

    p1 = phase1(torch, dev)
    p2 = phase2(torch, dev)
    p3 = phase3(torch, dev)
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
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
