"""The port's bench: detect battery throughput (primary), Annotate
throughput (secondary) and end-to-end detect throughput, in ONE JSON line.

Port of the reference's bench.py, function for function, with its
environment variables, sizes, seeds, repeat counts and JSON keys::

    python -m nanomod_tpu_torch.bench                 # on the card (cuda)
    python -m nanomod_tpu_torch.bench --device cpu    # the plain versions

Primary workload: the detect hot path (``run_battery`` at tiles of 16,384
positions, ``combine_neighbor_pvalues``, the rank's lexsort) on
BENCH_POSITIONS (200,000) synthetic positions of ~BENCH_COVERAGE (50)
values a group, rounded to three decimals (the milli path of kernel K3).
Baseline: the reference's per-position scipy loop (ref
bin/scripts/myDetect.py:416-438), measured on 300 positions each run.
``split`` times K3 alone on one 16,384 x 64 int16 tile already on the
device (synchronize deltas) and a steady host-to-device copy of 2 MB.

Secondary: the full Annotate pipeline (``annotate_files``: native ingest,
seeding, kernels K1 and K2, native correction and write-back) on
BENCH_READS (512) raw reads of BENCH_READ_LEN (2,000) bases at 3 %
basecall errors; baseline the fixed reference-equivalent rate
NANOMOD_REF_ANNOTATE_RATE (5.5 reads/s).  e2e: ``run_detect`` on
BENCH_E2E_READS (120) corrected reads a group on a BENCH_E2E_GENOME
(4,000) base genome with a planted shift at genome // 3.

All datasets come from fixed seeds (battery rng(0); annotate genome 1,
reads 2; e2e 11 / 1 / 2) through ``tools/fixtures.py`` (the reference's
test fixtures, draw for draw, written without h5py).  Each metric is the
median of N timed runs after one warm-up run (which builds the kernels),
with min / max.  BENCH_SKIP_ANNOTATE / BENCH_SKIP_E2E skip a part,
BENCH_ONLY_ANNOTATE runs only Annotate, BENCH_*_REPEAT set N.

Beyond the reference's keys the line holds ``"device"`` (the card's name
and power limit as nvidia-smi gives them, or "cpu"), ``secondary.n_ok``
(the reads annotated in the last run) and ``e2e.positions`` (the rows of
the last run's table).  Under ``--device cuda`` nothing falls back to the
CPU: without a card the bench raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np


def card_name(device) -> str:
    """The device as the line records it: "cpu", or the card's name and
    power limit from nvidia-smi (raises where it cannot be read)."""
    if device.type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_ours(values1, counts1, values2, counts2, positions, device,
               repeat=5):
    """Median-of-`repeat` battery throughput on ``device``.  Returns
    (median sites/s, dispersion dict, device/link split dict).

    The split separates the device from the host and the link:
    `device_sites_per_sec` times K3 on a tile already on the device
    (synchronize deltas, no transfers), `h2d_MBps_steady` a steady
    host-to-device copy, and `link_host_overhead_s` is the wall time the
    device compute does not explain."""
    import torch

    from nanomod_tpu_torch.config import StatConfig
    from nanomod_tpu_torch.stats import kernels
    from nanomod_tpu_torch.stats.battery import resolve_backend, run_battery
    from nanomod_tpu_torch.stats.combine import combine_neighbor_pvalues

    cfg = StatConfig()
    gid = np.zeros(len(positions), dtype=np.int64)
    tile = 16384
    backend = resolve_backend()

    def once():
        res = run_battery(values1, counts1, values2, counts2, cfg=cfg,
                          tile_positions=tile, backend=backend, device=device)
        stc, pc = combine_neighbor_pvalues(gid, positions, res.pks, cfg)
        order = np.lexsort((res.pu, res.pks, pc))
        return order[0]

    once()  # warm-up: builds the kernels
    rates = []
    for _ in range(repeat):
        t0 = time.time()
        once()
        rates.append(len(positions) / (time.time() - t0))
    rates.sort()
    disp = {"min": round(rates[0], 1), "max": round(rates[-1], 1),
            "n": repeat}
    wall = float(np.median(rates))

    # ---- device/link split (diagnostics, not the primary metric) ----
    rng = np.random.default_rng(1)
    v1 = (rng.normal(0, 1, (tile, 64)) * 1000).astype(np.int16)
    v2 = (rng.normal(0, 1, (tile, 64)) * 1000).astype(np.int16)
    cn = rng.integers(40, 64, tile).astype(np.int32)
    d1, d2, dc = (torch.from_numpy(x).to(device) for x in (v1, v2, cn))
    kernels.battery_components_packed_milli(d1, dc, d2, dc)
    _sync(device)
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        kernels.battery_components_packed_milli(d1, dc, d2, dc)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    dev_tile_s = float(np.median(ts))
    n_tiles = (len(positions) + tile - 1) // tile
    device_battery_s = dev_tile_s * n_tiles
    buf = torch.from_numpy(np.zeros(1 << 20, np.int16))
    buf.to(device, copy=True)
    _sync(device)
    t0 = time.perf_counter()
    buf.to(device, copy=True)
    _sync(device)
    h2d_mbps = buf.nbytes / (time.perf_counter() - t0) / 1e6
    split = {
        "backend": backend,
        "device_battery_s": round(device_battery_s, 4),
        "device_sites_per_sec": round(tile / dev_tile_s, 1),
        "h2d_MBps_steady": round(h2d_mbps, 1),
        "link_host_overhead_s": round(
            len(positions) / wall - device_battery_s, 3),
    }
    return wall, disp, split


def bench_reference_equiv(values1, counts1, values2, counts2, sample=300):
    """Reference-equivalent cost: per-position scipy calls in a Python loop
    (the reference's exact structure, myDetect.py:430-436)."""
    from scipy.stats import mannwhitneyu, ttest_ind, ks_2samp
    n = min(sample, len(counts1))
    t0 = time.time()
    for i in range(n):
        a = values1[i, : counts1[i]].astype(np.float64)
        b = values2[i, : counts2[i]].astype(np.float64)
        try:
            mannwhitneyu(a, b)
        except ValueError:
            pass
        ttest_ind(a, b, equal_var=False)
        ks_2samp(a, b, method="asymp")
    dt = time.time() - t0
    return n / dt


def bench_annotate(device):
    """Full Annotate pipeline throughput (reads resquiggled/s) on a
    synthetic raw dataset on ``device``."""
    from nanomod_tpu_torch.config import AnnotateConfig
    from nanomod_tpu_torch.resquiggle.pipeline import annotate_files
    from nanomod_tpu_torch.tools.fixtures import make_genome, make_raw_dataset
    from nanomod_tpu_torch.utils.observe import observer

    n_reads = int(os.environ.get("BENCH_READS", 512))
    read_len = int(os.environ.get("BENCH_READ_LEN", 2000))

    with tempfile.TemporaryDirectory(prefix="nanomod_bench_") as root:
        chrom, genome = make_genome(length=read_len + 500, seed=1)
        fasta_p = os.path.join(root, "ref.fa")
        with open(fasta_p, "w") as f:
            f.write(f">{chrom}\n{genome}\n")
        reads_dir = os.path.join(root, "reads")
        make_raw_dataset(reads_dir, chrom, genome, n_reads=n_reads, seed=2,
                         read_len=read_len, error_rate=0.03)
        paths = sorted(os.path.join(reads_dir, f)
                       for f in os.listdir(reads_dir))
        cfg = AnnotateConfig(wrk_base1=reads_dir, ref_fasta=fasta_p)

        annotate_files(paths, cfg, device=device)      # warm-up
        repeat = int(os.environ.get("BENCH_ANNOTATE_REPEAT", 3))
        rates = []
        stages = {}
        for _ in range(repeat):
            observer().reset()
            t0 = time.time()
            n_ok, _, _ = annotate_files(paths, cfg, device=device)
            _sync(device)
            rates.append(n_ok / (time.time() - t0))
            stages = {name: d["seconds"]
                      for name, d in observer().snapshot().items()}
    rates.sort()
    rate = float(np.median(rates))
    ref_rate = float(os.environ.get("NANOMOD_REF_ANNOTATE_RATE", 5.5))
    return {"metric": "reads_resquiggled_per_sec", "value": round(rate, 1),
            "unit": "reads/s", "vs_baseline": round(rate / ref_rate, 2),
            # the reference's practical operating point: 12 worker
            # processes/node (ref myRefBaseSignalAnnotation.py:1452-1483)
            # ~= 12 x 5.5 reads/s
            "vs_ref_12thread": round(rate / (12 * ref_rate), 2),
            "dispersion": {"min": round(rates[0], 1),
                           "max": round(rates[-1], 1), "n": repeat},
            "stage_seconds": stages, "n_ok": n_ok}


def bench_e2e_detect(device):
    """End-to-end detect (FAST5 ingest -> pools -> battery -> combine ->
    rank -> save) on a pinned corrected dataset on ``device``; positions/s
    of wall clock."""
    from nanomod_tpu_torch.config import DetectConfig
    from nanomod_tpu_torch.detect import run_detect
    from nanomod_tpu_torch.tools.fixtures import (make_corrected_dataset,
                                                  make_genome)

    n_reads = int(os.environ.get("BENCH_E2E_READS", 120))
    glen = int(os.environ.get("BENCH_E2E_GENOME", 4000))
    with tempfile.TemporaryDirectory(prefix="nanomod_bench_") as root:
        chrom, genome = make_genome(length=glen, seed=11)
        d1 = os.path.join(root, "g1")
        d2 = os.path.join(root, "g2")
        make_corrected_dataset(d1, chrom, genome, n_reads=n_reads, seed=1)
        make_corrected_dataset(d2, chrom, genome, n_reads=n_reads, seed=2,
                               mod_pos=glen // 3, mod_delta=1.5)
        cfg = DetectConfig(wrk_base1=d1, wrk_base2=d2,
                           out_folder=os.path.join(root, "out"),
                           file_id="bench", min_lr=0, out_level=3)
        table, order, sites = run_detect(cfg, device=device)   # warm-up
        repeat = int(os.environ.get("BENCH_E2E_REPEAT", 3))
        rates = []
        for _ in range(repeat):
            t0 = time.time()
            table, order, sites = run_detect(cfg, device=device)
            _sync(device)
            rates.append(len(table) / (time.time() - t0))
    rates.sort()
    return {"metric": "e2e_detect_positions_per_sec",
            "value": round(float(np.median(rates)), 1), "unit": "positions/s",
            "top_site_pos": int(sites[0].pos) if len(sites) else -1,
            "dispersion": {"min": round(rates[0], 1),
                           "max": round(rates[-1], 1), "n": repeat},
            "positions": len(table)}


def main(argv=None):
    from nanomod_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m nanomod_tpu_torch.bench")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu; "
                         "never falls back")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_name(device)

    if os.environ.get("BENCH_ONLY_ANNOTATE"):
        line = {"secondary": bench_annotate(device), "device": card}
        print(json.dumps(line))
        return line

    p_total = int(os.environ.get("BENCH_POSITIONS", 200_000))
    cov = int(os.environ.get("BENCH_COVERAGE", 50))
    rng = np.random.default_rng(0)
    c_max = cov + 14
    counts1 = rng.integers(cov - 10, c_max, p_total).astype(np.int32)
    counts2 = rng.integers(cov - 10, c_max, p_total).astype(np.int32)
    values1 = np.round(rng.normal(0, 1, (p_total, c_max)), 3).astype(np.float32)
    values2 = np.round(rng.normal(0, 1, (p_total, c_max)), 3).astype(np.float32)
    positions = np.arange(p_total, dtype=np.int64)

    ours, disp, split = bench_ours(values1, counts1, values2, counts2,
                                   positions, device)
    ref = bench_reference_equiv(values1, counts1, values2, counts2)

    line = {
        "metric": "sites_tested_per_sec",
        "value": round(ours, 1),
        "unit": "sites/s",
        "vs_baseline": round(ours / ref, 2),
        "dispersion": disp,
        "split": split,
    }
    if not os.environ.get("BENCH_SKIP_ANNOTATE"):
        line["secondary"] = bench_annotate(device)
    if not os.environ.get("BENCH_SKIP_E2E"):
        line["e2e"] = bench_e2e_detect(device)
    line["device"] = card
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
