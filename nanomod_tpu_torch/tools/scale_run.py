"""E. coli-scale detect on the port: the reference's tools/scale_run.py.

Generates a synthetic 4.6 Mb genome and two groups of corrected FAST5
reads (default 35k reads of 3 kb a group, ~11x coverage a strand; override
with SCALE_READS, SCALE_READ_LEN, SCALE_GENOME), plants 20 modified sites
in the case group, then runs the port's detect on them:

    ingest (native C++ FAST5 parse) -> pools -> battery (K3) -> neighbor
    combination -> ranking -> _sign_test.txt

and reports the wall time of each stage, peak RSS, positions/s, the
kernels' launches and whether each planted site ranks in the top 50.  The
genome, levels, planted sites and every read are drawn as the reference's
tool draws them (same seeds, same order).  The reads are written by the
native corrected writer into copies of a committed raw read (h5py is not
needed).

    python -m nanomod_tpu_torch.tools.scale_run [OUT] [--device cpu]
        [--profileDir DIR]

OUT defaults to nanomod_scale under the temporary directory and holds
several GB of FAST5s at the default size; delete it afterwards.  With
--profileDir the detect runs under torch.profiler (DetectConfig.
profile_dir) and the summary gives the device-busy share of the run and
K3's kernel events and time.  SCALE_TILE and SCALE_POOL_CAP set
tile_positions and pool_capacity.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np

from nanomod_tpu_torch.config import DetectConfig, RankConfig
from nanomod_tpu_torch.tools.common import (metrics_summary, out_root, rss_gb,
                                            trace_busy_share)

GENOME_LEN = int(os.environ.get("SCALE_GENOME", 4_600_000))
N_READS = int(os.environ.get("SCALE_READS", 35_000))
READ_LEN = int(os.environ.get("SCALE_READ_LEN", 3_000))
N_SITES = 20
MOD_DELTA = 1.5
CHROM = "ecoli_syn"
# the committed raw read every corrected read is written into a copy of
TEMPLATE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "smoke_data", "ctrl", "raw_0000.fast5")
WRITE_BATCH = 256


def _write(batch, nthreads=8):
    from nanomod_tpu_torch.native.fast5_write_bind import (
        write_corrected_batch_native)
    paths = [p for p, _ in batch]
    for p in paths:
        shutil.copyfile(TEMPLATE, p)
    ok = write_corrected_batch_native(paths, [pl for _, pl in batch],
                                      nthreads=nthreads)
    if ok is None or not ok.all():
        raise RuntimeError("the native corrected writer declined a read")


def gen_group(folder, genome_arr, levels, rng, planted=None,
              n_reads=None, read_len=None, mod_delta=None):
    """Write one group of corrected FAST5s: the reference's gen_group,
    draw for draw (strand, start, then the read's level noise), through
    the native corrected writer."""
    from nanomod_tpu_torch.io.fast5 import CORRECTED_EVENTS_DTYPE
    n_reads = N_READS if n_reads is None else n_reads
    rl = READ_LEN if read_len is None else read_len
    delta = MOD_DELTA if mod_delta is None else mod_delta
    glen = len(genome_arr)
    os.makedirs(folder, exist_ok=True)
    comp = np.frombuffer(b"TGCA", np.uint8)[
        np.searchsorted(np.frombuffer(b"ACGT", np.uint8), genome_arr)]
    batch = []
    for i in range(n_reads):
        # a random strand a read (the level track is the strand's)
        strand = "+-"[int(rng.integers(2))]
        start = int(rng.integers(0, glen - rl + 1))
        gpos = np.arange(start, start + rl)
        means = levels[strand == "-"][gpos] + rng.normal(0.0, 0.3, rl)
        if planted is not None:
            # full shift at the site, half at +-1
            for tp in planted:
                for off, scale in ((-1, 0.5), (0, 1.0), (1, 0.5)):
                    if start <= tp + off < start + rl:
                        means[tp + off - start] += delta * scale
        ev = np.zeros(rl, CORRECTED_EVENTS_DTYPE)
        if strand == "-":
            ev["norm_mean"] = np.round(means[::-1], 3)
            ev["base"] = comp[gpos[::-1]].view("S1")
        else:
            ev["norm_mean"] = np.round(means, 3)
            ev["base"] = genome_arr[gpos].view("S1")
        ev["norm_stdev"] = 0.1
        ev["start"] = np.arange(rl, dtype=np.uint32) * 8
        ev["length"] = 8
        sub = os.path.join(folder, str(i // 4000))
        os.makedirs(sub, exist_ok=True)
        batch.append((os.path.join(sub, f"r{i:06d}.fast5"), dict(
            chrom=CHROM, start=start, strand=strand, events=ev,
            read_alignment=ev["base"], genome_alignment=ev["base"],
            clipped_start=0, clipped_end=0, num_insertions=0,
            num_deletions=0, num_matches=rl, num_mismatches=0)))
        if len(batch) == WRITE_BATCH:
            _write(batch)
            batch = []
    if batch:
        _write(batch)


def genome(seed=0, genome_len=None, n_sites=N_SITES):
    """(genome bases u8, the two strands' level tracks, planted sites) of
    a seed, drawn as the reference's tool draws them."""
    glen = GENOME_LEN if genome_len is None else genome_len
    rng = np.random.default_rng(seed)
    genome_arr = rng.choice(np.frombuffer(b"ACGT", np.uint8), glen)
    levels = [rng.normal(0.0, 1.0, glen), rng.normal(0.0, 1.0, glen)]
    planted = sorted(int(p) for p in
                     rng.choice(glen - 100, n_sites, replace=False) + 50)
    return genome_arr, levels, planted


def main(argv=None):
    import nanomod_tpu_torch
    from nanomod_tpu_torch.detect import run_detect

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", default=out_root("nanomod_scale"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profileDir", default=None)
    a = ap.parse_args(argv)
    # before generation: a warm arena keeps detect's pool build fast
    nanomod_tpu_torch.tune_malloc()
    root = a.out
    os.makedirs(root, exist_ok=True)
    genome_arr, levels, planted = genome(0)

    t0 = time.time()
    ctrl, case = os.path.join(root, "ctrl"), os.path.join(root, "case")
    if not os.path.isdir(ctrl):
        gen_group(ctrl, genome_arr, levels, np.random.default_rng(1))
        gen_group(case, genome_arr, levels, np.random.default_rng(2),
                  planted=planted)
    t_gen = time.time() - t0
    print(f"[scale] generated 2x{N_READS} reads x {READ_LEN} bases "
          f"({2 * N_READS * READ_LEN / 1e6:.0f}M events) in {t_gen:.0f}s, "
          f"rss {rss_gb():.1f} GB", flush=True)

    metrics = os.path.join(root, "out", "metrics.json")
    cfg = DetectConfig(
        wrk_base1=ctrl, wrk_base2=case,
        out_folder=os.path.join(root, "out"), file_id="scale",
        min_lr=0, rank=RankConfig(window=10),
        tile_positions=int(os.environ.get("SCALE_TILE", 16384)),
        pool_capacity=int(os.environ.get("SCALE_POOL_CAP", 0)),
        metrics_file=metrics, out_level=1, profile_dir=a.profileDir,
    )
    t0 = time.time()
    table, order, sites = run_detect(cfg, device=a.device)
    t_detect = time.time() - t0

    top50 = {(s.chrom, s.pos) for s in sites[:50]}
    found = sum(1 for p in planted if (CHROM, p) in top50)
    summary = {
        "genome_len": GENOME_LEN,
        "reads_per_group": N_READS,
        "read_len": READ_LEN,
        "device": a.device,
        "gen_wall_s": t_gen,
        "positions_tested": int(len(table)),
        "detect_wall_s": t_detect,
        "positions_per_s": len(table) / t_detect,
        **metrics_summary(metrics),
        "peak_rss_gb": rss_gb(),
        "planted_in_top50": f"{found}/{N_SITES}",
    }
    if a.profileDir:
        summary["trace"] = trace_busy_share(
            os.path.join(a.profileDir, "trace.rank0.json"))
    print("[scale] " + json.dumps(summary), flush=True)
    with open(os.path.join(root, "out", "scale_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
