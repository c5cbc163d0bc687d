"""Full chain at scale on the port: raw FAST5 -> Annotate -> detect, the
reference's tools/scale_fullchain.py.

Generates two groups of raw basecalled FAST5s (albacore2 event tables and
DAC signal, 3 % substitution / insertion / deletion errors) over a
synthetic 4.6 Mb genome, with 20 sites planted as pA level shifts in the
case group, written by the port's native raw writer
(native/fast5_rawwrite.cpp; no h5py), then runs on the port:

    Annotate (ingest -> events -> MAD normalize -> seed -> banded DP (K1)
              -> walk (K2) -> indel correction -> FAST5 write-back) x 2
    detect   (corrected ingest -> pools -> battery (K3) -> combine -> rank)

and reports the wall time of each stage, reads/s, positions/s, the
kernels' launches and the planted sites recovered in the top 50.  Every
draw is the reference tool's, in its order, so the genome, the planted
sites and each read's signal are the reference's.

    python -m nanomod_tpu_torch.tools.scale_fullchain [OUT] [--device cpu]
        [--profileDir DIR]

Env: FC_GENOME (4.6M), FC_READS (12000 a group), FC_READ_LEN (3000),
FC_ERR (0.03), FC_DELTA_PA (6); SCALE_CPU=1 makes the CPU the default
device.  OUT defaults to nanomod_fullchain under the temporary directory;
raw groups already there are annotated again, not regenerated.  With
--profileDir, Annotate of the control group and the detect each run under
torch.profiler (DIR/annotate, DIR/detect), and the summary gives their
device-busy shares.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from nanomod_tpu_torch.native.fast5_rawwrite_bind import ALBACORE2_EVENT_DTYPE
from nanomod_tpu_torch.tools.common import (metrics_summary, out_root, rss_gb,
                                            trace_busy_share)

GENOME_LEN = int(os.environ.get("FC_GENOME", 4_600_000))
N_READS = int(os.environ.get("FC_READS", 12_000))
READ_LEN = int(os.environ.get("FC_READ_LEN", 3_000))
ERR = float(os.environ.get("FC_ERR", 0.03))
DELTA_PA = float(os.environ.get("FC_DELTA_PA", 6.0))
N_SITES = 20
CHROM = "ecoli_syn"

DIGITISATION, RANGE, OFFSET, RATE = 8192.0, 1400.0, 10.0, 4000.0
BASES_U8 = np.frombuffer(b"ACGT", np.uint8)
WRITE_BATCH = 256
# K1 and K2's kernels in a trace (csrc/banded_sw.cu, csrc/walk.cu)
DP_KERNELS = ("banded_sw_kernel", "banded_sw_wide_kernel", "walk_kernel",
              "walk_wide_kernel")


def synth_read(seq_u8, lvl_tbl, rng, shift_pa=None):
    """One raw read of a true sequence (strand-oriented bases): the
    reference's synth_read, draw for draw.  Substitution, insertion and
    deletion errors at rate ERR, 5-mer levels plus ``shift_pa`` a true
    base, Poisson dwells and Gaussian noise.  Returns (dac int16, events,
    basecall bytes), or None below 50 bases."""
    L = len(seq_u8)
    r = rng.random(L)
    keep = r >= ERR / 3                                   # deletions
    codes = np.searchsorted(BASES_U8, seq_u8)
    shift = shift_pa
    codes = codes[keep]
    kept_shift = shift[keep] if shift is not None else None
    sub = rng.random(len(codes)) < ERR / 3                # substitutions
    codes = np.where(sub, rng.integers(0, 4, len(codes)), codes)
    # insertions: duplicate marked bases, the copy becomes a random base
    ins = rng.random(len(codes)) < ERR / 3
    rep = np.repeat(codes, 1 + ins)
    rep_shift = (np.repeat(kept_shift, 1 + ins) if kept_shift is not None
                 else None)
    dup_at = np.cumsum(1 + ins)[ins] - 1
    rep[dup_at] = rng.integers(0, 4, len(dup_at))
    bc_codes = rep
    n = len(bc_codes)
    if n < 50:
        return None

    pad = np.concatenate([np.zeros(2, np.int64), bc_codes,
                          np.zeros(2, np.int64)])
    k5 = (pad[:-4] * 256 + pad[1:-3] * 64 + pad[2:-2] * 16
          + pad[3:-1] * 4 + pad[4:])
    level = lvl_tbl[k5]
    if rep_shift is not None:
        level = level + rep_shift

    dwells = np.maximum(rng.poisson(9, n), 4).astype(np.int64)
    starts = np.zeros(n, np.uint64)
    starts[1:] = np.cumsum(dwells)[:-1]
    total = int(dwells.sum())
    sig = np.repeat(level, dwells) + rng.normal(0.0, 1.5, total)

    ev = np.zeros(n, ALBACORE2_EVENT_DTYPE)
    ev["start"] = starts
    ev["length"] = dwells
    ev["move"] = 1
    ev["move"][0] = 0
    edges = starts.astype(np.int64)
    s1 = np.add.reduceat(sig, edges)
    s2 = np.add.reduceat(sig * sig, edges)
    mean = s1 / dwells
    ev["mean"] = mean
    ev["stdv"] = np.sqrt(np.maximum(s2 / dwells - mean * mean, 0.0))
    bc_u8 = BASES_U8[bc_codes]
    padded = np.concatenate([np.full(2, ord("N"), np.uint8), bc_u8,
                             np.full(2, ord("N"), np.uint8)])
    win = np.lib.stride_tricks.sliding_window_view(padded, 5)
    ev["model_state"] = np.ascontiguousarray(win[:n]).view("S5").ravel()

    dac = np.round(sig * DIGITISATION / RANGE - OFFSET).astype(np.int16)
    return dac, ev, bc_u8.tobytes()


def raw_read(i, dac, ev, bc):
    """The raw file's content of read ``i`` (fast5_rawwrite_bind)."""
    return dict(read_number=i, read_id=f"read-{i:06d}", signal=dac,
                events=ev, fastq=b"@read-%06d\n%s\n+\n%s\n" % (
                    i, bc, b"!" * len(bc)),
                channel=(DIGITISATION, OFFSET, RANGE, RATE))


def gen_raw_group(folder, genome_u8, comp_u8, lvl_tbl, rng, planted=None):
    """Write one group of raw FAST5s (the reference's gen_raw_group, draw
    for draw) through the native raw writer; returns the files written."""
    from nanomod_tpu_torch.native.fast5_rawwrite_bind import write_raw_batch
    os.makedirs(folder, exist_ok=True)
    shift_fwd = None
    if planted is not None:
        shift_fwd = np.zeros(GENOME_LEN, np.float32)
        for p in planted:
            for off, sc in ((-1, 0.5), (0, 1.0), (1, 0.5)):
                if 0 <= p + off < GENOME_LEN:
                    shift_fwd[p + off] += DELTA_PA * sc
    n_written = 0
    paths, reads = [], []
    for i in range(N_READS):
        strand = "+-"[int(rng.integers(2))]
        start = int(rng.integers(0, GENOME_LEN - READ_LEN + 1))
        if strand == "+":
            seq = genome_u8[start: start + READ_LEN]
            shift = (shift_fwd[start: start + READ_LEN]
                     if shift_fwd is not None else None)
        else:
            seq = comp_u8[start: start + READ_LEN][::-1]
            shift = (shift_fwd[start: start + READ_LEN][::-1]
                     if shift_fwd is not None else None)
        out = synth_read(seq, lvl_tbl, rng, shift_pa=shift)
        if out is None:
            continue
        sub = os.path.join(folder, str(i // 4000))
        os.makedirs(sub, exist_ok=True)
        paths.append(os.path.join(sub, f"raw{i:06d}.fast5"))
        reads.append(raw_read(i, *out))
        if len(paths) == WRITE_BATCH:
            write_raw_batch(paths, reads)
            n_written += len(paths)
            paths, reads = [], []
    if paths:
        write_raw_batch(paths, reads)
        n_written += len(paths)
    return n_written


def genome():
    """(genome u8, its complement, the 5-mer level table, planted sites),
    drawn as the reference's tool draws them."""
    rng = np.random.default_rng(0)
    genome_u8 = rng.choice(BASES_U8, GENOME_LEN)
    comp_u8 = np.frombuffer(b"TGCA", np.uint8)[
        np.searchsorted(BASES_U8, genome_u8)]
    lvl_tbl = np.clip(rng.normal(100.0, 15.0, 1024), 55, 145)
    planted = sorted(int(p) for p in
                     rng.choice(GENOME_LEN - 100, N_SITES, replace=False) + 50)
    return genome_u8, comp_u8, lvl_tbl, planted


def make_dataset(root):
    """The reference FASTA and, unless present, the two raw groups under
    ``root``; returns (fasta path, ctrl, case, planted, files written or
    None, seconds)."""
    os.makedirs(root, exist_ok=True)
    genome_u8, comp_u8, lvl_tbl, planted = genome()
    fasta_p = os.path.join(root, "ref.fa")
    if not os.path.isfile(fasta_p):
        with open(fasta_p, "w") as f:
            f.write(f">{CHROM}\n")
            g = genome_u8.tobytes().decode()
            for lo in range(0, GENOME_LEN, 80):
                f.write(g[lo: lo + 80] + "\n")
    ctrl, case = os.path.join(root, "ctrl"), os.path.join(root, "case")
    t0 = time.time()
    written = None
    if not os.path.isdir(ctrl):
        written = [gen_raw_group(ctrl, genome_u8, comp_u8, lvl_tbl,
                                 np.random.default_rng(1)),
                   gen_raw_group(case, genome_u8, comp_u8, lvl_tbl,
                                 np.random.default_rng(2), planted=planted)]
    return fasta_p, ctrl, case, planted, written, time.time() - t0


def recall(sites, planted, close=4, top_n=50):
    top = np.array([s.pos for s in sites[:top_n] if s.chrom == CHROM],
                   np.int64)
    if len(top) == 0:
        return 0
    return sum(1 for p in planted if np.abs(top - p).min() <= close)


def main(argv=None):
    import nanomod_tpu_torch
    from nanomod_tpu_torch.config import (AnnotateConfig, DetectConfig,
                                          RankConfig)
    from nanomod_tpu_torch.detect import run_detect
    from nanomod_tpu_torch.io.fast5 import iter_fast5_files
    from nanomod_tpu_torch.kernels import build as kbuild
    from nanomod_tpu_torch.resquiggle.pipeline import annotate_files
    from nanomod_tpu_torch.utils.observe import device_trace

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", default=out_root("nanomod_fullchain"))
    ap.add_argument("--device",
                    default="cpu" if os.environ.get("SCALE_CPU") else "cuda")
    ap.add_argument("--profileDir", default=None)
    a = ap.parse_args(argv)
    nanomod_tpu_torch.tune_malloc()
    root = a.out
    fasta_p, ctrl, case, planted, written, t_gen = make_dataset(root)
    summary = {"genome_len": GENOME_LEN, "reads_per_group": N_READS,
               "read_len": READ_LEN, "error_rate": ERR,
               "delta_pa": DELTA_PA, "device": a.device,
               "generated": written, "gen_wall_s": t_gen}
    print("[fullchain] gen: " + json.dumps(summary), flush=True)

    acfg = AnnotateConfig(wrk_base1=ctrl, ref_fasta=fasta_p, out_level=2)
    for name, folder in (("annotate_ctrl", ctrl), ("annotate_case", case)):
        paths = list(iter_fast5_files(folder, recursive=True))
        trace = (os.path.join(a.profileDir, "annotate")
                 if a.profileDir and name == "annotate_ctrl" else None)
        kbuild.reset_launches()
        t0 = time.time()
        with device_trace(trace, a.device):
            n_ok, errors, _ = annotate_files(paths, acfg, device=a.device)
            if trace and a.device != "cpu":
                import torch
                torch.cuda.synchronize()
        dt = time.time() - t0
        summary[name] = {
            "reads": len(paths), "annotated": n_ok,
            "wall_s": dt, "reads_per_s": n_ok / dt,
            "errors": {k: len(v) for k, v in errors.items()},
            "kernel_launches": {k: v for k, v in
                                kbuild.launch_counts().items()
                                if k in ("banded_sw", "walk")},
        }
        if trace:
            summary[name]["trace"] = trace_busy_share(
                os.path.join(trace, "trace.rank0.json"), DP_KERNELS)
        print(f"[fullchain] {name}: " + json.dumps(summary[name]),
              flush=True)

    metrics = os.path.join(root, "out", "metrics.json")
    dcfg = DetectConfig(
        wrk_base1=ctrl, wrk_base2=case,
        out_folder=os.path.join(root, "out"), file_id="fullchain",
        min_lr=500, rank=RankConfig(window=10), out_level=2,
        metrics_file=metrics,
        profile_dir=(os.path.join(a.profileDir, "detect")
                     if a.profileDir else None))
    kbuild.reset_launches()
    t0 = time.time()
    table, order, sites = run_detect(dcfg, device=a.device)
    dt = time.time() - t0
    found = recall(sites, planted)
    summary["detect"] = {
        "positions_tested": int(len(table)),
        "wall_s": dt,
        "positions_per_s": len(table) / dt,
        **metrics_summary(metrics),
        "planted_in_top50": f"{found}/{N_SITES}",
    }
    if a.profileDir:
        summary["detect"]["trace"] = trace_busy_share(
            os.path.join(a.profileDir, "detect", "trace.rank0.json"))
    summary["peak_rss_gb"] = rss_gb()
    print("[fullchain] " + json.dumps(summary), flush=True)
    with open(os.path.join(root, "fullchain_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
