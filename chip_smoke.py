#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (nanomod_tpu_torch) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phase 0  prints the card (nvidia-smi name and power limit), the PyTorch and
         CUDA versions; builds the CUDA kernels (nvcc, sm_90a) and the
         native host libraries from the sources in the checkout.
Phase 1  K1 (banded DP) and K2 (the traceback walk, its codes one a byte
         and, where 2M+W is a multiple of 4, four a byte) against their
         plain PyTorch versions on the card: B = 256 synthetic reads
         (genome windows with ~5 % substitutions and indels, some reads
         shorter than their bucket, some N codes), W = 128, M = 1024 (the
         bucket of the main path's reads), 2048, 4096, 8192, and W = 130,
         100, K1's narrow/wide edge (NARROW_MAX_W, the narrow K1's widest
         band, one warp a read, and NARROW_MAX_W + 1, the wide kernel's
         narrowest, a block of warps a read under the launch plan of its
         width), 1024, 1025, 2048 and 4096 at M = 1024 (above 1024 also
         K2's windowed walk); then a batch rich in ties (tandem repeats
         whose best score is reached at several cells), an all-mismatch
         batch (best 0 at (0, 0)), a ragged B = 37, W = 32 and W = 1024 at
         M = 256, B = 37, M = 256 at W = 1, 4, 31, 33, 100, 130, 1000
         (off the grids of 32 and 4), and at M = 256 a batch, a tie batch
         and an all-mismatch batch at NARROW_MAX_W, + 1, + 2, 1024 and
         1025.  tb, best, best_i, best_k and both
         walk outputs must be array-equal, and K2's rows with the DP header
         (banded.walk_outputs, bests moved to x.5 and off it) byte-equal to
         pack_outputs of the walk in every mode.  Also B = 64, M = 4096 at
         W = 2048 and 4096 (K2's windowed walk there, timed beside its
         bound and its chain floor: the longest walk's steps times a
         dependent shared-memory load), K1 at W = 512 for B = 8 and B = 64,
         M = 4096, and at M = 256 either side of K1's batch threshold
         (FULL_BATCH - 1 and FULL_BATCH reads) at every plan row whose plan
         changes with the batch.  Each kernel's time is printed
         beside its bound (the plain versions timed at M = 1024) and the
         range of single launches recorded for the first kernels
         (PERF.md).
Phase 2  K3 (battery components) at detect scale: P = 1,048,576 positions
         in tiles of 16,384, counts 30..100 per group (capacity 128), int16
         milli values with heavy ties, rows with count 0 and 1, plus a tile
         at C1 = C2 = 645 and an f32 tile, then every hard-case tile of
         kernels/hardcases.py whole (16,384 rows; 512 at 645 + 645): NaN
         inside the valid prefix, -0.0 and +0.0, one tie run, one value a
         group, counts 0 and 1, full rows either side of K3's warp/block
         switch.  The rows must be array-equal to the plain version on the
         card and, int16 rows with both groups non-empty, to the native
         host battery; run_battery on the device must equal run_battery on
         the host backend.  One more device run_battery runs under
         torch.profiler: K3's summed device time, the device-busy share of
         the call and its top host operations.
Phase 3  the main path through its entry points: ``python -m
         nanomod_tpu_torch.cli Annotate`` on a control and a case group of
         raw FAST5s (nanomod_tpu_torch/smoke_data, each file copied 64 times:
         1,024 reads per group, so that the pipeline's DP batches are full,
         B = 256), then ``cli detect --device cuda``.  The planted site must rank first, every
         kernel's launch count (from the CLI's metrics file) must be above
         0, and the sign-test table must equal the one the native host
         battery gives on the same corrected files.  detect's plots:
         rplot_mod.pdf with pages where matplotlib imports, else the CLI's
         "not drawn" line.  Then ``cli detect --profileDir`` at genome
         scale, on two groups of corrected FAST5s written by the native
         writer (make_corrected_group: reads of 8,000 events, 12 a
         position and strand, on a 500,000-base genome: about 10^6
         positions, phase 2's P; a planted shift of 3 sd at 8 '+'
         positions): the planted site first, the table byte-equal to the
         native host battery's, K3's kernels in the trace, and the
         device-busy share of the whole run (the union of kernel and copy
         intervals over the traced span); ``annotate_folder`` at
         band_width 130 on 256 of the raw smoke reads (the walk in mode
         "codes") and at 2048 on 64 (mode "codes2", K1's block of warps a
         read), on the card and on the CPU: K1 and K2 launched, every
         corrected FAST5 byte-equal; the main path's Annotate (band width
         128, 256 smoke reads: a DP batch a length bucket) in process under
         torch.profiler: a DP batch's device operations are K1, K2 (which
         writes the rows the host fetches, header included), one
         host-to-device and one device-to-host copy, nothing else, and no
         pack_outputs runs; the reduced full chain: ``python -m
         nanomod_tpu_torch.tools.scale_fullchain --device cuda`` on raw
         FAST5s the native raw writer wrote (a 100,000-base genome, 400
         reads of 3 kb a group: M = 4096), 16 of its control reads
         annotated on the CPU byte-equal to the card's, its table
         byte-equal to the native host battery's;
         ``cli Annotate --resume 1 --device cuda`` over phase 3's
         corrected files: all already annotated, 0 to do, none rewritten.
Phase 4  K6 (coverage-capped KS) against its plain version on the card: one
         tile of P = 16,384 rows, int16 milli values with heavy ties,
         counts 60..645 per group in a 1,024-column capacity, cov = 100,
         R = 100, quantile 0.25, seed 0, row index from 2^20 (the plain
         version on the first 2,048 rows); a tile of capped and uncapped
         rows (counts 0, 1, cov, cov + 1), an f32 tile and an f32 tile with
         NaN padding, whole, and a tile at cov = 700 (one group of 650-1,000
         observations, the other at most 290), whole; then every K6
         hard-case tile of kernels/hardcases.py at the capped detect's
         shapes (1,024 x 512, cov = 200, R = 100), whole: NaN inside the
         valid prefix, -0.0 and +0.0, one tie run, every value distinct,
         counts 0, 1, cov and cov + 1, one group under cov and the other
         over.  Outputs must be array-equal, and K6's own threefry draws
         equal to the plain replica's.
Phase 5  the new entry points on phase 3's corrected groups: ``cli detect
         --coverages 200-200 --downsampling 100 --mstd 1`` (planted site
         first, K6 launched; sign-test and meanstd files byte-equal to the
         same command with NANOMOD_BATTERY_BACKEND=host), ``cli simulat2``,
         ``cli DownSampling`` and ``cli simulate`` (worker mode) writing
         their .output / .done files (simulate's hist_sim.png, or its "not
         drawn" line, as phase 3's plots), then ``run_simulate`` at the smoke
         site at 0.9 with each strand as the target: in every trial one of
         the two strands ranks 1, and every trial launches K3.  The capped
         detect's rank 1 must be spel - 501, as the JAX package ranks it
         on the same data (tests/test_torch_capped_smoke.py).
Phase 6  K6 at the main path's own shapes: the capped detect again, in
         process, with K6's wrapper recording its inputs (cov = 200, the
         widths detect gives) and timing each launch with CUDA events
         inside the run; K6 against its plain version on those tensors,
         whole, both timed.  The kernels line gives K6's times at that
         input; its bound is printed beside the draws' share of it.
Phase 7  the multi-device and multi-process paths.  (a) K7, the neighbor
         stencil step, against its plain version (halo blocks, then a
         stencil a shard) on the card: P = 1,048,576 positions in 4 shards
         of a mesh of cuda:0 four times, k = 2 and 5, cov 0 and 200, two
         joins (positions start again inside a shard), capped rows beside
         uncapped ones, padding rows, the mesh's edges; array-equal, one
         launch a step, and equal to the route for cards without peer
         access forced on one card (each neighbour's edge columns copied
         first, then read at their own offset; its step timed too); no
         device operation but K7's kernel, at most
         once a step, in the profiler's trace of 100 steps; K7's device
         time, mean10, single launches and the step through
         sharded_stencil.  (b) K9, the event accumulation, against its
         plain version and against index_add_:
         a genome of 4,641,652 positions (E. coli K-12's length), 2^22
         events, 10 % not ok, at uniform positions and as
         distributed_detect_step gets them (read-major: 4,096 reads of
         1,024 consecutive positions, one or two events a base); counts
         equal, sums within rtol 1e-5 and atol 1e-5; device time, mean10,
         single, bound and index_add_ at both.  (c) sharded_join_battery on
         the 4-shard mesh against run_battery + combine_neighbor_pvalues
         at phase 2's P = 1,048,576, without and with a cap of 60 (phase
         2's counts are 30-100): every float64 column bit-equal.  (d) the
         in-process sharded detect (run_detect with the 4-shard mesh) on
         phase 3's groups, stouffer, fisher, ks and ``--coverages 200-200
         --mstd 1``: the tables byte-equal to the single-device ones
         (phases 3 and 5); then distributed_detect_step on the mesh (data
         2) at the genome and read-major events of (b), its counts against
         K9's plain version and its D against the plain pooled components.
         The counts are set to 0 before each and read after: K7 and K9 must
         have launched.  (e) two processes on the card through
         ``torch.distributed.run --standalone --nproc_per_node 2``: ``cli
         detect --device cuda`` (union, and sharded with --coverages
         200-200 --mstd 1) byte-equal to phases 3 and 5, K3 (and K6)
         launched in every rank's metrics file; ``cli Annotate`` on fresh
         copies of the raw smoke groups: every corrected FAST5 byte-equal
         to phase 3's, each rank reporting the merged ok count.  (f)
         pooled_rank_components on the pooled layout of
         distributed_detect_step (65,536 x 64 over the 4 shards), one
         launch of K3's pooled entry a shard: held to its plain version
         there and on the pooled hard cases of kernels/hardcases.py (d
         bit-equal, NaN equal to NaN), timed beside its bound and the
         plain version; under torch.profiler its only device operation
         is the pooled kernel (its device time a launch).
Phase 8  (a) the external aligner: a fake ``minimap2`` (the tests' own, an
         exact-substring aligner writing SAM) at the front of PATH, then
         ``cli Annotate --alignStr minimap2`` with ``--device cuda`` and
         ``--device cpu`` on copies of the raw smoke groups: every
         corrected FAST5 byte-equal between the two; ``cli detect --device
         cuda`` on the externally aligned groups (planted site first, K3
         launched).  Where a real minimap2 or bwa is on PATH it also
         annotates the control group once and prints its ok count.  (b)
         the bench, ``nanomod_tpu_torch.bench``'s main at its default
         sizes (200,000 battery positions, 512 raw reads of 2 kb, the
         e2e detect on a 4,000-base genome), in process with the launch
         counts set to 0 before it: its JSON line printed, the planted
         site (4000 // 3) first, 512 reads annotated, K1, K2 and K3
         launched.

Kernel times are medians of 3 samples after one warm-up, each sample 10
back-to-back calls between two CUDA events, divided by 10 (the ``ms`` of
the kernels line); each kernel is also timed as single launches, one call
between two events (``single_ms``, the yardstick of the times recorded
for the first kernels, which includes the host's launch overhead); a plain
version's time
is one run after its comparison run.  Each kernel's bound is the larger of
the bytes it must move (inputs read once, outputs written once; for the
walk, the cells this run's walks visit) over 3.35 TB/s and its operations
over their type's peak (f32 67 TFLOP/s, INT32 33.5 TOP/s; an H100 SXM at
700 W); the battery kernels count the operations of a sort-and-merge
evaluation, not their own pairwise compares.  Any failure raises (non-zero
exit), and so does a module of the JAX package found loaded at the end.
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel.
"""

import functools
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
DEEP_BATTERY_P = 512         # rows of the capacity-1,024 tiles (645 + 645)
COPIES = 64
SMOKE_MOD_POS = 500          # smoke_data/make_smoke_data.py MOD_POS
CAPPED_P = 16384
CAPPED_CAP = 1024
CAPPED_COV = 100
CAPPED_R = 100
CAPPED_Q = 25                # int(100 * 0.25)
CAPPED_PLAIN_ROWS = 2048
CAPPED_ROW0 = 1 << 20
# phase 4's hard-case tiles: the capped detect's width and cap
HARD_K6_P = 1024
HARD_K6_WIDTH = 512
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
# band widths off the grid of 32 (K1's ragged last thread) and of 4 (the
# walk's codes one a byte): at B = 37, M = 256, and two at the main shape
DP_OFF_GRID = (1, 4, 31, 33, 100, 130, 1000)
DP_OFF_GRID_MAIN = (130, 100)
# band widths above 1024 (K1: a block of warps a read, ragged at 1025; K2:
# the windowed walk, both modes at 2048 and 4096) at the main shape; beside
# them K1 either side of its narrow/wide edge (resquiggle/banded_kernel.py
# NARROW_MAX_W: the narrow kernel's widest band and the wide kernel's
# narrowest) and at 1024
DP_WIDE = (1025, 2048, 4096)
# the windowed walk (and K1) at tools/bench_dp_buckets.py's bucket, B 64 x
# M 4096, and K1 at W 512 where its launch plan depends on the batch: (B,
# M, W)
DP_LONG = ((64, 4096, 2048), (64, 4096, 4096))
DP_K1_BATCH = ((8, 1024, 512), (64, 4096, 512))
# a dependent shared-memory load on one H100 at 700 W, load to use, SM
# clocks (kernels/k1_plans.py lds_chain): the step chain of K2's walk is
# at least one such load a step, at the SM's 1.98 GHz
SMEM_LOAD_CLOCKS = 23
SM_CLOCK_HZ = 1.98e9
# the bests' fractional parts in phase 1's header checks (round half to
# even), cycled over a batch
HALF_BESTS = (0.5, -0.5, 1.5, 2.5, 0.0, -1.5)
# the traced Annotate: copies of each smoke read (16 reads, 256 in all)
TRACED_ANNOTATE_COPIES = 16
# phase 4's tile above the old cap of 645: widths, rows, cov
DEEP_CAPS = (1000, 290)
DEEP_P = 256
DEEP_COV = 700
# the first K1 and K2 (one block of W threads a read; one thread a walk) at
# the main path's shape on one H100 (PERF.md), ms, single launches (the
# yardstick of time_ms(..., n=1))
RECORDED_MS = {"banded_sw": (0.656, 0.677), "walk": (0.592, 0.611)}
# an H100 SXM's published peaks at 700 W: HBM3 rate, dense f32 outside the
# tensor cores.  INT32 is not in the data sheet: an SM issues at most four
# warp instructions a clock (128 lanes), and 32-bit integer adds and logic
# run on its 64 INT32 lanes and, as IMAD, on its FMA lanes, so 128 lanes x
# 132 SMs x 1.98 GHz (the clock at which 128 f32 lanes give 67 TFLOP/s) is
# the ceiling.  64 lanes an SM is no ceiling: K6's draws run faster.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
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
# integer operations a threefry2x32 block: 20 rounds of add, rotate and
# xor, 12 key-injection adds and the xor of the two output words; two
# blocks a drawn index
THREEFRY_OPS = 73
# phase 7: K7's shards and windows, the cap of its capped rows; K9's genome
# (E. coli K-12 MG1655, 4,641,652 bp) and events; the cap of (c)
MESH_SHARDS = 4
STENCIL_KS = (2, 5)
STENCIL_COV = 200
GENOME_LEN = 4_641_652
EVENTS = 1 << 22
READ_LEN = 1024
SHARDED_COV = 60
# K7's integer operations a written entry (selection, halo pick, the
# distance and validity tests); K9's f32 operations an event kept (three
# adds and a multiply)
K7_OPS = 12
K9_OPS = 4
TORCHRUN_TIMEOUT = 600
# phase 8: copies of each raw smoke read in the external-aligner groups (16
# reads a group, 256 a group in all); the bench's planted site and reads
# at its default sizes (nanomod_tpu_torch/bench.py)
EXT_COPIES = 16
BENCH_SITE = 4000 // 3
BENCH_READS = 512
# phase 3's Annotate at other band widths, {W: reads}: off the grids (130:
# 2M+W not a multiple of 4, the unpacked walk; 16 smoke reads, 16 copies
# each) and above 1024 (2048: K1's block of warps a read, K2's windowed
# walk; 4 copies each, as the CPU's run is slower there)
ANNOTATE_WIDTHS = {130: 256, 2048: 64}
# the reduced full chain (tools/scale_fullchain.py): its genome, reads a
# group and read length (M = 4096), and the control reads also annotated
# on the CPU
FULLCHAIN_ENV = {"FC_GENOME": "100000", "FC_READS": "400",
                 "FC_READ_LEN": "3000"}
FULLCHAIN_CPU_READS = 16
# the traced detect at genome scale: a synthetic genome of TRACE_GENOME
# positions, corrected reads of TRACE_READ_LEN events (a nanopore read's
# length) at TRACE_COVERAGE reads a position, strand and group, so that
# about 2 x TRACE_GENOME positions (phase 2's P) pass the coverage filter.
# The case group's '+' strand is shifted by TRACE_SHIFT (its noise has sd
# 1) at TRACE_SITE_LEN positions from TRACE_SITE: rank 1 must lie there.
TRACE_GENOME = 500_000
TRACE_READ_LEN = 8_000
TRACE_COVERAGE = 12
TRACE_SITE = 250_000
TRACE_SITE_LEN = 8
TRACE_SHIFT = 3.0
TRACE_WRITE_BATCH = 256

# the tests' fake minimap2 (tests/test_external_align.py; the same text,
# held equal by tests/test_torch_external.py), written into a bin/ at the
# front of PATH for phase 8
FAKE_MINIMAP2 = '''#!/usr/bin/env python3
"""Fake minimap2: exact/approximate substring alignment, SAM to stdout.

Usage (what the engine invokes): minimap2 -ax map-ont ref.fa reads.fa
"""
import sys


def revcomp(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def read_fasta(path):
    seqs, name = {}, None
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            name = line[1:].split()[0]
            seqs[name] = []
        elif name:
            seqs[name].append(line)
    return {k: "".join(v) for k, v in seqs.items()}


ref = read_fasta(sys.argv[-2])
reads = read_fasta(sys.argv[-1])
print("@HD\\tVN:1.6")
for chrom, seq in ref.items():
    print(f"@SQ\\tSN:{chrom}\\tLN:{len(seq)}")
for rid, rseq in reads.items():
    hit = None
    # anchor on a 24-mer from the middle of the read, allow mismatches
    k = 24
    mid = len(rseq) // 2
    for flag, oriented in ((0, rseq), (16, revcomp(rseq))):
        kmer = oriented[mid - k // 2: mid + k // 2]
        for chrom, g in ref.items():
            p = g.find(kmer)
            if p >= 0:
                start = p - (mid - k // 2)
                if 0 <= start and start + len(oriented) <= len(g):
                    hit = (flag, chrom, start, oriented)
                break
        if hit:
            break
    if hit is None:
        print(f"{rid}\\t4\\t*\\t0\\t0\\t*\\t*\\t0\\t0\\t{rseq}\\t*")
        continue
    flag, chrom, start, oriented = hit
    cigar = f"{len(oriented)}M"
    print(f"{rid}\\t{flag}\\t{chrom}\\t{start + 1}\\t60\\t{cigar}\\t*\\t0\\t0"
          f"\\t{oriented}\\t*")
'''


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


def k2_work(torch, codes, packed=True, header=False):
    """K2's bytes for this run's walks (a tb byte a step taken, best_i and
    best_k, the codes written: four a byte when ``packed``, else one; with
    ``header`` also best read and the 12-byte header written a read) and
    integer operations.  The steps are the non-zero codes plus at most one
    stop step a read."""
    written = codes.numel() + (16 * codes.shape[0] if header else 0)
    if packed:
        shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                              device=codes.device)
        codes = (codes[..., None] >> shifts) & 3
    steps = int(codes.ne(0).sum()) + codes.shape[0]
    return dict(bytes_moved=steps + 8 * codes.shape[0] + written,
                int_ops=K2_OPS_PER_STEP * steps)


def sort_compares(torch, n):
    """n log2 n a group of n values (0 for n <= 1), as int64 per row."""
    n = n.to(torch.float64)
    return (n * torch.log2(n.clamp(min=1))).to(torch.int64)


def ops_of(values, n):
    """{"f32_ops" or "int_ops": n}: compares of f32 values count at the f32
    peak, of int16 values at the INT32 peak."""
    return {"f32_ops" if values.is_floating_point() else "int_ops": n}


def k3_work(torch, v1, n1, v2, n2, milli=True):
    """K3's bytes (values and counts read, 9 [P] int32 rows written, 3
    without the milli moments) and the operations of a sort-and-merge
    evaluation of every row."""
    c1 = n1.to(torch.int64).clamp(0, v1.shape[1])
    c2 = n2.to(torch.int64).clamp(0, v2.shape[1])
    per_value = WALK_KS_OPS + WALK_RANK_OPS + (MILLI_MOMENT_OPS if milli
                                               else 0)
    ops = int((sort_compares(torch, c1) + sort_compares(torch, c2)
               + per_value * (c1 + c2)).sum())
    return dict(bytes_moved=v1.nbytes + v2.nbytes + n1.nbytes + n2.nbytes
                + (36 if milli else 12) * n1.shape[0], **ops_of(v1, ops))


def k3_hard_cases(torch, dev, kernels, battery):
    """K3 on every hard-case tile (kernels/hardcases.py) at the main path's
    shapes, whole: array-equal to its plain version, and int16 rows with
    both groups non-empty to the native host battery.  Returns the tiles'
    shapes."""
    from nanomod_tpu_torch.kernels import hardcases
    shapes = {}
    for case in hardcases.K3_CASES:
        p = DEEP_BATTERY_P if case == "deep_645" else BATTERY_TILE
        arrays = hardcases.k3_tile(case, p, seed=len(case))
        t = [torch.from_numpy(x).to(dev) for x in arrays]
        milli = case not in hardcases.F32_CASES
        got = kernels.battery_rows_cuda(*t, milli=milli)
        if not torch.equal(got, kernels.battery_rows_plain(*t, milli=milli)):
            raise AssertionError(f"K3 differs from plain on the {case} tile")
        if milli:
            v1, n1, v2, n2 = arrays
            comp = battery.milli_components(got.cpu().numpy())
            both = (n1 > 0) & (n2 > 0)
            for key, want in battery.host_components(*arrays).items():
                if not np.array_equal(comp[key][both], want[both]):
                    raise AssertionError(f"K3 {key} differs from the host "
                                         f"battery on the {case} tile")
        shapes[case] = [list(arrays[0].shape), list(arrays[2].shape)]
    return shapes


def _device_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0))


def profile_run_battery(torch, battery, kernels, args, dev):
    """One device run_battery under torch.profiler (CPU and CUDA
    activities): K3's summed device time, the device-busy share of the
    call (summed device time of every kernel and copy over its wall time)
    and the top host operations by self CPU time.  The numpy work that
    the profiler does not see is timed by host clocks around run_battery's
    steps (``host_s``, summed over the calls; encode runs on four threads).
    Where the trace holds no device time, CUDA events around each K3
    launch and the host clock give K3's time and the call's."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    steps = {"encode": "_tile_slice", "to_device": "to_device_tile",
             "finalize": "finalize_packed", "to_pinned": "_to_pinned"}
    host_s = dict.fromkeys(steps, 0.0)
    originals = {step: getattr(battery, name) for step, name in steps.items()}

    def clocked(step):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return originals[step](*a, **kw)
            finally:
                host_s[step] += time.perf_counter() - t
        return call

    torch.cuda.synchronize()
    for step, name in steps.items():
        setattr(battery, name, clocked(step))
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            battery.run_battery(*args, device=dev,
                                tile_positions=BATTERY_TILE)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        for step, name in steps.items():
            setattr(battery, name, originals[step])
    avgs = prof.key_averages()
    device_us = sum(_device_us(e) for e in avgs)
    k3 = [e for e in avgs if "battery_warp" in e.key
          or "battery_block" in e.key]
    top = sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)
    res = {"wall_s": wall_s, "source": "torch.profiler", "host_s": host_s,
           "device_ms": device_us / 1e3,
           "k3_device_ms": sum(_device_us(e) for e in k3) / 1e3,
           "k3_launches": sum(e.count for e in k3),
           "device_busy_share": device_us / 1e6 / wall_s,
           "top_device": [[e.key[:60], _device_us(e) / 1e3, e.count]
                          for e in sorted(avgs, key=_device_us,
                                          reverse=True)[:6]],
           "top_host": [[e.key[:60], e.self_cpu_time_total / 1e3, e.count]
                        for e in top[:10]]}
    if device_us > 0:
        return res
    launch = kernels.battery_rows_cuda
    events = []

    def timed(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = launch(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    kernels.battery_rows_cuda = timed
    try:
        t0 = time.perf_counter()
        battery.run_battery(*args, device=dev, tile_positions=BATTERY_TILE)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        kernels.battery_rows_cuda = launch
    k3_ms = sum(a.elapsed_time(b) for a, b in events)
    res.update(source="CUDA events (the trace held no device time)",
               wall_s=wall_s, k3_device_ms=k3_ms, k3_launches=len(events),
               device_busy_share=k3_ms / 1e3 / wall_s)
    return res


def dp_check(torch, banded, banded_sw_cuda, read, ref, lens, what):
    """K1 and K2 against their plain versions on one batch (array-equal):
    the walk's codes one a byte and, where 2M+W is a multiple of 4, four a
    byte.  Returns K1's outputs and the two max abs errors."""
    k_out = banded_sw_cuda(read, ref, lens)
    p_out = banded.banded_sw_plain(read, ref, lens)
    torch.cuda.synchronize()
    for name, a, b in zip(("tb", "best", "best_i", "best_k"), k_out, p_out):
        if not torch.equal(a, b):
            raise AssertionError(f"K1 {name} differs from plain: {what}")
    tb, _, bi, bk = k_out
    codes = banded.walk_device_plain(tb, bi, bk)
    pairs = [(banded.walk(tb, bi, bk, packed=False)[0], codes)]
    if codes.shape[1] % 4 == 0:
        pairs.append((banded.walk(tb, bi, bk, packed=True)[0],
                      banded.pack_codes2(codes)))
    for (ck, cp), mode in zip(pairs, ("codes", "codes2")):
        if not torch.equal(ck, cp):
            raise AssertionError(f"K2 {mode} differ from plain: {what}")
    # K2 with the DP header (bests moved to x.5 and off it): the rows of
    # pack_outputs, byte for byte
    half = torch.tensor(HALF_BESTS, dtype=torch.float32, device=tb.device)
    hb = k_out[1] + half.repeat(len(bi) // len(HALF_BESTS) + 1)[:len(bi)]
    for (_, cp), packed in list(zip(pairs, (False, True))):
        rows = banded.walk_outputs(tb, hb, bi, bk, packed=packed)[0]
        want = banded.pack_outputs(cp, hb, bi, bk)
        if not torch.equal(rows, want):
            raise AssertionError(f"K2's header rows differ from "
                                 f"pack_outputs (packed={packed}): {what}")
        pairs.append((rows, want))
    return (k_out, max_abs_err(torch, zip(k_out, p_out)),
            max_abs_err(torch, pairs))


def walk_chain_floor(torch, codes, packed):
    """The walk's chain floor: the longest walk's steps (its non-zero codes
    and one stop step) times a dependent shared-memory load, in ms."""
    if packed:
        shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                              device=codes.device)
        codes = (codes[..., None] >> shifts) & 3
    steps = int(codes.reshape(codes.shape[0], -1).ne(0).sum(1).max()) + 1
    return {"longest_walk_steps": steps,
            "chain_floor_ms": steps * SMEM_LOAD_CLOCKS / SM_CLOCK_HZ * 1e3}


def k1_batch_edges():
    """(B, W) pairs either side of K1's batch threshold (FULL_BATCH), at
    the widest band of every plan row whose plan changes with the batch
    (to W 4096)."""
    from nanomod_tpu_torch.resquiggle.banded_kernel import (FULL_BATCH,
                                                            WIDE_PLANS)
    return [(b, max_w) for max_w, part, full in WIDE_PLANS
            if part != full and max_w <= 4096
            for b in (FULL_BATCH - 1, FULL_BATCH)]


def k1_edge_widths(past=1):
    """K1's narrow/wide edge: the narrow kernel's widest band
    (NARROW_MAX_W) and the wide kernel's first ``past`` bands, and 1024
    (the widest band one warp can hold), in order."""
    from nanomod_tpu_torch.resquiggle.banded_kernel import NARROW_MAX_W
    return sorted({NARROW_MAX_W, 1024}
                  | {NARROW_MAX_W + i for i in range(1, past + 1)})


def phase1(torch, dev):
    from nanomod_tpu_torch.resquiggle import banded
    from nanomod_tpu_torch.resquiggle.banded_kernel import banded_sw_cuda
    rng = np.random.default_rng(0)

    def on_card(arrays):
        return [torch.from_numpy(x).to(dev) for x in arrays]

    out = {"k1_widths": k1_edge_widths() + [
        w for w in DP_WIDE if w not in k1_edge_widths()]}
    main = [(m, W) for m in DP_BUCKETS] \
        + [(MAIN_PATH_BUCKET, w)
           for w in DP_OFF_GRID_MAIN + tuple(out["k1_widths"])]
    for m, w in main:
        read, ref, lens = on_card(synth_reads(rng, DP_BATCH, m, w))
        k_out, e1, e2 = dp_check(torch, banded, banded_sw_cuda, read, ref,
                                 lens, f"M={m} W={w}")
        tb, _, bi, bk = k_out
        # the walk in the pipeline's mode
        ck, packed = banded.walk(tb, bi, bk)
        walk_plain = (banded.walk_packed_plain if packed
                      else banded.walk_device_plain)
        best = k_out[1]
        k1 = lambda: banded_sw_cuda(read, ref, lens)  # noqa: E731
        k2 = lambda: banded.walk(tb, bi, bk)  # noqa: E731
        # the main path's K2: the walk and the DP header in one launch
        k2h = lambda: banded.walk_outputs(tb, best, bi, bk)  # noqa: E731
        res = {
            "M": m, "B": DP_BATCH, "W": w,
            "walk_mode": "codes2" if packed else "codes",
            "k1_max_abs_err": e1, "k2_max_abs_err": e2,
            "k1_ms": time_ms(torch, k1),
            "k1_single_ms": time_ms(torch, k1, n=1),
            "k2_ms": time_ms(torch, k2),
            "k2_single_ms": time_ms(torch, k2, n=1),
            "k2h_ms": time_ms(torch, k2h),
            "k2h_single_ms": time_ms(torch, k2h, n=1),
            # the parent's path: the walk, then pack_outputs' PyTorch ops
            "k2_pack_ms": time_ms(torch, lambda: banded.pack_outputs(
                k2()[0], best, bi, bk)),
            "mean_best": float(k_out[1].mean()),
        }
        if m == MAIN_PATH_BUCKET:
            # the plain versions are timed at the main path's bucket only
            res["k1_plain_ms"] = time_ms(
                torch, lambda: banded.banded_sw_plain(read, ref, lens),
                **PLAIN_TIMING)
            res["k2_plain_ms"] = time_ms(
                torch, lambda: walk_plain(tb, bi, bk), **PLAIN_TIMING)
            res["k2h_plain_ms"] = time_ms(
                torch, lambda: banded.pack_outputs(walk_plain(tb, bi, bk),
                                                   best, bi, bk),
                **PLAIN_TIMING)
        res["k1_bound_ms"], res["k1_bound_by"] = bound(**k1_work(read, ref,
                                                                 tb))
        res["k2_bound_ms"], res["k2_bound_by"] = bound(**k2_work(
            torch, ck, packed=res["walk_mode"] == "codes2"))
        res["k2h_bound_ms"], res["k2h_bound_by"] = bound(**k2_work(
            torch, ck, packed=res["walk_mode"] == "codes2", header=True))
        res.update(walk_chain_floor(torch, ck, packed))
        log("phase1", json.dumps(res))
        if (m, w) == (MAIN_PATH_BUCKET, W):
            for name, key in (("banded_sw", "k1"), ("walk", "k2")):
                lo, hi = RECORDED_MS[name]
                log(f"phase1 {name} at B {DP_BATCH}, M {m}, W {w}: single "
                    f"launch {res[key + '_single_ms']:.4f} ms (first "
                    f"kernel, single launches: {lo}-{hi} ms), 10-launch mean "
                    f"{res[key + '_ms']:.4f} ms, bound "
                    f"{res[key + '_bound_ms']:.6f} ms "
                    f"({res[key + '_bound_by']})")
        out[m if w == W else f"W{w}"] = res

    # the windowed walk at B 64 x M 4096 and K1 where its plan depends on
    # the batch: both against their plain versions, timed beside their
    # bounds (and the walk beside its chain floor)
    for b, m, w in DP_LONG + DP_K1_BATCH:
        read, ref, lens = on_card(synth_reads(rng, b, m, w))
        k_out, e1, e2 = dp_check(torch, banded, banded_sw_cuda, read, ref,
                                 lens, f"B={b} M={m} W={w}")
        tb, best, bi, bk = k_out
        ck, packed = banded.walk(tb, bi, bk)
        res = {"B": b, "M": m, "W": w, "k1_max_abs_err": e1,
               "k2_max_abs_err": e2,
               "k1_ms": time_ms(torch, lambda: banded_sw_cuda(read, ref,
                                                              lens))}
        res["k1_bound_ms"], res["k1_bound_by"] = bound(**k1_work(read, ref,
                                                                 tb))
        if (b, m, w) in DP_LONG:
            res["k2h_ms"] = time_ms(torch, lambda: banded.walk_outputs(
                tb, best, bi, bk))
            res["k2h_single_ms"] = time_ms(torch, lambda: banded.walk_outputs(
                tb, best, bi, bk), n=1)
            res["k2h_bound_ms"], res["k2h_bound_by"] = bound(**k2_work(
                torch, ck, packed=packed, header=True))
            res.update(walk_chain_floor(torch, ck, packed))
        log("phase1 batch", json.dumps(res))
        out[f"B{b}_M{m}_W{w}"] = res

    extra = {
        "ties": (tie_reads(rng, DP_BATCH, MAIN_PATH_BUCKET, W), W),
        "all_mismatch": (mismatch_reads(rng, DP_BATCH, MAIN_PATH_BUCKET, W),
                         W),
        f"ragged_B{DP_RAGGED_B}": (synth_reads(rng, DP_RAGGED_B, DP_SMALL_M,
                                              W), W),
        "W32": (synth_reads(rng, DP_BATCH, DP_SMALL_M, 32), 32),
        "W1024": (synth_reads(rng, DP_BATCH, DP_SMALL_M, 1024), 1024),
    }
    for w in DP_OFF_GRID:
        extra[f"W{w}_B{DP_RAGGED_B}"] = (
            synth_reads(rng, DP_RAGGED_B, DP_SMALL_M, w), w)
    # K1's narrow/wide edge: the last narrow band, the first two wide ones,
    # 1024 and 1025, each with a batch of ties and an all-mismatch batch
    for w in sorted(set(k1_edge_widths(2)) | {1024, 1025}):
        extra[f"edge_W{w}"] = (synth_reads(rng, DP_BATCH, DP_SMALL_M, w), w)
        extra[f"edge_ties_W{w}"] = (tie_reads(rng, DP_BATCH, DP_SMALL_M, w),
                                    w)
        extra[f"edge_all_mismatch_W{w}"] = (
            mismatch_reads(rng, DP_BATCH, DP_SMALL_M, w), w)
    # K1's plans by batch: either side of the threshold where they differ
    for b, w in k1_batch_edges():
        extra[f"batch_B{b}_W{w}"] = (synth_reads(rng, b, DP_SMALL_M, w), w)
    errs = {}
    for what, (arrays, w) in extra.items():
        read, ref, lens = on_card(arrays)
        k_out, e1, e2 = dp_check(torch, banded, banded_sw_cuda, read, ref,
                                 lens, what)
        best, bi, bk = (x.cpu().numpy() for x in k_out[1:])
        if "all_mismatch" in what and (best.any() or bi.any() or bk.any()):
            raise AssertionError(f"{what}: best must be 0 at (0, 0)")
        if "ties" in what and best.min() <= 0:
            raise AssertionError(f"{what}: every read must score")
        tb = k_out[0]
        errs[what] = {"k1_max_abs_err": e1, "k2_max_abs_err": e2,
                      "W": w, "B": len(best), "M": read.shape[1],
                      "max_best": float(best.max()),
                      "k1_ms": time_ms(torch, lambda: banded_sw_cuda(
                          read, ref, lens)),
                      "k2_ms": time_ms(torch, lambda: banded.walk(
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
    d1 = (rng.integers(-8, 9, (DEEP_BATTERY_P, 1024)) * 125).astype(np.int16)
    d2 = (rng.integers(-8, 9, (DEEP_BATTERY_P, 1024)) * 125).astype(np.int16)
    dc = np.full(DEEP_BATTERY_P, 645, np.int32)
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
    hard = k3_hard_cases(torch, dev, kernels, battery)

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
    # the f32 tile (rank rows only) and the capacity-1,024 tile at 645 + 645
    others = {}
    for what, args, milli in (("f32", fl, False), ("deep", deep, True)):
        kern = functools.partial(kernels.battery_rows_cuda, *args, milli=milli)
        plain = functools.partial(kernels.battery_rows_plain, *args,
                                  milli=milli)
        others[what] = {
            "ms": time_ms(torch, kern), "single_ms": time_ms(torch, kern, n=1),
            "plain_ms": time_ms(torch, plain),
            "bound": bound(**k3_work(torch, *args, milli=milli))}

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
    trace = profile_run_battery(torch, battery, kernels,
                                (pools1, m1, pools2, m2), dev)
    log("phase2 run_battery trace", json.dumps(trace))
    res = {
        "P": p, "tile": BATTERY_TILE, "cap": c,
        "k3_max_abs_err": max_abs_err(torch, [(rows_k, rows_p)]),
        "k3_ms": k_ms, "k3_plain_ms": p_ms, "host_components_ms": host_s * 1e3,
        "k3_tile_ms": tile_ms, "k3_tile_single_ms": tile_single_ms,
        "k3_tile_plain_ms": tile_plain_ms,
        "k3_tile_bound_ms": tile_bound[0], "k3_tile_bound_by": tile_bound[1],
        "hard_case_tiles": hard,
        **{f"k3_{what}_{key}": v for what, o in others.items()
           for key, v in (("ms", o["ms"]), ("single_ms", o["single_ms"]),
                          ("plain_ms", o["plain_ms"]),
                          ("bound_ms", o["bound"][0]),
                          ("bound_by", o["bound"][1]))},
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


def _copy_group(src, dst, copies):
    """Copy each FAST5 of ``src`` ``copies`` times into a new ``dst``
    (<stem>_<k>.fast5)."""
    os.makedirs(dst)
    for name in sorted(os.listdir(src)):
        stem = name[: -len(".fast5")]
        for k in range(copies):
            shutil.copyfile(os.path.join(src, name),
                            os.path.join(dst, f"{stem}_{k:02d}.fast5"))


def phase3(torch, dev, tmp):
    from nanomod_tpu_torch.config import DetectConfig, RankConfig
    from nanomod_tpu_torch.detect import run_detect
    data = os.path.join(ROOT, "nanomod_tpu_torch", "smoke_data")
    env = _env()
    groups = {}
    for group in ("ctrl", "case"):
        groups[group] = os.path.join(tmp, group)
        _copy_group(os.path.join(data, group), groups[group], COPIES)
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
    plot = check_drawn(out, os.path.join(out_dir, "rplot_mod.pdf"))
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
        "launches": launches, "rplot": plot,
        "reads_ok": {g: metrics[f"annotate_{g}"]["reads_ok"] for g in groups},
        "stages": {k: {s: v["seconds"] for s, v in m["stages"].items()}
                   for k, m in metrics.items()},
    }
    log("phase3", json.dumps(res))
    return res, groups


def can_plot() -> bool:
    """Whether matplotlib imports here, as the CLI decides it."""
    import importlib.util
    return importlib.util.find_spec("matplotlib") is not None


def check_drawn(stdout, path):
    """A plot the CLI draws: where matplotlib imports, the file (a PDF
    with at least one page); where it does not, the CLI's one line that
    says so."""
    name = os.path.basename(path)
    if not can_plot():
        line = f"{name} not drawn: matplotlib is not installed"
        if line not in stdout:
            raise AssertionError(f"no line {line!r} in the CLI's output")
        return "not drawn (no matplotlib)"
    data = _read_bytes(path)
    if path.endswith(".pdf"):
        pages = data.count(b"/Type /Page") - data.count(b"/Type /Pages")
        if pages < 1:
            raise AssertionError(f"{name} has no page")
        return f"{pages} pages"
    if not data.startswith(b"\x89PNG"):
        raise AssertionError(f"{name} is not a PNG")
    return f"{len(data)} bytes"


def make_corrected_group(folder, seed, shift):
    """A group folder of corrected FAST5s at genome scale, written by the
    native writer into copies of a raw smoke read: reads of TRACE_READ_LEN
    events at uniform starts on a random genome of TRACE_GENOME bases,
    either strand, norm_mean ~ N(0, 1) plus ``shift`` at the planted '+'
    sites, rounded to three decimals.  Returns (folder, reads,
    seconds)."""
    from nanomod_tpu_torch.io.fast5 import CORRECTED_EVENTS_DTYPE
    from nanomod_tpu_torch.native.fast5_write_bind import (
        write_corrected_batch_native)
    t0 = time.perf_counter()
    template = os.path.join(ROOT, "nanomod_tpu_torch", "smoke_data", "ctrl",
                            "raw_0000.fast5")
    genome = np.frombuffer(b"ACGT", "S1")[
        np.random.default_rng(0).integers(0, 4, TRACE_GENOME)]
    rng = np.random.default_rng(seed)
    n_reads = 2 * TRACE_GENOME * TRACE_COVERAGE // TRACE_READ_LEN
    length = TRACE_READ_LEN
    os.makedirs(folder)
    for b0 in range(0, n_reads, TRACE_WRITE_BATCH):
        paths, payloads = [], []
        for r in range(b0, min(b0 + TRACE_WRITE_BATCH, n_reads)):
            path = os.path.join(folder, f"read_{r:05d}.fast5")
            shutil.copyfile(template, path)
            start = int(rng.integers(0, TRACE_GENOME - length + 1))
            strand = "+" if rng.random() < 0.5 else "-"
            ev = np.zeros(length, CORRECTED_EVENTS_DTYPE)
            mean = rng.normal(0.0, 1.0, length)
            if strand == "+":
                lo = max(TRACE_SITE - start, 0)
                hi = min(TRACE_SITE + TRACE_SITE_LEN - start, length)
                if hi > lo:
                    mean[lo:hi] += shift
            # three decimals, as Annotate writes them (resquiggle/annotate.py)
            ev["norm_mean"] = np.round(mean, 3)
            ev["start"] = 5 * np.arange(length)
            ev["length"] = 5
            bases = genome[start:start + length]
            ev["base"] = bases if strand == "+" else bases[::-1]
            paths.append(path)
            payloads.append(dict(
                chrom="synth", start=start, strand=strand, events=ev,
                read_alignment=bases, genome_alignment=bases,
                clipped_start=0, clipped_end=0, num_insertions=0,
                num_deletions=0, num_matches=length, num_mismatches=0))
        ok = write_corrected_batch_native(paths, payloads, nthreads=8)
        if ok is None or not ok.all():
            raise AssertionError("the native writer declined a synthetic "
                                 "corrected read")
    return folder, n_reads, time.perf_counter() - t0


def phase3_traced_detect(tmp, dev):
    """``cli detect --profileDir`` at genome scale (make_corrected_group:
    about 2 x TRACE_GENOME positions, phase 2's P): the table byte-equal to
    the native host battery's on the same files, the planted site first,
    K3's kernels in the trace, and the device-busy share of the whole
    detect run read off it."""
    from nanomod_tpu_torch.config import DetectConfig, RankConfig
    from nanomod_tpu_torch.detect import run_detect
    groups, gen = {}, {}
    for seed, (group, shift) in enumerate((("ctrl", 0.0),
                                           ("case", TRACE_SHIFT)), 1):
        groups[group], reads, gen[group] = make_corrected_group(
            os.path.join(tmp, f"genome_{group}"), seed, shift)
    trace = os.path.join(tmp, "trace")
    out_dir = os.path.join(tmp, "out_trace")
    dfile = os.path.join(tmp, "detect_trace.json")
    out = _cli(["detect", "--wrkBase1", groups["ctrl"], "--wrkBase2",
                groups["case"], "--outFolder", out_dir, "--min_lr", "0",
                "--device", "cuda", "--metricsFile", dfile, "--profileDir",
                trace], _env())
    rank1 = out.split("Rank 1:")[1].split("\n")[0].split()
    log("phase3 traced detect Rank 1:", " ".join(rank1))
    if rank1[1] != "+" or not (TRACE_SITE < int(rank1[2])
                               <= TRACE_SITE + TRACE_SITE_LEN):
        raise AssertionError(f"the planted sites {TRACE_SITE + 1}.."
                             f"{TRACE_SITE + TRACE_SITE_LEN} (+) are not "
                             f"ranked first: {rank1}")
    host_dir = os.path.join(tmp, "host_trace")
    t0 = time.perf_counter()
    run_detect(DetectConfig(wrk_base1=groups["ctrl"],
                            wrk_base2=groups["case"], out_folder=host_dir,
                            min_lr=0, rank=RankConfig(window=10)),
               device=dev, backend="host")
    host_s = time.perf_counter() - t0
    got = _read_bytes(os.path.join(out_dir, "mod_sign_test.txt"))
    if got != _read_bytes(os.path.join(host_dir, "mod_sign_test.txt")):
        raise AssertionError("the traced detect's table differs from the "
                             "host battery's")
    from nanomod_tpu_torch.tools.common import trace_busy_share
    res = trace_busy_share(os.path.join(trace, "trace.rank0.json"))
    if res["kernel_events"] < 1:
        raise AssertionError("the detect trace holds no K3 kernel event")
    with open(dfile) as f:
        metrics = json.load(f)
    if metrics["positions"] < 0.9 * 2 * TRACE_GENOME:
        raise AssertionError(f"only {metrics['positions']} positions")
    res.update(reads_per_group=reads, write_s=gen,
               positions=metrics["positions"], seconds=metrics["seconds"],
               host_backend_run_detect_s=host_s,
               launches=metrics["kernel_launches"],
               stages={k: v["seconds"] for k, v in metrics["stages"].items()},
               trace_mb=os.path.getsize(os.path.join(
                   trace, "trace.rank0.json")) / 2 ** 20)
    log("phase3 detect trace", json.dumps(res))
    for group in groups.values():
        shutil.rmtree(group, ignore_errors=True)
    return res


def phase3_band_width(torch, dev, tmp, width, n_reads):
    """Annotate at another band width (library call: the CLI has no
    band-width option) on ``n_reads`` of the smoke reads, on the card and
    on the CPU: every corrected FAST5 byte-equal, K1 and K2 launched, the
    walk in the reference's mode ("codes" where 2M+W is not a multiple of
    4; M, a length bucket, is a multiple of 256)."""
    from nanomod_tpu_torch.config import AnnotateConfig
    from nanomod_tpu_torch.kernels import build as kbuild
    from nanomod_tpu_torch.resquiggle import pipeline
    data = os.path.join(ROOT, "nanomod_tpu_torch", "smoke_data")
    names = sorted(os.listdir(os.path.join(data, "ctrl")))
    copies = n_reads // len(names)
    dirs = {}
    for where in ("cuda", "cpu"):
        dirs[where] = os.path.join(tmp, f"w{width}_{where}")
        _copy_group(os.path.join(data, "ctrl"), dirs[where], copies)
    modes = []
    dispatch = pipeline.dispatch_dp

    def recording(*a, **kw):
        batch = dispatch(*a, **kw)
        if batch is not None:
            modes.append("codes2" if batch.packed else "codes")
        return batch

    res = {"band_width": width, "reads": copies * len(names)}
    pipeline.dispatch_dp = recording
    try:
        for where, device in (("cuda", dev), ("cpu", "cpu")):
            cfg = AnnotateConfig(wrk_base1=dirs[where],
                                 ref_fasta=os.path.join(data, "ref.fa"),
                                 band_width=width)
            kbuild.reset_launches()
            t0 = time.perf_counter()
            n_ok, _ = pipeline.annotate_folder(cfg, device=device)
            res[f"{where}_s"] = time.perf_counter() - t0
            res[f"{where}_reads_ok"] = n_ok
            res[f"{where}_launches"] = {
                k: v for k, v in kbuild.launch_counts().items()
                if k in ("banded_sw", "walk")}
            res[f"{where}_modes"] = sorted(set(modes))
            modes.clear()
    finally:
        pipeline.dispatch_dp = dispatch
    mode = "codes" if width % 4 else "codes2"
    log(f"phase3 Annotate band_width={width}: walk mode "
        f"{res['cuda_modes']}")
    if res["cuda_modes"] != [mode] or res["cpu_modes"] != [mode]:
        raise AssertionError(f"band_width {width} must walk in mode "
                             f"{mode}: {res}")
    if min(res["cuda_launches"].values()) <= 0:
        raise AssertionError(f"K1 or K2 was not launched: {res}")
    if res["cuda_reads_ok"] < 0.9 * res["reads"] or \
            res["cuda_reads_ok"] != res["cpu_reads_ok"]:
        raise AssertionError(f"Annotate at band_width {width}: {res}")
    for name in sorted(os.listdir(dirs["cpu"])):
        if _read_bytes(os.path.join(dirs["cuda"], name)) != \
                _read_bytes(os.path.join(dirs["cpu"], name)):
            raise AssertionError(f"{name}: the card's corrected FAST5 "
                                 f"differs from the CPU's at band_width "
                                 f"{width}")
    log("phase3 band width", json.dumps(res))
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    return res


def phase3_traced_annotate(torch, dev, tmp):
    """The main path's Annotate (band width 128, the 16 smoke reads of the
    control group copied TRACED_ANNOTATE_COPIES times, a DP batch a length
    bucket) in process under torch.profiler.  A DP batch's device operations must
    be K1, K2 (which writes the rows the host fetches, header and codes),
    one host-to-device copy (the batch's inputs in one buffer) and one
    device-to-host copy, and nothing else: no plain pack_outputs on the
    card."""
    from torch.profiler import ProfilerActivity, profile
    from nanomod_tpu_torch.config import AnnotateConfig
    from nanomod_tpu_torch.kernels import build as kbuild
    from nanomod_tpu_torch.resquiggle import banded, pipeline
    data = os.path.join(ROOT, "nanomod_tpu_torch", "smoke_data")
    folder = os.path.join(tmp, "traced_annotate")
    _copy_group(os.path.join(data, "ctrl"), folder, TRACED_ANNOTATE_COPIES)
    batches = []
    dispatch, pack = pipeline.dispatch_dp, banded.pack_outputs

    def counting(*a, **kw):
        batch = dispatch(*a, **kw)
        if batch is not None:
            batches.append(len(batch.reads))
        return batch

    def refuse(*a, **kw):
        raise AssertionError("pack_outputs ran on the main path")

    cfg = AnnotateConfig(wrk_base1=folder,
                         ref_fasta=os.path.join(data, "ref.fa"),
                         band_width=W)
    pipeline.dispatch_dp, banded.pack_outputs = counting, refuse
    kbuild.reset_launches()
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            n_ok, _ = pipeline.annotate_folder(cfg, device=dev)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        pipeline.dispatch_dp, banded.pack_outputs = dispatch, pack
    kinds = {"k1": ("banded_sw_kernel",),
             "k2": ("walk_kernel", "walk_wide_kernel"),
             "h2d": ("Memcpy HtoD",), "d2h": ("Memcpy DtoH",)}
    counts = dict.fromkeys(kinds, 0)
    device_us = dict.fromkeys(kinds, 0.0)
    other = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = next((k for k, keys in kinds.items()
                     if any(key in e.key for key in keys)), None)
        if kind is None:
            other[e.key[:80]] = e.count
        else:
            counts[kind] += e.count
            device_us[kind] += _device_us(e)
    res = {"reads": len(os.listdir(folder)), "reads_ok": n_ok,
           "seconds": seconds, "dp_batches": len(batches),
           "device_ops": counts, "device_ms": {
               k: v / 1e3 for k, v in device_us.items()},
           "other_device_ops": other,
           "launches": {k: v for k, v in kbuild.launch_counts().items()
                        if k in ("banded_sw", "walk")}}
    log("phase3 traced Annotate", json.dumps(res))
    if other:
        raise AssertionError(f"a DP batch ran device operations beside K1, "
                             f"K2 and its two copies: {other}")
    # the tracer can miss events; it may not add any
    if not all(1 <= counts[k] <= len(batches) for k in kinds) or \
            res["launches"] != {"banded_sw": len(batches),
                                "walk": len(batches)}:
        raise AssertionError(f"traced Annotate: {res}")
    if n_ok < 0.9 * res["reads"]:
        raise AssertionError(f"traced Annotate: {n_ok} of {res['reads']}")
    shutil.rmtree(folder, ignore_errors=True)
    return res


def check_fullchain(summary):
    """The full chain's summary: nine in ten reads annotated in each
    group, K1 and K2 launched by each Annotate, K3 by the detect."""
    for stage in ("annotate_ctrl", "annotate_case"):
        if min(summary[stage]["kernel_launches"].values()) <= 0 or \
                summary[stage]["annotated"] < 0.9 * summary[stage]["reads"]:
            raise AssertionError(f"the full chain's {stage}: "
                                 f"{summary[stage]}")
    if summary["detect"]["kernel_launches"]["battery"] <= 0:
        raise AssertionError("the full chain's detect launched no K3")


def phase3_fullchain(dev, tmp):
    """The reduced full chain through tools/scale_fullchain.py: raw FAST5s
    written by the native raw writer (FULLCHAIN_ENV: reads of 3 kb, M =
    4096), annotated and detected on the card by the tool (a subprocess,
    as a user runs it); FULLCHAIN_CPU_READS of the same raw control files
    annotated on the CPU must be byte-equal to the card's, and the tool's
    table to the native host battery's on the card's corrected files."""
    from nanomod_tpu_torch.config import (AnnotateConfig, DetectConfig,
                                          RankConfig)
    from nanomod_tpu_torch.detect import run_detect
    from nanomod_tpu_torch.resquiggle.pipeline import annotate_files
    from nanomod_tpu_torch.tools import scale_fullchain as fc
    root = os.path.join(tmp, "fullchain")
    # the tool's sizes in this process, as its subprocess reads them
    fc.GENOME_LEN, fc.N_READS, fc.READ_LEN = (
        int(FULLCHAIN_ENV[k]) for k in ("FC_GENOME", "FC_READS",
                                        "FC_READ_LEN"))
    fasta, ctrl, case, _, written, gen_s = fc.make_dataset(root)
    cpu_dir = os.path.join(tmp, "fullchain_cpu")
    os.makedirs(cpu_dir)
    names = sorted(os.path.relpath(os.path.join(d, n), ctrl)
                   for d, _, ns in os.walk(ctrl) for n in ns)
    names = names[:FULLCHAIN_CPU_READS]
    for n in names:
        shutil.copyfile(os.path.join(ctrl, n),
                        os.path.join(cpu_dir, os.path.basename(n)))
    env = _env()
    env.update(FULLCHAIN_ENV)
    proc = subprocess.run(
        [sys.executable, "-m", "nanomod_tpu_torch.tools.scale_fullchain",
         root, "--device", "cuda"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"scale_fullchain failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(root, "fullchain_summary.json")) as f:
        summary = json.load(f)
    check_fullchain(summary)
    t0 = time.perf_counter()
    n_ok, errors, _ = annotate_files(
        [os.path.join(cpu_dir, os.path.basename(n)) for n in names],
        AnnotateConfig(wrk_base1=cpu_dir, ref_fasta=fasta, out_level=2),
        device="cpu")
    cpu_s = time.perf_counter() - t0
    for n in names:
        if _read_bytes(os.path.join(ctrl, n)) != \
                _read_bytes(os.path.join(cpu_dir, os.path.basename(n))):
            raise AssertionError(f"{n}: the card's corrected FAST5 differs "
                                 f"from the CPU's (full chain)")
    host = os.path.join(tmp, "fullchain_host")
    run_detect(DetectConfig(
        wrk_base1=ctrl, wrk_base2=case, out_folder=host,
        file_id="fullchain", min_lr=500, rank=RankConfig(window=10)),
        device=dev, backend="host")
    got = _read_bytes(os.path.join(root, "out", "fullchain_sign_test.txt"))
    if got != _read_bytes(os.path.join(host, "fullchain_sign_test.txt")) \
            or len(got.splitlines()) < 1000:
        raise AssertionError("the full chain's table differs from the host "
                             "battery's")
    res = {"sizes": FULLCHAIN_ENV, "written": written, "gen_s": gen_s,
           "cpu_reads": len(names), "cpu_reads_ok": n_ok, "cpu_s": cpu_s,
           "annotate": {k: summary[k] for k in ("annotate_ctrl",
                                                "annotate_case")},
           "detect": summary["detect"]}
    log("phase3 fullchain", json.dumps(res))
    shutil.rmtree(root, ignore_errors=True)
    return res


def phase3_resume(tmp, groups):
    """``cli Annotate --resume 1 --device cuda`` over the files phase 3
    corrected (those the native reader reads a corrected group from): all
    already annotated, 0 to do, every file left as it was."""
    from nanomod_tpu_torch.native.fast5_bind import read_corrected_batch
    folder = os.path.join(tmp, "resume")
    os.makedirs(folder)
    paths = sorted(os.path.join(groups["ctrl"], n)
                   for n in os.listdir(groups["ctrl"]))
    for p, r in zip(paths, read_corrected_batch(paths)):
        if r is not None:
            shutil.copyfile(p, os.path.join(folder, os.path.basename(p)))
    before = {n: _read_bytes(os.path.join(folder, n))
              for n in os.listdir(folder)}
    out = _cli(["Annotate", "--wrkBase1", folder, "--Ref",
                os.path.join(ROOT, "nanomod_tpu_torch", "smoke_data",
                             "ref.fa"), "--resume", "1", "--device", "cuda"],
               _env())
    line = f"Resume: {len(before)} already annotated, 0 to do"
    log("phase3 resume:", line if line in out else out)
    if line not in out or len(before) < 0.9 * len(paths):
        raise AssertionError(f"--resume: no line {line!r}:\n{out}")
    for n, data in before.items():
        if _read_bytes(os.path.join(folder, n)) != data:
            raise AssertionError(f"--resume rewrote {n}")
    return {"files": len(before)}


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
    bytes_moved = (v1.nbytes + v2.nbytes + n1.nbytes + n2.nbytes
                   + rows.nbytes + 4 * n1.shape[0])
    ops = ops_of(v1, values_ops)
    ops["int_ops"] = ops.get("int_ops", 0) + k6_draw_ops(torch, args, kw)
    return dict(bytes_moved=bytes_moved, **ops)


def k6_draw_ops(torch, args, kw):
    """The integer operations of K6's threefry draws alone: R cov indices
    a capped group, two blocks each (the floor of any K6)."""
    v1, n1, v2, n2, _ = args
    cov = kw["cov"]
    capped = sum(int((n.to(torch.int64).clamp(0, v.shape[1]) > cov).sum())
                 for v, n in ((v1, n1), (v2, n2)))
    return 2 * THREEFRY_OPS * capped * kw["repeats"] * cov


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
    from nanomod_tpu_torch.kernels import hardcases
    hard_kw = dict(kw, cov=DETECT_COV)
    for case in hardcases.K6_CASES:
        x = on_card(*hardcases.k6_tile(case, HARD_K6_P, HARD_K6_WIDTH,
                                       DETECT_COV, seed=len(case)),
                    np.arange(HARD_K6_P, dtype=np.int32) + 5)
        a = kernels.capped_ks_d_cuda(*x, **hard_kw)
        b = kernels.capped_ks_d_plain(*x, **hard_kw)
        if not torch.equal(a, b):
            raise AssertionError(f"K6 differs from plain on the {case} tile")
        errs.append((a, b))
        extra[case] = int((x[1] > DETECT_COV).sum()
                          + (x[3] > DETECT_COV).sum())
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
    # simulate draws its rank histogram (simulat2 and DownSampling draw at
    # runType 3 only)
    hist = check_drawn(outs["simulate"], os.path.join(harness,
                                                      "hist_sim.png"))

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
        "cli_s": cli_s, "hist": hist,
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
    res["k6_draws_bound_ms"] = bound(0, int_ops=k6_draw_ops(torch, args,
                                                            kw))[0]
    log("phase6", json.dumps(res))
    return res


def stencil_shards(torch, rng, dev, p, nsh, cov):
    """(num, cap, n1c, n2c, pos, valid) of ``nsh`` shards of P positions on
    ``dev``: two joins (positions start again inside shard 1), counts 1 to
    2 cov (capped rows beside uncapped ones), 1,000 padding rows."""
    num = rng.integers(0, 1 << 20, p)
    cap = rng.integers(0, 1 << 20, p)
    n1c = rng.integers(1, 2 * cov + 1, p)
    n2c = rng.integers(1, 2 * cov + 1, p)
    n_valid = p - 1000
    cut = p // nsh + p // (3 * nsh)
    pos = np.full(p, -(2 ** 30), np.int64)
    pos[:cut] = np.cumsum(rng.integers(1, 3, cut))
    pos[cut:n_valid] = 17 + np.cumsum(rng.integers(1, 3, n_valid - cut))
    valid = np.arange(p) < n_valid
    t = [torch.from_numpy(a.astype(np.int32)).to(dev)
         for a in (num, cap, n1c, n2c, pos)] + [torch.from_numpy(valid).to(dev)]
    length = p // nsh
    return [tuple(x[s * length:(s + 1) * length] for x in t)
            for s in range(nsh)]


def k7_work(length, k, nshards):
    """K7's bytes over a step (each shard's five int32 vectors and one byte
    vector of [L] read once, its [2k+1, L] stencil of 13 bytes an entry
    written) and integer operations."""
    entries = (2 * k + 1) * length * nshards
    return dict(bytes_moved=21 * length * nshards + 13 * entries,
                int_ops=K7_OPS * entries)


def k9_work(torch, pos, ok, genome_len):
    """K9's bytes (9 an event read, 12 a position written) and f32
    operations (an event kept: three adds, a multiply; a negative
    position counts from the end of [genome_len + 1], as in the
    reference's scatter)."""
    wrapped = torch.where(pos < 0, pos.to(torch.int64) + genome_len + 1, pos)
    kept = int((ok & (wrapped >= 0) & (wrapped < genome_len)).sum())
    return dict(bytes_moved=9 * pos.numel() + 12 * genome_len,
                f32_ops=K9_OPS * kept)


def device_ops(torch, fn, n=100):
    """{name: [calls, summed device us]} of the operations that ran on the
    card (kernels, copies, fills) over n calls of fn under torch.profiler,
    after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: [e.count, _device_us(e)]
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def device_ms(ops, keys):
    """Device ms a call of the operations of ``ops`` (device_ops) whose name
    holds one of ``keys``, each averaged over the calls the trace holds
    (the tracer can miss some); None when there are none (the trace's
    device entries are then logged).  It leaves out the host's launch
    overhead that time_ms sees when the kernels are shorter than their
    wrapper."""
    keys = (keys,) if isinstance(keys, str) else keys
    us = sum(v[1] / v[0] for name, v in ops.items()
             if any(k in name for k in keys))
    if not us:
        log(f"device_ms: no {keys!r} in the trace; device entries",
            json.dumps(ops))
        return None
    return us / 1e3


def read_major_events(rng, n, genome_len):
    """distributed_detect_step's events: [n / READ_LEN, READ_LEN] reads of
    consecutive positions (one or two events a base), starting uniformly
    over the genome, 10 % not ok."""
    r = n // READ_LEN
    start = rng.integers(0, genome_len - READ_LEN, (r, 1))
    pos = start + np.cumsum(rng.integers(0, 2, (r, READ_LEN)), axis=1)
    return (pos.astype(np.int32),
            rng.normal(0, 1, (r, READ_LEN)).astype(np.float32),
            rng.random((r, READ_LEN)) >= 0.1)


def phase7_kernels(torch, dev):
    """(a) K7 and (b) K9 against their plain versions on the card, timed
    beside their bounds (and K9 beside index_add_, at uniform and
    read-major events)."""
    from nanomod_tpu_torch.kernels import build as kbuild
    from nanomod_tpu_torch.parallel import mesh, sharded
    rng = np.random.default_rng(7)
    res = {}
    shards = stencil_shards(torch, rng, dev, BATTERY_P, MESH_SHARDS,
                            STENCIL_COV)
    length = BATTERY_P // MESH_SHARDS
    errs = []
    for k in STENCIL_KS:
        for cov in (0, STENCIL_COV):
            before = kbuild.LAUNCHES["stencil"]
            got = sharded.sharded_stencil_cuda(shards, k, cov)
            if kbuild.LAUNCHES["stencil"] != before + 1:
                raise AssertionError("K7: a step on one card must be one "
                                     "launch")
            want = sharded.sharded_stencil_plain(shards, k, cov)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    if not torch.equal(a, b):
                        raise AssertionError(f"K7 differs from plain at k "
                                             f"= {k}, cov = {cov}")
                errs.append((g[0], w[0]))
            ok = torch.stack([g[3] for g in got])
            if not (ok.any() and not ok.all()):
                raise AssertionError("K7's ok rows must be mixed")
            # the route for cards without peer access, on one card: each
            # neighbour's edge columns copied first, read at their offset
            before = kbuild.LAUNCHES["stencil"]
            staged = sharded._stencil_step_cuda(shards, k, cov,
                                                {(dev.index, dev.index)})
            if kbuild.LAUNCHES["stencil"] != before + 1:
                raise AssertionError("K7's staged step on one card must be "
                                     "one launch")
            for s_, g in zip(staged, got):
                for a, b in zip(s_, g):
                    if not torch.equal(a, b):
                        raise AssertionError(f"K7's staged route differs "
                                             f"from the in-place route at k "
                                             f"= {k}, cov = {cov}")
    k = STENCIL_KS[0]
    step = functools.partial(sharded.sharded_stencil_cuda, shards, k,
                             STENCIL_COV)
    plain = functools.partial(sharded.sharded_stencil_plain, shards, k,
                              STENCIL_COV)
    before = kbuild.LAUNCHES["stencil"]
    step()
    launches = kbuild.LAUNCHES["stencil"] - before
    ops = device_ops(torch, step)
    if ops and (len(ops) != 1 or "stencil_step_kernel" not in next(iter(ops))
                or next(iter(ops.values()))[0] > 100):
        raise AssertionError(f"K7's step must be one kernel and no other "
                             f"device operation: {ops} over 100 steps")
    res["k7"] = {
        "P": BATTERY_P, "shards": MESH_SHARDS, "L": length, "k": k,
        "cov": STENCIL_COV, "max_abs_err": max_abs_err(torch, errs),
        "launches_per_step": launches,
        "device_ops_100_steps": ops or "not measured (no device events)",
        "ms": time_ms(torch, step), "single_ms": time_ms(torch, step, n=1),
        "plain_ms": time_ms(torch, plain),
        "device_ms": device_ms(ops, "stencil_step_kernel"),
        "step_ms": time_ms(torch, lambda: sharded.sharded_stencil(
            shards, k, STENCIL_COV)),
        # the staged route (cards without peer access), on one card
        "staged_step_ms": time_ms(torch, lambda: sharded._stencil_step_cuda(
            shards, k, STENCIL_COV, {(dev.index, dev.index)})),
    }
    res["k7"]["bound_ms"], res["k7"]["bound_by"] = bound(
        **k7_work(length, k, MESH_SHARDS))

    draws = {
        "uniform": (rng.integers(0, GENOME_LEN, EVENTS).astype(np.int32),
                    rng.normal(0, 1, EVENTS).astype(np.float32),
                    rng.random(EVENTS) >= 0.1),
        "read_major": read_major_events(rng, EVENTS, GENOME_LEN),
    }
    res["k9"] = {}
    for shape, arrays in draws.items():
        pos, val, ok = (torch.from_numpy(a).to(dev) for a in arrays)
        got = mesh.accumulate_cuda(pos, val, ok, GENOME_LEN)
        want = mesh.accumulate_plain(pos, val, ok, GENOME_LEN)
        check_accumulate(torch, got, want,
                         f"K9 against its plain version ({shape})")
        keep = ok.reshape(-1)
        idx = pos.reshape(-1)[keep].to(torch.int64)
        v = val.reshape(-1)[keep]
        src = torch.stack([torch.ones_like(v), v, v * v], dim=1)
        lib = torch.zeros((GENOME_LEN, 3), device=dev).index_add_(0, idx,
                                                                   src)
        check_accumulate(torch, got, lib.T, f"K9 against index_add_ "
                                            f"({shape})")
        k9 = functools.partial(mesh.accumulate_cuda, pos, val, ok,
                               GENOME_LEN)
        ops = device_ops(torch, k9)
        r = {
            "genome_len": GENOME_LEN, "events": EVENTS,
            "shape": list(pos.shape), "kept": int(idx.numel()),
            "max_abs_err": max_abs_err(torch, zip(got, want)),
            "device_ops_100_calls": ops,
            "ms": time_ms(torch, k9), "single_ms": time_ms(torch, k9, n=1),
            # the accumulator's zeroing and the atomics
            "device_ms": device_ms(ops, ("accumulate_kernel",
                                         "FillFunctor")),
            "plain_ms": time_ms(torch, lambda: mesh.accumulate_plain(
                pos, val, ok, GENOME_LEN)),
            "library_ms": time_ms(torch, lambda: torch.zeros(
                (GENOME_LEN, 3), device=dev).index_add_(0, idx, src)),
        }
        r["bound_ms"], r["bound_by"] = bound(
            **k9_work(torch, pos, ok, GENOME_LEN))
        res["k9"][shape] = r
    log("phase7 kernels", json.dumps(res))
    return res, draws["read_major"]


def check_accumulate(torch, got, want, what):
    """Counts equal; sums within the reference's own tolerance (the
    atomics add in no fixed order)."""
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"{what}: counts differ")
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def mesh_devices(torch):
    """The MESH_SHARDS devices of phase 7's meshes: the cards in turn, so
    that one card stands for all four (cuda:0 four times) and four cards
    are four."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", s % n) for s in range(MESH_SHARDS)]


def phase7_sharded_battery(torch, dev):
    """(c) sharded_join_battery on the 4-shard mesh against run_battery +
    combine_neighbor_pvalues at phase 2's inputs: bit-equal."""
    from nanomod_tpu_torch.config import StatConfig
    from nanomod_tpu_torch.parallel import mesh, sharded
    from nanomod_tpu_torch.stats import battery
    from nanomod_tpu_torch.stats.combine import combine_neighbor_pvalues
    rng = np.random.default_rng(1)            # phase 2's inputs
    p, c = BATTERY_P, BATTERY_CAP
    v1 = (rng.integers(-40, 41, (p, c)) * 25).astype(np.int16)
    v2 = (rng.integers(-40, 41, (p, c)) * 25).astype(np.int16)
    n1 = np.maximum(rng.integers(30, 101, p), 1).astype(np.int32)
    n2 = np.maximum(rng.integers(30, 101, p), 1).astype(np.int32)
    pools1 = v1.astype(np.float32) / np.float32(1000)
    pools2 = v2.astype(np.float32) / np.float32(1000)
    positions = np.cumsum(rng.integers(1, 3, p)).astype(np.int64)
    m = mesh.make_mesh(MESH_SHARDS, devices=mesh_devices(torch))
    res = {}
    for cov in (0, SHARDED_COV):
        cfg = StatConfig(coverages=(cov, cov))
        t0 = time.perf_counter()
        got = sharded.sharded_join_battery(m, pools1, n1, pools2, n2,
                                           positions, cfg=cfg, want_mstd=True)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = battery.run_battery(pools1, n1, pools2, n2, cfg=cfg,
                                   device=dev, tile_positions=BATTERY_TILE,
                                   want_mstd=True)
        want.stcomb, want.pcomb = combine_neighbor_pvalues(
            np.zeros(p, np.int64), positions, want.pks, cfg)
        single_s = time.perf_counter() - t0
        for key in ("stu", "pu", "stt", "pt", "stks", "pks", "stcomb",
                    "pcomb", "mstd"):
            if not np.array_equal(getattr(got, key), getattr(want, key),
                                  equal_nan=True):
                raise AssertionError(f"sharded battery {key} differs from "
                                     f"the single device's at cov {cov}")
        res[f"cov{cov}"] = {"sharded_s": sharded_s, "single_s": single_s}
    log("phase7 sharded battery", json.dumps(res))
    return res


def phase7_main_paths(torch, dev, tmp, groups, reads):
    """(d) the in-process sharded detect and distributed_detect_step, each
    with the launch counts set to 0 just before and read just after."""
    from nanomod_tpu_torch.config import (DetectConfig, RankConfig,
                                          StatConfig, replace)
    from nanomod_tpu_torch.detect import run_detect
    from nanomod_tpu_torch.kernels import build as kbuild
    from nanomod_tpu_torch.parallel import mesh
    from nanomod_tpu_torch.stats import kernels
    base = DetectConfig(wrk_base1=groups["ctrl"], wrk_base2=groups["case"],
                        min_lr=0, rank=RankConfig(window=10))
    capped = replace(base, mstd=True, stats=StatConfig(
        coverages=(DETECT_COV, DETECT_COV), downsampling=100))
    runs = {
        "stouffer": (base, os.path.join(tmp, "out")),
        "fisher": (replace(base, **{"stats.test_method": "fisher"}), None),
        "ks": (replace(base, **{"stats.test_method": "ks"}), None),
        "capped": (capped, os.path.join(tmp, "capped")),
    }
    # the single-device tables that phases 3 and 5 did not write
    for name, (cfg, want_dir) in runs.items():
        if want_dir is None:
            want_dir = os.path.join(tmp, f"single_{name}")
            run_detect(replace(cfg, out_folder=want_dir), device=dev)
            runs[name] = (cfg, want_dir)
    # n_devices shards each join over mesh.DEVICES, the test hook that
    # lets one card stand for several
    mesh.DEVICES = mesh_devices(torch)
    kbuild.reset_launches()
    t0 = time.perf_counter()
    try:
        for name, (cfg, _) in runs.items():
            run_detect(replace(cfg, n_devices=MESH_SHARDS,
                               out_folder=os.path.join(tmp, f"mesh_{name}")),
                       device=dev)
        torch.cuda.synchronize()
    finally:
        mesh.DEVICES = None
    detect_s = time.perf_counter() - t0
    detect_launches = kbuild.launch_counts()
    for name, (cfg, want_dir) in runs.items():
        files = ["mod_sign_test.txt"] + (["mod_meanstd.cvs"] if cfg.mstd
                                         else [])
        for f in files:
            a = _read_bytes(os.path.join(tmp, f"mesh_{name}", f))
            if a != _read_bytes(os.path.join(want_dir, f)) \
                    or len(a.splitlines()) < 1000:
                raise AssertionError(f"sharded detect ({name}): {f} differs "
                                     f"from the single-device one")
    for kern in ("battery", "capped_ks", "stencil"):
        if detect_launches[kern] <= 0:
            raise AssertionError(f"the sharded detect did not launch "
                                 f"{kern}: {detect_launches}")

    prng = np.random.default_rng(8)
    pp, nn = 65536, 64
    z = np.where(prng.random((pp, nn)) < 0.8,
                 np.round(prng.normal(0, 1, (pp, nn)), 2), np.inf)
    z = np.sort(z, axis=1).astype(np.float32)
    lab = (prng.random((pp, nn)) < 0.5).astype(np.float32)
    lab[:, :2] = (1.0, 0.0)
    lab[~np.isfinite(z)] = 0.0
    n1 = (lab * np.isfinite(z)).sum(1).astype(np.float32)
    n2 = ((1 - lab) * np.isfinite(z)).sum(1).astype(np.float32)
    m2 = mesh.make_mesh(MESH_SHARDS, data=2, devices=mesh_devices(torch))
    kbuild.reset_launches()
    t0 = time.perf_counter()
    step = mesh.distributed_detect_step(m2, GENOME_LEN, *reads, z, lab, n1,
                                        n2)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_launches = kbuild.launch_counts()
    if step_launches["accumulate"] <= 0 \
            or step_launches["battery_pooled"] <= 0:
        raise AssertionError(f"distributed_detect_step did not launch K9 "
                             f"and K3's pooled entry: {step_launches}")
    check_accumulate(torch, step[:3], mesh.accumulate_plain(
        *(torch.from_numpy(x).to(dev) for x in reads), GENOME_LEN),
        "distributed_detect_step")
    want = kernels.pooled_rank_components_plain(
        *(torch.from_numpy(x).to(dev) for x in (z, lab, n1, n2)))
    for a, b in zip(step[3:], want):
        if not torch.equal(a, b):
            raise AssertionError("distributed_detect_step's pooled "
                                 "components differ from plain")
    res = {"detect_runs": list(runs), "detect_s": detect_s,
           "detect_launches": detect_launches, "step_s": step_s,
           "step_launches": step_launches,
           "step_shapes": {"reads": list(reads[0].shape), "pooled": [pp, nn]}}
    log("phase7 main paths", json.dumps(res))
    res["pooled"] = phase7_pooled(torch, m2, z, lab, n1, n2)
    return res


def _torchrun_all(jobs):
    """Run each {name: args} as ``torch.distributed.run --standalone
    --nproc_per_node 2 -m nanomod_tpu_torch.cli ARGS``, all at once;
    returns {name: stdout}.  A launch that fails or outlives the timeout
    raises, and every process is stopped."""
    env = _env()
    procs = {}
    try:
        for name, args in jobs.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "2", "-m", "nanomod_tpu_torch.cli"]
                + args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, start_new_session=True)
        outs = {name: p.communicate(timeout=TORCHRUN_TIMEOUT)[0]
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    for name, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"two-process {name} failed ({p.returncode}):"
                               f"\n{outs[name][-4000:]}")
    return outs


def phase7_two_processes(tmp, groups, p3):
    """(e) two ranks on the card: detect (union and sharded) and Annotate
    through torch.distributed.run."""
    data = os.path.join(ROOT, "nanomod_tpu_torch", "smoke_data")
    detect = ["detect", "--wrkBase1", groups["ctrl"], "--wrkBase2",
              groups["case"], "--min_lr", "0", "--device", "cuda"]
    capped = ["--coverages", f"{DETECT_COV}-{DETECT_COV}", "--downsampling",
              "100", "--mstd", "1", "--merge_mode", "sharded"]
    mfile = {name: os.path.join(tmp, f"mp_{name}.json")
             for name in ("union", "sharded", "ann_ctrl", "ann_case")}
    jobs = {
        "union": detect + ["--outFolder", os.path.join(tmp, "mp_union"),
                           "--metricsFile", mfile["union"]],
        "sharded": detect + capped + [
            "--outFolder", os.path.join(tmp, "mp_sharded"),
            "--metricsFile", mfile["sharded"]],
    }
    t0 = time.perf_counter()
    outs = _torchrun_all(jobs)
    detect_s = time.perf_counter() - t0
    checks = {"union": ("out", ["mod_sign_test.txt"], ("battery",)),
              "sharded": ("capped", ["mod_sign_test.txt", "mod_meanstd.cvs"],
                          ("battery", "capped_ks"))}
    launches = {}
    for name, (want_dir, files, kerns) in checks.items():
        for f in files:
            a = _read_bytes(os.path.join(tmp, f"mp_{name}", f))
            if a != _read_bytes(os.path.join(tmp, want_dir, f)):
                raise AssertionError(f"two-process {name} detect: {f} "
                                     f"differs from the single process's")
        for rank in range(2):
            with open(mfile[name].replace(".json", f".rank{rank}.json")) as f:
                got = json.load(f)["kernel_launches"]
            launches[f"{name}_rank{rank}"] = got
            if min(got[k] for k in kerns) <= 0:
                raise AssertionError(f"two-process {name}, rank {rank}: "
                                     f"{kerns} not all launched: {got}")
        if "Rank 1:" not in outs[name]:
            raise AssertionError(f"two-process {name} printed no rank 1")

    fresh = {}
    for group in ("ctrl", "case"):
        fresh[group] = os.path.join(tmp, f"mp_raw_{group}")
        _copy_group(os.path.join(data, group), fresh[group], COPIES)
    t0 = time.perf_counter()
    outs = _torchrun_all({
        f"ann_{g}": ["Annotate", "--wrkBase1", folder, "--Ref",
                     os.path.join(data, "ref.fa"), "--device", "cuda",
                     "--metricsFile", mfile[f"ann_{g}"]]
        for g, folder in fresh.items()})
    annotate_s = time.perf_counter() - t0
    reads_ok = {}
    for g, folder in fresh.items():
        names = sorted(os.listdir(folder))
        n = len(names)
        for rank in range(2):
            line = f"Total f5={n} (rank {rank}/2: {n // 2})"
            if line not in outs[f"ann_{g}"]:
                raise AssertionError(f"two-process Annotate {g}: no line "
                                     f"{line!r}")
            with open(mfile[f"ann_{g}"].replace(".json",
                                                f".rank{rank}.json")) as f:
                m = json.load(f)
            reads_ok[f"{g}_rank{rank}"] = m["reads_ok"]
            launches[f"ann_{g}_rank{rank}"] = m["kernel_launches"]
            if m["reads_ok"] != p3["reads_ok"][g]:
                raise AssertionError(f"two-process Annotate {g}, rank "
                                     f"{rank}: merged ok {m['reads_ok']}, "
                                     f"one process {p3['reads_ok'][g]}")
        for name in names:
            if (_read_bytes(os.path.join(folder, name))
                    != _read_bytes(os.path.join(groups[g], name))):
                raise AssertionError(f"two-process Annotate {g}: {name} "
                                     f"differs from phase 3's")
    res = {"detect_s": detect_s, "annotate_s": annotate_s,
           "reads_ok": reads_ok, "launches": launches}
    log("phase7 two processes", json.dumps(res))
    return res


def pooled_work(torch, shards):
    """pooled_rank_components' bytes over the shards (z and lab read, n1
    and n2 read, d, two_rank_sum and tie_sum written) and the operations
    of a sort-and-merge evaluation of every row's two groups (as
    k3_work's, no moments)."""
    nbytes, ops = 0, 0
    for z, lab, n1, n2 in shards:
        nbytes += z.nbytes + lab.nbytes + n1.nbytes + n2.nbytes \
            + 12 * z.shape[0]
        valid = z < float("inf")
        c1 = (valid & (lab > 0.5)).sum(dim=1)
        c2 = (valid & (lab <= 0.5)).sum(dim=1)
        ops += int((sort_compares(torch, c1) + sort_compares(torch, c2)
                    + (WALK_KS_OPS + WALK_RANK_OPS) * (c1 + c2)).sum())
    return dict(bytes_moved=nbytes, f32_ops=ops)


def phase7_pooled(torch, m2, z, lab, n1, n2):
    """(f) pooled_rank_components over the mesh's shards, one launch of
    K3's pooled entry a shard: timed beside its bound and its plain
    version, held to the plain version (d bit-equal, NaN equal to NaN)
    there and on the pooled hard cases (kernels/hardcases.py)."""
    from nanomod_tpu_torch.kernels import hardcases
    from nanomod_tpu_torch.parallel.mesh import shard_pools_over_positions
    from nanomod_tpu_torch.stats import kernels
    dev = m2.devices[0]

    def held(args, what):
        got = kernels.pooled_rank_components_cuda(*args)
        want = kernels.pooled_rank_components_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(got[0].isnan(), want[0].isnan())
                and torch.equal(got[0].nan_to_num(), want[0].nan_to_num())
                and torch.equal(got[1], want[1])
                and torch.equal(got[2], want[2])):
            raise AssertionError(f"the pooled kernel differs from plain: "
                                 f"{what}")
        if not got[0].numel():
            return 0.0
        return max_abs_err(torch, [(a.nan_to_num(), b.nan_to_num())
                                   for a, b in zip(got, want)])

    shards = shard_pools_over_positions(m2, z, lab, n1, n2)
    errs = [held(sh, f"shard {i}") for i, sh in enumerate(shards)]
    for case in hardcases.POOLED_CASES:
        errs.append(held([torch.from_numpy(x).to(dev) for x in
                          hardcases.pooled_tile(case, seed=11)], case))
    call = lambda: [kernels.pooled_rank_components(*sh)  # noqa: E731
                    for sh in shards]
    res = {"shards": len(shards), "shard_shape": list(shards[0][0].shape),
           "cases": list(hardcases.POOLED_CASES), "max_abs_err": max(errs),
           "ms": time_ms(torch, call), "single_ms": time_ms(torch, call, n=1),
           "plain_ms": time_ms(torch, lambda: [
               kernels.pooled_rank_components_plain(*sh) for sh in shards],
               **PLAIN_TIMING)}
    res["bound_ms"], res["bound_by"] = bound(**pooled_work(torch, shards))
    # the card runs the pooled kernel and nothing else (no argsort,
    # gather, sum or divide): its device time a launch under the profiler
    ops = device_ops(torch, call)
    res["device_ops"] = sorted(ops)
    res["device_ms_a_launch"] = device_ms(ops, "pooled_")
    if any("pooled_" not in name for name in ops):
        raise AssertionError(f"pooled_rank_components ran other device "
                             f"operations: {sorted(ops)}")
    log("phase7 pooled", json.dumps(res))
    return res


def phase8_external(tmp):
    """(a) ``cli Annotate --alignStr minimap2`` with the fake aligner on the
    card and on the CPU (byte-equal), detect on the card over the result,
    and a real aligner once where one is on PATH."""
    data = os.path.join(ROOT, "nanomod_tpu_torch", "smoke_data")
    root = os.path.join(tmp, "external")
    bindir = os.path.join(root, "bin")
    os.makedirs(bindir)
    exe = os.path.join(bindir, "minimap2")
    with open(exe, "w") as f:
        f.write(FAKE_MINIMAP2)
    os.chmod(exe, 0o755)
    # the aligners read the reference, and bwa indexes it, in a copy
    ref = os.path.join(root, "ref.fa")
    shutil.copyfile(os.path.join(data, "ref.fa"), ref)
    real = [a for a in ("minimap2", "bwa") if shutil.which(a)]
    env = _env()
    env["PATH"] = bindir + os.pathsep + env.get("PATH", "")
    jobs, folders, mfiles = {}, {}, {}
    for device in ("cuda", "cpu"):
        for group in ("ctrl", "case"):
            name = f"{device}_{group}"
            folders[name] = os.path.join(root, name)
            _copy_group(os.path.join(data, group), folders[name], EXT_COPIES)
            mfiles[name] = os.path.join(root, f"annotate_{name}.json")
            jobs[name] = (["Annotate", "--wrkBase1", folders[name], "--Ref",
                           ref, "--alignStr", "minimap2", "--device", device,
                           "--metricsFile", mfiles[name]], env)
    t0 = time.perf_counter()
    outs = _cli_all(jobs)
    res = {"annotate_s": time.perf_counter() - t0, "reads_ok": {},
           "align_ext_s": {}}
    n_files = EXT_COPIES * len(os.listdir(os.path.join(data, "ctrl")))
    for name in jobs:
        log(f"phase8 Annotate --alignStr minimap2 {name}:",
            outs[name].strip().splitlines()[-1])
        with open(mfiles[name]) as f:
            m = json.load(f)
        res["reads_ok"][name] = m["reads_ok"]
        res["align_ext_s"][name] = m["stages"]["align_ext"]["seconds"]
        # the fake aligner anchors an exact 24-mer, which a smoke read's
        # basecall errors can break (11 and 12 of 16 reads a group map, as
        # in the JAX package: tests/test_torch_external.py)
        if m["reads_ok"] < 0.5 * n_files or "align_dp" in m["stages"]:
            raise AssertionError(f"external Annotate {name}: {m['reads_ok']} "
                                 f"of {n_files} reads, stages "
                                 f"{list(m['stages'])}")
    for group in ("ctrl", "case"):
        a, b = folders[f"cuda_{group}"], folders[f"cpu_{group}"]
        if res["reads_ok"][f"cuda_{group}"] != res["reads_ok"][f"cpu_{group}"]:
            raise AssertionError(f"external Annotate {group}: the card and "
                                 f"the CPU annotated different reads")
        for name in sorted(os.listdir(a)):
            if _read_bytes(os.path.join(a, name)) != \
                    _read_bytes(os.path.join(b, name)):
                raise AssertionError(f"external Annotate {group}/{name}: the "
                                     f"card's file differs from the CPU's")
    dfile = os.path.join(root, "detect.json")
    out = _cli(["detect", "--wrkBase1", folders["cuda_ctrl"], "--wrkBase2",
                folders["cuda_case"], "--outFolder",
                os.path.join(root, "out"), "--min_lr", "0", "--device",
                "cuda", "--metricsFile", dfile], env)
    with open(dfile) as f:
        m = json.load(f)
    rank1 = out.split("Rank 1:")[1].split("\n")[0].split()
    log("phase8 detect Rank 1:", " ".join(rank1))
    if int(rank1[2]) != SMOKE_MOD_POS + 1:
        raise AssertionError(f"planted site {SMOKE_MOD_POS + 1} is not "
                             f"ranked first after the external aligner: "
                             f"{rank1}")
    res["detect_launches"] = m["kernel_launches"]
    res["detect_positions"] = m["positions"]
    if m["kernel_launches"]["battery"] <= 0:
        raise AssertionError(f"detect after the external aligner did not "
                             f"launch K3: {m['kernel_launches']}")
    res["real_aligners"] = {}
    for align in real:
        folder = os.path.join(root, f"real_{align}")
        _copy_group(os.path.join(data, "ctrl"), folder, 1)
        mfile = os.path.join(root, f"real_{align}.json")
        _cli(["Annotate", "--wrkBase1", folder, "--Ref", ref, "--alignStr",
              align, "--device", "cuda", "--metricsFile", mfile], _env())
        with open(mfile) as f:
            res["real_aligners"][align] = json.load(f)["reads_ok"]
        log(f"phase8 real {align}: n_ok", res["real_aligners"][align])
    log("phase8 external", json.dumps(res))
    return res


def phase8_bench(torch):
    """(b) the bench at its default sizes, in process, with the launch
    counts set to 0 just before it and read just after."""
    import contextlib
    import io
    from nanomod_tpu_torch import bench
    from nanomod_tpu_torch.kernels import build as kbuild
    captured = io.StringIO()
    kbuild.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        line = bench.main(["--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kbuild.launch_counts()
    log("phase8 bench line", json.dumps(line))
    res = {"seconds": seconds, "launches": launches}
    log("phase8 bench", json.dumps(res))
    if line["e2e"]["top_site_pos"] != BENCH_SITE:
        raise AssertionError(f"bench e2e: the planted site {BENCH_SITE} is "
                             f"not first: {line['e2e']}")
    if line["secondary"]["n_ok"] != BENCH_READS:
        raise AssertionError(f"bench Annotate: {line['secondary']['n_ok']} "
                             f"of {BENCH_READS} reads annotated")
    if min(launches[k] for k in PHASE3_KERNELS) <= 0:
        raise AssertionError(f"the bench did not launch K1, K2 and K3: "
                             f"{launches}")
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
        p3["trace"] = phase3_traced_detect(tmp, dev)
        p3["annotate_trace"] = phase3_traced_annotate(torch, dev, tmp)
        p3["band_width"] = {w: phase3_band_width(torch, dev, tmp, w, n)
                            for w, n in ANNOTATE_WIDTHS.items()}
        p3["fullchain"] = phase3_fullchain(dev, tmp)
        p3["resume"] = phase3_resume(tmp, groups)
        p4 = phase4(torch, dev)
        p5 = phase5(torch, dev, tmp, groups)
        p6 = phase6(torch, dev, tmp, groups)
        p7, events = phase7_kernels(torch, dev)
        phase7_sharded_battery(torch, dev)
        p7_main = phase7_main_paths(torch, dev, tmp, groups, events)
        phase7_two_processes(tmp, groups, p3)
        t8 = time.perf_counter()
        phase8_external(tmp)
        phase8_bench(torch)
        log("phase8", json.dumps({"seconds": time.perf_counter() - t8}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    jax_package = sorted(m for m in sys.modules
                         if m == "nanomod_tpu" or m.startswith("nanomod_tpu."))
    if jax_package:
        raise AssertionError(f"JAX-package modules were loaded: {jax_package}")

    main_dp = p1[MAIN_PATH_BUCKET]
    # K1 at the widest narrow band and under the wide kernel's plans, and
    # K2 with the header beside the walk and pack_outputs (phase 1)
    k1_wide = {p1[f"W{w}"]["W"]: {
        k: p1[f"W{w}"]["k1_" + k]
        for k in ("ms", "single_ms", "plain_ms", "bound_ms")}
        for w in p1["k1_widths"]}
    # K9 at distributed_detect_step's read-major events (phase 7d's input)
    k9_main = p7["k9"]["read_major"]
    dp_runs = [r for m, r in p1.items() if m not in ("extra", "k1_widths")] \
        + list(p1["extra"].values())
    # the windowed walk (pitch above 1024) at the main path's bucket and at
    # B 64 x M 4096, beside its bound and chain floor
    walk_wide = {f"B{r['B']}_M{r['M']}_W{r['W']}": {
        k: r[k] for k in ("k2h_ms", "k2h_single_ms", "k2h_bound_ms",
                          "longest_walk_steps", "chain_floor_ms")}
        for r in dp_runs if r.get("W", 0) > 1024 and "k2h_ms" in r}
    # no single PyTorch call computes any of these functions but K9's
    # (index_add_)
    kernels = [
        {"name": "banded_sw", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/banded_sw.cu",
         "replaces": "nanomod_tpu/resquiggle/banded_pallas.py:133",
         "launches": p3["launches"]["banded_sw"],
         "max_abs_err": max(r["k1_max_abs_err"] for r in dp_runs),
         "ms": main_dp["k1_ms"], "single_ms": main_dp["k1_single_ms"],
         "plain_ms": main_dp["k1_plain_ms"],
         "bound_ms": main_dp["k1_bound_ms"],
         "bound_by": main_dp["k1_bound_by"], "library_ms": None,
         "by_band_width": k1_wide,
         "by_batch": {f"B{b}_M{m}_W{w}": {
             k: p1[f"B{b}_M{m}_W{w}"]["k1_" + k] for k in ("ms", "bound_ms")}
             for b, m, w in DP_K1_BATCH}},
        {"name": "walk", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/walk.cu",
         "replaces": "nanomod_tpu/resquiggle/banded.py:189",
         "launches": p3["launches"]["walk"],
         "max_abs_err": max(r["k2_max_abs_err"] for r in dp_runs),
         "ms": main_dp["k2h_ms"], "single_ms": main_dp["k2h_single_ms"],
         "plain_ms": main_dp["k2h_plain_ms"],
         "bound_ms": main_dp["k2h_bound_ms"],
         "bound_by": main_dp["k2h_bound_by"], "library_ms": None,
         "walk_only_ms": main_dp["k2_ms"],
         "walk_and_pack_outputs_ms": main_dp["k2_pack_ms"],
         "windowed": walk_wide},
        {"name": "battery", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/battery.cu",
         "replaces": "nanomod_tpu/stats/kernels.py:186",
         "launches": p3["launches"]["battery"],
         "max_abs_err": p2["k3_max_abs_err"],
         "ms": p2["k3_tile_ms"], "single_ms": p2["k3_tile_single_ms"],
         "plain_ms": p2["k3_tile_plain_ms"],
         "bound_ms": p2["k3_tile_bound_ms"],
         "bound_by": p2["k3_tile_bound_by"], "library_ms": None},
        {"name": "capped_ks", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/capped_ks.cu",
         "replaces": "nanomod_tpu/stats/kernels.py:279",
         "launches": p5["capped_launches"]["capped_ks"],
         "max_abs_err": max(p4["k6_max_abs_err"], p6["k6_max_abs_err"]),
         "ms": p6["k6_ms"], "single_ms": p6["k6_single_ms"],
         "plain_ms": p6["k6_plain_ms"],
         "bound_ms": p6["k6_bound_ms"], "bound_by": p6["k6_bound_by"],
         "library_ms": None},
        {"name": "stencil", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/stencil.cu",
         "replaces": "nanomod_tpu/parallel/sharded.py:77",
         "launches": p7_main["detect_launches"]["stencil"],
         "max_abs_err": p7["k7"]["max_abs_err"],
         "ms": p7["k7"]["ms"], "single_ms": p7["k7"]["single_ms"],
         "plain_ms": p7["k7"]["plain_ms"],
         "bound_ms": p7["k7"]["bound_ms"], "bound_by": p7["k7"]["bound_by"],
         "library_ms": None},
        {"name": "battery_pooled", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/battery.cu",
         "replaces": "nanomod_tpu/stats/kernels.py:252",
         "launches": p7_main["step_launches"]["battery_pooled"],
         "max_abs_err": p7_main["pooled"]["max_abs_err"],
         "ms": p7_main["pooled"]["ms"],
         "single_ms": p7_main["pooled"]["single_ms"],
         "plain_ms": p7_main["pooled"]["plain_ms"],
         "bound_ms": p7_main["pooled"]["bound_ms"],
         "bound_by": p7_main["pooled"]["bound_by"], "library_ms": None,
         "shards": p7_main["pooled"]["shards"]},
        {"name": "accumulate", "route": "cuda",
         "source": "nanomod_tpu_torch/csrc/accumulate.cu",
         "replaces": "nanomod_tpu/parallel/mesh.py:70",
         "launches": p7_main["step_launches"]["accumulate"],
         "max_abs_err": max(r["max_abs_err"] for r in p7["k9"].values()),
         "ms": k9_main["ms"], "single_ms": k9_main["single_ms"],
         "plain_ms": k9_main["plain_ms"],
         "bound_ms": k9_main["bound_ms"], "bound_by": k9_main["bound_by"],
         "library_ms": k9_main["library_ms"]},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
