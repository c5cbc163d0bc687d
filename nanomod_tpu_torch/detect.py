"""End-to-end two-group modification detection.

Port of nanomod_tpu/detect.py: ingest corrected FAST5 events of both groups
(native reader) into dense position pools, filter coverage, run the test
battery per (chrom, strand) on the device (kernel K3; K6 past the coverage
cap), combine neighbor p-values, save the reference-format results table
and rank sites.  ``n_devices > 1`` shards each join's positions over a
device mesh (parallel/sharded.py, kernel K7 for the neighbor stencil);
under several processes (torch.distributed, parallel/dist.py) each rank
ingests its file shard and the pools merge across ranks, or with
``merge_mode="sharded"`` each rank tests its own coordinate range
(parallel/shardmerge.py).  ``make_plots`` draws the top sites
(harness/plots.py, matplotlib; ImportError where it is missing), and
``profile_dir`` / NANOMOD_PROFILE_DIR (``detect --profileDir DIR``) wraps
the run in a torch.profiler trace (utils/observe.device_trace),
``DIR/trace.rank<r>.json``: every stage below is a ``nanomod.<stage>``
host span in it, on the clock of the card's kernels and copies, so a gap
in the card's work reads as the stage the host was in.  The stages of a
detect: ``ingest.list`` (the folder's listing), ``ingest`` (holding
``ingest.read``, the native open and parse, and ``ingest.unpack``, the
reads built), ``accumulate``, ``finalize_pools``, ``coverage_filter``,
``test_battery`` (holding run_battery's ``battery.gather``, and a tile's
``battery.encode_wait``, ``battery.dispatch``, ``battery.wait`` and
``battery.finalize``), ``combine_pvalues``, ``rank``, ``save`` and
``top_sites``.  ``host_cpu`` is no span: the process CPU seconds of the
run beside its positions.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nanomod_tpu_torch.accum.pools import PoolBuilder, PositionPools, join_pools
from nanomod_tpu_torch.config import DetectConfig, OUTPUT_INFO
from nanomod_tpu_torch.io import fast5 as fast5_io
from nanomod_tpu_torch.io.fast5 import iter_fast5_files, read_corrected_events
from nanomod_tpu_torch.utils.observe import (device_trace, observer, report,
                                             stage)
from nanomod_tpu_torch.device import resolve_device
from nanomod_tpu_torch.rank.ranking import (SignTable, region_rank,
                                            sort_sites, top_sites)
from nanomod_tpu_torch.stats.battery import TestResult, run_battery
from nanomod_tpu_torch.stats.combine import combine_neighbor_pvalues


def _read_passes_filters(rd, cfg: DetectConfig,
                         start_end: Optional[Tuple[int, int]]) -> bool:
    """The reference's read-level filters (ref myDetect.py:74-102)."""
    n = len(rd.norm_mean)
    if cfg.chrom is not None and rd.chrom != cfg.chrom:
        return False
    if cfg.pos is not None and cfg.pos2 is not None:
        if rd.start > cfg.pos2 or rd.start + n < cfg.pos:
            return False
    if start_end is not None:
        if rd.start > start_end[0] or rd.start + n < start_end[1]:
            return False
    if cfg.min_lr_nb < 1:
        if n < cfg.min_lr:
            return False
    else:
        lo = cfg.min_lr - cfg.min_lr_nb
        hi = cfg.min_lr + cfg.min_lr_nb
        if not (lo < n < hi):
            return False

        def in_band(x):
            nb = cfg.min_lr_nb
            return (x < nb) or (8000 - nb < x < 8000 + nb) or (16000 - nb < x < 16000 + nb)
        if not (in_band(rd.start) and in_band(rd.start + n)):
            return False
    return True


def ingest_group(folder: str, cfg: DetectConfig,
                 files=None) -> Dict[Tuple[str, str], PositionPools]:
    """Walk a group folder, read corrected events with the native reader
    (fast5_ingest.cpp), or with h5py when ``native_ingest`` is off (raises
    where h5py is missing), build position pools.  ``files`` overrides
    discovery (the multi-process ingest passes this rank's shard)."""
    from nanomod_tpu_torch.native.fast5_bind import read_corrected_batch
    from nanomod_tpu_torch.native import require

    require("sort_core", *(("fast5_ingest",) if cfg.native_ingest else ()))
    if not cfg.native_ingest and fast5_io.h5py is None:
        raise RuntimeError("detect with native_ingest=False reads with "
                           "h5py, which is not installed")
    start_end = None
    pos_filter = None
    if cfg.pos is not None and cfg.pos2 is None:
        lo = max(cfg.pos - cfg.rank.window, 0)
        hi = cfg.pos + cfg.rank.window
        start_end = (lo, hi)           # read must span the window
        pos_filter = (lo, hi)          # events outside are dropped

    builder = PoolBuilder()
    if files is None:
        with stage("ingest.list", unit="files") as s:
            files = list(iter_fast5_files(folder))
            s.add(len(files))

    with stage("ingest", unit="reads") as s:
        if cfg.native_ingest:
            reads = read_corrected_batch(files, nthreads=cfg.num_workers)
        else:
            with ThreadPoolExecutor(max_workers=cfg.num_workers) as ex:
                reads = list(ex.map(read_corrected_events, files))
        s.add(sum(1 for r in reads if r is not None))

    with stage("accumulate", unit="reads") as s:
        for rd in reads:
            if rd is None:
                continue
            if not _read_passes_filters(rd, cfg, start_end):
                continue
            builder.add_read(rd.chrom, rd.strand, rd.start,
                             rd.norm_mean, rd.base, pos_filter=pos_filter)
            s.add(1)
    if cfg.out_level <= OUTPUT_INFO:
        print(f"Number of files in {folder} is {len(files)}")
    with stage("finalize_pools", unit="observations") as s:
        pools = builder.finalize(max_capacity=cfg.pool_capacity,
                                 nthreads=cfg.num_workers)
        s.add(sum(int(p.counts.sum()) for p in pools.values()))
    return pools


def detect_from_pools(
    pools1: Dict, pools2: Dict, cfg: DetectConfig, device="cuda",
    backend: Optional[str] = None,
    row_offsets: Optional[Dict[Tuple[str, str], int]] = None,
) -> Tuple[SignTable, np.ndarray]:
    """Coverage-filter, test (on ``device``), combine and rank two groups
    of pools.  Returns (table, order): table rows in (chrom, strand, pos)
    order, ``order`` the table indices by rank.  ``backend`` is passed to
    run_battery ("device" unless set).

    ``row_offsets`` maps (chrom, strand) to the global join-row index of
    this call's first joined row for that key; the position-sharded merge
    (parallel/shardmerge.py) passes it so the capped KS draws what the
    whole join draws.  None: these pools are the whole join.

    ``cfg.n_devices > 1`` shards each join's positions over a mesh of that
    many devices (parallel/mesh.make_mesh, which raises when there are
    fewer; parallel/sharded.py)."""
    device = resolve_device(device)
    mesh = None
    if cfg.n_devices and cfg.n_devices > 1:
        from nanomod_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(cfg.n_devices)
    with stage("coverage_filter", unit="positions") as s:
        pools1 = {k: v.filter_min_coverage(cfg.min_coverage) for k, v in pools1.items()}
        pools2 = {k: v.filter_min_coverage(cfg.min_coverage) for k, v in pools2.items()}
        pools1 = {k: v for k, v in pools1.items() if v.num_positions}
        pools2 = {k: v for k, v in pools2.items() if v.num_positions}
        s.add(sum(v.num_positions for v in pools1.values())
              + sum(v.num_positions for v in pools2.values()))

    keys = []
    parts = []
    with stage("test_battery", unit="positions") as s:
        for key, common, i1, i2 in join_pools(pools1, pools2):
            g1, g2 = pools1[key], pools2[key]
            bad = g1.base[i1] != g2.base[i2]
            if bad.any() and cfg.out_level <= OUTPUT_INFO:
                print(f"Warning: {bad.sum()} base mismatches between groups at {key}")
            off = row_offsets.get(key, 0) if row_offsets else 0
            if mesh is not None:
                from nanomod_tpu_torch.parallel.sharded import (
                    sharded_join_battery)
                res = sharded_join_battery(
                    mesh, g1.values[i1], g1.counts[i1],
                    g2.values[i2], g2.counts[i2], positions=common,
                    strand=key[1], cfg=cfg.stats, want_mstd=cfg.mstd,
                    row_offset=off)
            else:
                res = run_battery(
                    g1.values, g1.counts[i1], g2.values, g2.counts[i2],
                    strand=key[1], cfg=cfg.stats,
                    tile_positions=cfg.tile_positions, want_mstd=cfg.mstd,
                    row_offset=off, backend=backend, idx1=i1, idx2=i2,
                    device=device)
            keys.append(key)
            parts.append((key, common, g2.base[i2], g1.counts[i1], g2.counts[i2], res))
            s.add(len(common))

    if not parts:
        empty = TestResult(*(np.empty(0) for _ in range(6)))
        table = SignTable([], np.empty(0, np.int64), np.empty(0, np.int64),
                          np.empty(0, "<U1"), np.empty(0, np.int32),
                          np.empty(0, np.int32), empty)
        return table, np.empty(0, np.int64)

    group_ids = np.concatenate(
        [np.full(len(p[1]), gi, dtype=np.int64) for gi, p in enumerate(parts)]
    )
    positions = np.concatenate([p[1] for p in parts])
    base = np.concatenate([p[2] for p in parts]).astype("<U1")
    cov1 = np.concatenate([p[3] for p in parts]).astype(np.int32)
    cov2 = np.concatenate([p[4] for p in parts]).astype(np.int32)

    def cat(attr):
        return np.concatenate([getattr(p[5], attr) for p in parts])

    res = TestResult(
        stu=cat("stu"), pu=cat("pu"), stt=cat("stt"), pt=cat("pt"),
        stks=cat("stks"), pks=cat("pks"),
        mstd=(np.concatenate([p[5].mstd for p in parts]) if cfg.mstd else None),
    )

    # neighbor combination (ref myDetect.py:443: skipped for testMethod 'ks')
    if cfg.stats.test_method != "ks":
        if cfg.stats.neighbor_pvalues == 0:
            res.stcomb, res.pcomb = res.stks.copy(), res.pks.copy()
        elif mesh is not None:
            # combined per join on the mesh (join boundaries are invalid
            # neighbors in both paths, so per join == global)
            res.stcomb, res.pcomb = cat("stcomb"), cat("pcomb")
        else:
            with stage("combine_pvalues", unit="positions") as s:
                res.stcomb, res.pcomb = combine_neighbor_pvalues(
                    group_ids, positions, res.pks, cfg.stats
                )
                s.add(len(positions))

    table = SignTable(keys=[p[0] for p in parts], group_ids=group_ids,
                      positions=positions, base=base, cov1=cov1, cov2=cov2,
                      res=res)

    with stage("rank", unit="positions") as s:
        if cfg.rank.region_rank_by_st:
            order = region_rank(table, cfg.stats, cfg.rank)
        else:
            order = sort_sites(table, cfg.stats, cfg.rank)
        s.add(len(positions))
    return table, order


def save_sign_test(table: SignTable, cfg: DetectConfig) -> str:
    """Write <outFolder>/<FileID>_sign_test.txt in the reference's exact
    format: chrom strand pos1 base cov1 cov2 stU pU stT pT stKS pKS
    [stComb pComb], positions 1-based.  The native formatter
    (format_core.cpp) renders it; the Python loop is its byte-identical
    specification, used when native_ingest is off."""
    os.makedirs(cfg.out_folder, exist_ok=True)
    path = os.path.join(cfg.out_folder, f"{cfg.file_id}_sign_test.txt")
    r = table.res
    has_comb = (cfg.stats.test_method != "ks"
                and cfg.stats.neighbor_pvalues > 0
                and r.pcomb is not None)

    native_ok = False
    if cfg.native_ingest:
        from nanomod_tpu_torch.native.format_bind import write_sign_test_native
        from nanomod_tpu_torch.native import require
        require("format_core")
        native_ok = write_sign_test_native(table, path, has_comb,
                                           nthreads=cfg.num_workers)
    if not native_ok:
        with open(path, "w") as f:
            for i in range(len(table)):
                chrom, strand = table.chrom_strand(i)
                line = "%s %s %d %s %d %d %.3f %.3E %.3f %.3E %.3f %.3E" % (
                    chrom, strand, table.positions[i] + 1, table.base[i],
                    table.cov1[i], table.cov2[i],
                    r.stu[i], r.pu[i], r.stt[i], r.pt[i], r.stks[i], r.pks[i],
                )
                if has_comb:
                    line += " %.3f %.3E" % (r.stcomb[i], r.pcomb[i])
                f.write(line + "\n")

    if cfg.mstd and r.mstd is not None:
        mpath = os.path.join(cfg.out_folder, f"{cfg.file_id}_meanstd.cvs")
        m_ok = False
        if cfg.native_ingest:
            from nanomod_tpu_torch.native.format_bind import write_meanstd_native
            m_ok = write_meanstd_native(table, mpath,
                                        nthreads=cfg.num_workers)
        if not m_ok:
            with open(mpath, "w") as f:
                for i in range(len(table)):
                    chrom, strand = table.chrom_strand(i)
                    f.write("%s %s %d %s %.3f %.3f %.3f %.3f\n" % (
                        chrom, strand, table.positions[i], table.base[i],
                        r.mstd[i, 0], r.mstd[i, 1], r.mstd[i, 2], r.mstd[i, 3],
                    ))
    return path


def _plot_top_sites(table, sites, pools1, pools2, cfg, rank, world):
    """The reference's top-site plots (nanomod_tpu/detect.py:320-322).
    Under several processes every rank holds the same merged pools; rank 0
    draws the one PDF and the others wait for it."""
    from nanomod_tpu_torch.harness.plots import plot_top_sites
    from nanomod_tpu_torch.parallel import dist
    if rank == 0:
        plot_top_sites(table, sites, pools1, pools2, cfg)
    if world > 1:
        dist._multihost_gather(np.ones(1, np.int32))


def run_detect(cfg: DetectConfig, device="cuda",
               backend: Optional[str] = None):
    """Full detect pipeline on ``device``: ingest both groups, test,
    combine, save, rank and, with ``make_plots``, plot.  Under several
    processes (parallel/dist.py) each rank ingests its file shard and the
    pools merge across ranks, or, with ``merge_mode="sharded"``, each rank
    tests its own coordinate range (parallel/shardmerge.py).  Per-stage
    counters go to the global Observer (reset per run); cfg.metrics_file
    also records the kernels' launch counts (one file a rank under several
    processes, metrics_path); cfg.profile_dir (or NANOMOD_PROFILE_DIR)
    wraps the run in a torch.profiler trace of the host and the card, in
    which each stage is a ``nanomod.<stage>`` span (module docstring).
    Returns (table, order, sites)."""
    import time

    import nanomod_tpu_torch

    from nanomod_tpu_torch.metrics import metrics_path, write_metrics
    from nanomod_tpu_torch.parallel import dist

    if cfg.merge_mode not in ("union", "sharded"):
        raise ValueError(f"bad merge_mode {cfg.merge_mode!r}")
    device = resolve_device(device)
    nanomod_tpu_torch.tune_malloc()
    observer().reset()
    start = time.time()
    cpu_start = time.process_time()
    rank, world = dist.process_info()
    with device_trace(cfg.profile_dir, device):
        if world > 1 and cfg.merge_mode == "sharded":
            from nanomod_tpu_torch.parallel.shardmerge import (
                distributed_detect_sharded)
            table, order, sites = distributed_detect_sharded(
                cfg, device=device, backend=backend)
        else:
            if world > 1:
                pools1 = dist.ingest_group_multihost(cfg.wrk_base1, cfg)
                pools2 = dist.ingest_group_multihost(cfg.wrk_base2, cfg)
            else:
                pools1 = ingest_group(cfg.wrk_base1, cfg)
                pools2 = ingest_group(cfg.wrk_base2, cfg)
            table, order = detect_from_pools(pools1, pools2, cfg,
                                             device=device, backend=backend)
            if cfg.save_test:
                with stage("save", unit="positions") as s:
                    save_sign_test(table, cfg)
                    s.add(len(table))
            with stage("top_sites", unit="sites") as s:
                sites = top_sites(table, order, cfg.stats, cfg.rank,
                                  top_n=cfg.rank.top_n)
                s.add(len(sites))
            if cfg.make_plots:
                _plot_top_sites(table, sites, pools1, pools2, cfg, rank,
                                world)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        # read before device_trace exports its trace, which a plain run
        # does not do
        observer().add("host_cpu", len(table),
                       seconds=time.process_time() - cpu_start,
                       unit="positions")
    report(cfg.out_level)
    if cfg.metrics_file:
        write_metrics(metrics_path(cfg.metrics_file, rank, world), device,
                      positions=len(table), seconds=time.time() - start,
                      rank=rank, world_size=world)
    return table, order, sites
