# Copied from nanomod_tpu/harness/simulate.py; differs in the imports, the
# native reader in load_group_reads, shard_list from the port's
# parallel/dist.py (torch.distributed), the ``device`` / ``backend``
# arguments passed through to detect_from_pools, and the
# pools_from_selections stage.
"""Simulation / evaluation harness.

Rebuilds the reference's three benchmarking subcommands
(ref bin/scripts/mySimulate.py, mySimulat2.py, myDownSampling0.py): mix
case/control reads, rerun detection, and record the rank of a known
modified site.  Where the reference fans the experiment grid out over an
SGE cluster with qsub/qstat polling (mySimulate.py:344-457), the rebuilt
detection core is fast enough to sweep the grid in-process; grid points
and sweep sizes are sharded round-robin by process id and count, by
default the process group's (``shard_list``).  Every trial is a whole
``detect_from_pools`` on ``device`` (kernel K3 on a card).

Rank semantics follow getTopRank (ref mySimulate.py:287-328): sites are
walked in significance order with min-distance dedup and a completeness
check over the ±window neighborhood; the recorded value is the output rank
of the first site within `closesize` of the target (or -1).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from collections import defaultdict

from nanomod_tpu_torch.accum.pools import (PoolBuilder, build_canonical_keys,
                                           decode_canonical_keys,
                                           pack_observations, pack_sorted_keys,
                                           read_observations)
from nanomod_tpu_torch.config import DetectConfig, SimulateConfig, replace
from nanomod_tpu_torch.io.fast5 import iter_fast5_files
from nanomod_tpu_torch.detect import detect_from_pools
from nanomod_tpu_torch.native import load_native, require
from nanomod_tpu_torch.parallel.dist import shard_list
from nanomod_tpu_torch.rank.ranking import top_sites
from nanomod_tpu_torch.utils.observe import stage


def load_group_reads(folder: str, recursive: bool = True):
    """Load all corrected reads of a folder (mySimulate.readEvents,
    ref mySimulate.py:101-122) with the native reader (fast5_ingest.cpp).
    Returns {filename: CorrectedRead} in file-walk order; a later file of
    the same name replaces the read but keeps the first one's place."""
    from nanomod_tpu_torch.native.fast5_bind import read_corrected_batch

    require("fast5_ingest", "sort_core")
    paths = list(iter_fast5_files(folder, recursive=recursive))
    out = {}
    for p, rd in zip(paths, read_corrected_batch(paths)):
        if rd is not None:
            out[os.path.basename(p)] = rd
    return out


class FlatReads:
    """One read dict flattened and canonical-SORTED once into
    per-(chrom, strand) u64 pool-key arrays (VERDICT r4: the harness
    rebuilt pools read-by-read through PoolBuilder.add_read for EVERY
    mixing trial — hundreds of interpreted rebuilds per grid,
    ref mySimulate.py:209-251 semantics).

    Each observation's key (accum.pools.build_canonical_keys) encodes
    (position, value, base code) so that ascending key order IS the
    canonical pool order; the per-read identity rides alongside.  A trial
    is then: boolean keep-mask over reads -> mask-gather of the sorted
    keys (still sorted!) -> vectorized merge across read sets -> native
    scan/fill (accum.pools.pack_sorted_keys) — no per-trial sort at all.
    Byte-identical to the per-read rebuild for the same read selection
    (tested in tests/test_harness.py)."""

    def __init__(self, reads: Dict):
        self.keys = list(reads)
        self.n_reads = len(self.keys)
        per = defaultdict(lambda: ([], [], [], []))
        for ridx, k in enumerate(self.keys):
            rd = reads[k]
            pos, means, codes = read_observations(
                rd.strand, rd.start, rd.norm_mean, rd.base)
            if not len(pos):
                continue
            p, v, c, r = per[(rd.chrom, rd.strand)]
            p.append(pos)
            v.append(means)
            c.append(codes)
            r.append(np.full(len(pos), ridx, np.int32))
        # groups: (chrom, strand) -> (sorted keys u64, read_id aligned,
        #                             pmin) | raw (pos, val, cod, read_id)
        # when the position span exceeds the 29-bit key budget
        self.groups = {}
        for g, arrs in per.items():
            pos, val, cod, rid = (np.concatenate(x) for x in arrs)
            built = build_canonical_keys(pos, val, cod)
            if built is None:
                self.groups[g] = ("raw", pos, val, cod, rid)
                continue
            key, pmin = built
            order = np.argsort(key, kind="stable")
            self.groups[g] = ("keys", key[order], rid[order], pmin)

    @staticmethod
    def of(reads) -> "FlatReads":
        return reads if isinstance(reads, FlatReads) else FlatReads(reads)

    def select(self, keep: np.ndarray) -> Dict:
        """Gather the observations of the kept reads, per (chrom, strand):
        ("keys", sorted_keys, pmin) or ("raw", pos, val, cod) entries for
        keep [n_reads] bool."""
        out = {}
        keep_u8 = None
        for g, entry in self.groups.items():
            if entry[0] == "keys":
                _, key, rid, pmin = entry
                sub = None
                if len(key) >= (1 << 14):
                    if keep_u8 is None:
                        keep_u8 = np.ascontiguousarray(keep, np.uint8)
                    sub = _native_masked_gather(key, rid, keep_u8)
                if sub is None:
                    m = keep[rid]
                    sub = key[m] if m.any() else None
                if sub is not None and len(sub):
                    out[g] = ("keys", sub, pmin)
            else:
                _, pos, val, cod, rid = entry
                m = keep[rid]
                if m.any():
                    out[g] = ("raw", pos[m], val[m], cod[m])
        return out

    def select_all(self) -> Dict:
        out = {}
        for g, entry in self.groups.items():
            if entry[0] == "keys":
                _, key, rid, pmin = entry
                out[g] = ("keys", key, pmin)
            else:
                _, pos, val, cod, rid = entry
                out[g] = ("raw", pos, val, cod)
        return out


def _native_masked_gather(key: np.ndarray, rid: np.ndarray,
                          keep_u8: np.ndarray):
    """Order-preserving native gather of key[i] where keep_u8[rid[i]]
    (sort_core.cpp nm_masked_gather_u64); None when unavailable."""
    import ctypes

    lib = load_native("sort_core")
    if lib is None or not hasattr(lib, "nm_masked_gather_u64"):
        return None
    out = np.empty(len(key), np.uint64)
    p64 = ctypes.POINTER(ctypes.c_uint64)
    lib.nm_masked_gather_u64.restype = ctypes.c_int64
    got = lib.nm_masked_gather_u64(
        key.ctypes.data_as(p64),
        rid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(key)),
        keep_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(p64),
        ctypes.c_int(os.cpu_count() or 1))
    return out[:got]


def _merge_sorted_u64(arrays: List[np.ndarray]) -> np.ndarray:
    """K-way merge of sorted u64 arrays by repeated vectorized 2-way
    merges (searchsorted insert positions + scatter)."""
    out = arrays[0]
    for k2 in arrays[1:]:
        k1 = out
        ins = np.searchsorted(k1, k2, side="right") \
            + np.arange(len(k2), dtype=np.int64)
        merged = np.empty(len(k1) + len(k2), np.uint64)
        taken = np.zeros(len(merged), bool)
        taken[ins] = True
        merged[ins] = k2
        merged[~taken] = k1
        out = merged
    return out


def pools_from_selections(selections: Sequence[Dict]) -> Dict:
    """Build PositionPools from one or more FlatReads.select results
    (getGenomeEvents accumulation, ref mySimulate.py:124-139).

    Key-form selections merge WITHOUT sorting (each is already in
    canonical order; merging sorted runs is O(n)); raw-form groups fall
    back to the full fused pack.  Stage ``pools_from_selections``
    (positions built)."""
    with stage("pools_from_selections", unit="positions") as stg:
        merged = defaultdict(list)
        for sel in selections:
            for g, entry in sel.items():
                merged[g].append(entry)
        out = {}
        for (chrom, strand), entries in sorted(merged.items()):
            key_ok = all(e[0] == "keys" for e in entries)
            if key_ok:
                pmin = min(e[2] for e in entries)
                # re-basing to the common pmin must keep every position
                # field inside the 29-bit key budget
                key_ok = all(
                    int(e[1][-1] >> np.uint64(35)) + (e[2] - pmin)
                    < (1 << 29) for e in entries if len(e[1]))
            if key_ok:
                keys = [e[1] if e[2] == pmin
                        else e[1] + (np.uint64(e[2] - pmin) << np.uint64(35))
                        for e in entries]
                key = _merge_sorted_u64(keys)
                out[(chrom, strand)] = pack_sorted_keys(chrom, strand, key,
                                                        pmin)
            else:
                ps, vs, cs = [], [], []
                for e in entries:
                    if e[0] == "keys":
                        p, v, c = decode_canonical_keys(e[1], e[2])
                    else:
                        p, v, c = e[1], e[2], e[3]
                    ps.append(p)
                    vs.append(v)
                    cs.append(c)
                out[(chrom, strand)] = pack_observations(
                    chrom, strand, np.concatenate(ps), np.concatenate(vs),
                    np.concatenate(cs))
        stg.add(sum(p.num_positions for p in out.values()))
    return out


def _pools_from_reads(read_sets: Sequence[Dict]) -> Dict:
    """Per-read pool accumulation (getGenomeEvents, ref
    mySimulate.py:124-139).  Kept as the parity oracle for the flattened
    trial path (FlatReads + pools_from_selections); production trials use
    the flat path."""
    builder = PoolBuilder()
    for reads in read_sets:
        for rd in reads.values():
            builder.add_read(rd.chrom, rd.strand, rd.start, rd.norm_mean, rd.base)
    return builder.finalize()


def _close_size(cfg: SimulateConfig) -> int:
    closesize = cfg.stats.neighbor_pvalues * 2
    if cfg.rank.region_rank_by_st:
        closesize = max(cfg.rank.window, 1)
    return closesize


def rank_of_target(table, order, cfg: SimulateConfig) -> int:
    """getTopRank (ref mySimulate.py:287-328): output rank of the first
    dedup'd, window-complete site within closesize of the target, or -1."""
    closesize = _close_size(cfg)
    sites = top_sites(
        table, order, cfg.stats, cfg.rank, top_n=None,
        require_complete_window=True,
        stop_at=(cfg.target_chr, cfg.target_strand, cfg.target_pos, closesize),
    )
    if sites and sites[-1].chrom == cfg.target_chr \
            and sites[-1].strand == cfg.target_strand \
            and abs(sites[-1].pos - cfg.target_pos) < closesize:
        return sites[-1].rank
    return -1


def _detect_cfg(cfg: SimulateConfig) -> DetectConfig:
    return DetectConfig(min_coverage=cfg.min_coverage, stats=cfg.stats,
                        rank=cfg.rank, out_level=cfg.out_level,
                        save_test=False)


def mix_and_rank(case_reads, control_mix, control_test,
                 percentage: float, cfg: SimulateConfig,
                 rng: random.Random,
                 control_test_pools: Optional[Dict] = None,
                 device="cuda", backend: Optional[str] = None) -> int:
    """One Bernoulli mixing trial (mSimulate1 inner loop,
    ref mySimulate.py:209-251): group1 = case@p + control_mix@(1-p),
    group2 = control_test.  Accepts read dicts or FlatReads; the RNG
    stream is one uniform per read in dict order, exactly like the
    reference's per-read comprehension (ref :219-223).
    `control_test_pools` lets sweep callers reuse the trial-invariant
    group-2 pools.  Detection runs on ``device`` with the battery
    ``backend``."""
    case = FlatReads.of(case_reads)
    cmix = FlatReads.of(control_mix)
    ctest = FlatReads.of(control_test)
    keep_case = np.fromiter(
        (rng.uniform(0, 1) <= percentage for _ in range(case.n_reads)),
        bool, count=case.n_reads)
    keep_mix = np.fromiter(
        (rng.uniform(0, 1) < 1 - percentage for _ in range(cmix.n_reads)),
        bool, count=cmix.n_reads)
    pools1 = pools_from_selections(
        [case.select(keep_case), cmix.select(keep_mix)])
    pools2 = (control_test_pools if control_test_pools is not None
              else pools_from_selections([ctest.select_all()]))
    table, order = detect_from_pools(pools1, pools2, _detect_cfg(cfg),
                                     device=device, backend=backend)
    return rank_of_target(table, order, cfg)


def run_simulate(cfg: SimulateConfig,
                 case_reads: Optional[Dict] = None,
                 control_mix: Optional[Dict] = None,
                 control_test: Optional[Dict] = None,
                 device="cuda",
                 backend: Optional[str] = None) -> Dict[float, List[int]]:
    """Percentage-sweep simulation (worker mode, mSimulate1,
    ref mySimulate.py:164-261).  Seeded like the reference
    (random.seed, ref :335)."""
    rng = random.Random(cfg.seed)
    case_reads = case_reads if case_reads is not None else load_group_reads(cfg.wrk_base2)
    control_mix = control_mix if control_mix is not None else load_group_reads(cfg.wrk_base1)
    control_test = control_test if control_test is not None else load_group_reads(
        cfg.wrk_base3 or cfg.wrk_base1)
    case = FlatReads.of(case_reads)
    cmix = FlatReads.of(control_mix)
    ctest = FlatReads.of(control_test)
    # group 2 never changes across trials: build its pools once
    pools2 = pools_from_selections([ctest.select_all()])

    results: Dict[float, List[int]] = {}
    for perc in sorted(cfg.percentages):
        results[perc] = []
        for rt in range(cfg.random_times):
            r = mix_and_rank(case, cmix, ctest, perc, cfg, rng,
                             control_test_pools=pools2, device=device,
                             backend=backend)
            results[perc].append(r)
            if cfg.out_level <= 1:
                print(f"Rank {perc} {rt} {r}")
    _save_output(results, cfg, fmt_key="%.5f")
    return results


def run_simulat2(cfg: SimulateConfig,
                 case_reads: Optional[Dict] = None,
                 control_reads: Optional[Dict] = None,
                 device="cuda", backend: Optional[str] = None) -> List[int]:
    """Fixed-percentage, exact-case-size simulation (runType 2,
    ref mySimulat2.py:101-181): sample CaseSize case reads and
    CaseSize*(1-p)/p + CaseSize/p control reads without replacement."""
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    case_reads = case_reads if case_reads is not None else load_group_reads(cfg.wrk_base2)
    control_reads = control_reads if control_reads is not None else load_group_reads(cfg.wrk_base1)
    case = FlatReads.of(case_reads)
    cont = FlatReads.of(control_reads)

    n_case = cfg.case_size
    n_con1 = int(n_case * (1 - cfg.percentage) / cfg.percentage)
    n_con2 = int(n_case / cfg.percentage)

    ranks = []
    for rt in range(cfg.random_times):
        ci = np.random.choice(case.n_reads, min(n_case, case.n_reads),
                              replace=False)
        keep_case = np.zeros(case.n_reads, bool)
        keep_case[ci] = True
        need = min(n_con1 + n_con2, cont.n_reads)
        oi = np.random.choice(cont.n_reads, need, replace=False)
        keep_con1 = np.zeros(cont.n_reads, bool)
        keep_con1[oi[:n_con1]] = True
        keep_con2 = np.zeros(cont.n_reads, bool)
        keep_con2[oi[n_con1:]] = True
        pools1 = pools_from_selections(
            [case.select(keep_case), cont.select(keep_con1)])
        pools2 = pools_from_selections([cont.select(keep_con2)])
        table, order = detect_from_pools(pools1, pools2, _detect_cfg(cfg),
                                         device=device, backend=backend)
        ranks.append(rank_of_target(table, order, cfg))
        if cfg.out_level <= 1:
            print(f"Rank {cfg.percentage} {rt} {ranks[-1]}")
    _save_output({cfg.case_size: ranks}, cfg, fmt_key="%d")
    return ranks


def run_downsampling(cfg: SimulateConfig,
                     case_reads: Optional[Dict] = None,
                     control_reads: Optional[Dict] = None,
                     device="cuda",
                     backend: Optional[str] = None) -> List[int]:
    """Coverage-scaling simulation (myDownSampling0.mSimulate1,
    ref myDownSampling0.py:38-132): equal-size case/control samples with a
    coverage-at-target acceptance check (>= 0.95*CaseSize/5 at target±3)
    and adaptive 2% oversampling on repeated failures."""
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    case_reads = case_reads if case_reads is not None else load_group_reads(cfg.wrk_base1)
    control_reads = control_reads if control_reads is not None else load_group_reads(cfg.wrk_base2)
    case = FlatReads.of(case_reads)
    cont = FlatReads.of(control_reads)

    ranks = []
    rt = repeat_time = cur_repeat_time = 0
    attempts = 0
    while rt < cfg.random_times and attempts < cfg.random_times * 30:
        attempts += 1
        more = min(repeat_time, 15)
        n = int(cfg.case_size * (1 + more * 0.02))
        if case.n_reads > n:
            ci = np.random.choice(case.n_reads, n, replace=False)
            keep_case = np.zeros(case.n_reads, bool)
            keep_case[ci] = True
        else:
            keep_case = np.ones(case.n_reads, bool)
        if cont.n_reads > n:
            oi = np.random.choice(cont.n_reads, n, replace=False)
            keep_con = np.zeros(cont.n_reads, bool)
            keep_con[oi] = True
        else:
            keep_con = np.ones(cont.n_reads, bool)
        pools1 = pools_from_selections([case.select(keep_case)])
        pools2 = pools_from_selections([cont.select(keep_con)])

        # coverage-at-target acceptance (ref :94-113)
        lacking = 0
        need = 0.95 * cfg.case_size / 5
        key = (cfg.target_chr, cfg.target_strand)
        for pools in (pools1, pools2):
            pp = pools.get(key)
            for pos in range(cfg.target_pos - 3, cfg.target_pos + 4):
                if pp is None:
                    lacking += 1
                    continue
                idx = np.searchsorted(pp.positions, pos)
                cnt = int(pp.counts[idx]) if (idx < len(pp.positions)
                                              and pp.positions[idx] == pos) else 0
                if cnt < need:
                    lacking += 1
        if lacking > 2:
            if lacking > 3 and cur_repeat_time > 5:
                repeat_time += 1
            cur_repeat_time += 1
            continue

        table, order = detect_from_pools(pools1, pools2, _detect_cfg(cfg),
                                         device=device, backend=backend)
        ranks.append(rank_of_target(table, order, cfg))
        rt += 1
        cur_repeat_time = 0
    _save_output({cfg.case_size: ranks}, cfg, fmt_key="%d")
    return ranks


def _save_output(results: Dict, cfg: SimulateConfig, fmt_key: str):
    """.output rank files + .done sentinel (ref mySimulate.py:258-277)."""
    os.makedirs(cfg.out_folder, exist_ok=True)
    base = os.path.join(cfg.out_folder, cfg.file_id)
    with open(base + ".output", "w") as f:
        for k in sorted(results):
            f.write(fmt_key % k)
            for r in results[k]:
                if int(r) < 0:
                    continue
                f.write(" %d" % r)
            f.write("\n")
    open(base + ".done", "w").close()


def get_subfolders(base: str) -> Tuple[List[str], int]:
    """Numbered-subfolder discovery (getSubFolders, ref mySimulate.py:74-99):
    returns (names, max_int+...)  — the grid iterates range(max_int) like
    the reference (note: the reference uses the MAXIMUM folder number as the
    exclusive bound, so a missing intermediate number yields an empty
    worker, exactly as its qsub fan-out did)."""
    subs = []
    mx = -1
    for name in sorted(os.listdir(base)):
        if not os.path.isdir(os.path.join(base, name)):
            continue
        try:
            v = int(name)
        except ValueError:
            continue
        subs.append(name)
        mx = max(mx, v)
    if mx == -1:
        raise FileNotFoundError(f"no numbered subfolders under {base} "
                                "(cluster/grid mode needs 0/ 1/ 2/ ...)")
    return subs, mx


def grid_file_id(cfg: SimulateConfig, mi: int, mj: int, mk: int,
                 perc: float) -> str:
    """Per-grid-point FileID, matching the reference's qsub job naming
    (ref mySimulate.py:350: '%s_%d_%d_%d_%.5f')."""
    return "%s_%d_%d_%d_%.5f" % (cfg.file_id, mi, mj, mk, perc)


def run_simulate_grid(cfg: SimulateConfig,
                      process_id: Optional[int] = None,
                      process_count: Optional[int] = None,
                      device="cuda", backend: Optional[str] = None):
    """Cluster-mode percentage simulation (ref mySimulate.py:344-467): the
    (control-subfolder mi × case-subfolder mj) grid with control-test
    subfolder mk = (mi + foldersep) % max_control, one worker per
    (mi, mj, percentage).

    The reference fans this out as qsub jobs and polls qstat; here the
    grid points are sharded round-robin across processes (shard_list, by
    process_id/process_count, the process group's by default) and each
    process sweeps its shard in-process.  Workers write the same per-point
    `.output`/`.done` files, so the merge (merge_grid_outputs) is the
    reference's file-level concatenation (ref :454-464).

    Returns (all_file_ids, local_results) — every host returns the full
    file-id list for merging; local_results holds only this host's shard.
    """
    _, max0 = get_subfolders(cfg.wrk_base1)
    _, max1 = get_subfolders(cfg.wrk_base2)
    grid = []
    for mj in range(max1):
        for mi in range(max0):
            mk = (mi + cfg.foldersep) % max0
            grid.append((mi, mj, mk))

    all_fids = [grid_file_id(cfg, mi, mj, mk, perc)
                for (mi, mj, mk) in grid for perc in sorted(cfg.percentages)]

    local = shard_list(grid, process_id, process_count)
    local_results = {}
    for (mi, mj, mk) in local:
        sub_common = replace(
            cfg,
            wrk_base1=os.path.join(cfg.wrk_base1, str(mi)),
            wrk_base2=os.path.join(cfg.wrk_base2, str(mj)),
            wrk_base3=os.path.join(cfg.wrk_base1, str(mk)),
        )
        case_reads = FlatReads(load_group_reads(sub_common.wrk_base2))
        control_mix = FlatReads(load_group_reads(sub_common.wrk_base1))
        control_test = FlatReads(load_group_reads(sub_common.wrk_base3))
        for perc in sorted(cfg.percentages):
            sub = replace(sub_common, percentages=(perc,),
                          file_id=grid_file_id(cfg, mi, mj, mk, perc))
            res = run_simulate(sub, case_reads=case_reads,
                               control_mix=control_mix,
                               control_test=control_test, device=device,
                               backend=backend)
            local_results[sub.file_id] = res
    return all_fids, local_results


def merge_grid_outputs(cfg: SimulateConfig, file_ids: List[str],
                       seqsize: int = 6184 // 3):
    """Merge per-grid-point `.output` files by percentage and bin the ranks
    (the reference's post-qsub merge + group_rank, ref mySimulate.py:454-517).
    Grid points whose `.done` sentinel is missing are skipped with a count,
    like the reference's 3-strikes tolerance."""
    done = [fid for fid in file_ids
            if os.path.isfile(os.path.join(cfg.out_folder, fid + ".done"))]
    missing = len(file_ids) - len(done)
    if missing and cfg.out_level <= 2:
        print(f"Warning: {missing}/{len(file_ids)} grid outputs missing")
    return summarize_outputs(cfg.out_folder, done, seqsize=seqsize)


def run_simulat2_sweep(cfg: SimulateConfig, case_sizes=None,
                       start: int = 1000, step: int = 1000,
                       process_id: Optional[int] = None,
                       process_count: Optional[int] = None,
                       device="cuda", backend: Optional[str] = None):
    """runType 1 (ref mySimulat2.py:223-256): sweep CaseSize from `start`
    by `step` up to the maximum supportable by the control pool at the
    given percentage.  The reference submits one qsub job per size; here
    the sizes are sharded round-robin across processes (shard_list) and
    each process sweeps its shard in-process; runType 3
    (summarize_outputs) merges the per-size `.output` files exactly like
    the reference's post-qsub loop."""
    case_reads = FlatReads(load_group_reads(cfg.wrk_base2))
    control_reads = FlatReads(load_group_reads(cfg.wrk_base1))
    if case_sizes is None:
        total_control = control_reads.n_reads
        max_case = int(total_control * cfg.percentage / (2 - cfg.percentage))
        case_sizes = list(range(start, max(max_case, start + 1), step))
    results = {}
    for cs in shard_list(list(case_sizes), process_id, process_count):
        sub = replace(cfg, case_size=int(cs),
                      file_id=f"{cfg.file_id}_{cs}")
        results[int(cs)] = run_simulat2(sub, case_reads=case_reads,
                                        control_reads=control_reads,
                                        device=device, backend=backend)
    _save_output(results, replace(cfg, file_id=cfg.file_id + "_all"),
                 fmt_key="%d")
    return results


def run_downsampling_sweep(cfg: SimulateConfig, case_sizes=None,
                           process_id: Optional[int] = None,
                           process_count: Optional[int] = None,
                           device="cuda", backend: Optional[str] = None):
    """DownSampling runType 1 (ref myDownSampling0.py:180-188): the fixed
    CaseSize ladder {60, 80, 100, 200, 400, 1000, 2000, 3000}, sharded
    round-robin across processes like run_simulat2_sweep."""
    case_sizes = case_sizes or [60, 80, 100, 200, 400, 1000, 2000, 3000]
    case_reads = FlatReads(load_group_reads(cfg.wrk_base1))
    control_reads = FlatReads(load_group_reads(cfg.wrk_base2))
    results = {}
    for cs in shard_list(list(case_sizes), process_id, process_count):
        sub = replace(cfg, case_size=int(cs), file_id=f"{cfg.file_id}_{cs}")
        results[int(cs)] = run_downsampling(sub, case_reads=case_reads,
                                            control_reads=control_reads,
                                            device=device, backend=backend)
    _save_output(results, replace(cfg, file_id=cfg.file_id + "_all"),
                 fmt_key="%d")
    return results


def summarize_outputs(out_folder: str, file_ids, seqsize: int = 6184 // 3):
    """runType 3: merge .output files and bin ranks (the reference's merge
    loop + mplotall, ref mySimulat2.py:282-311,430-586)."""
    merged = {}
    for fid in file_ids:
        path = os.path.join(out_folder, f"{fid}.output")
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                key = float(parts[0])
                merged.setdefault(key, []).extend(int(x) for x in parts[1:])
    return group_ranks(merged, seqsize=seqsize)


# ---------------------------------------------------------------------------
# Rank percentile binning (myBinDefault, ref mySimulate.py:32-55)
# ---------------------------------------------------------------------------

def rank_bins(seqsize: int = 6184 // 3):
    """(bins {rank -> label}, split_points, labels): percentile bins at
    0.1/0.25/0.5/1/2/3/4/5% of seqsize."""
    percentiles = [0.001, 0.0025, 0.005, 0.01, 0.02, 0.03, 0.04, 0.05]
    labels = ["(, %.2f%%]" % (percentiles[0] * 100)]
    bins = {}
    split_points = [int(p * seqsize) for p in percentiles]
    for rp in range(1, split_points[0] + 1):
        bins[rp] = labels[0]
    for i in range(len(split_points)):
        if i == len(split_points) - 1:
            lab = "(%.2f%%, )" % (percentiles[i] * 100)
            labels.append(lab)
            bins[split_points[i] + 1] = lab
        else:
            lab = "(%.2f%%, %.2f%%]" % (percentiles[i] * 100,
                                        percentiles[i + 1] * 100)
            labels.append(lab)
            for j in range(split_points[i] + 1, split_points[i + 1] + 1):
                bins[j] = lab
    return bins, split_points, labels


def group_ranks(results: Dict[float, List[int]], seqsize: int = 6184 // 3):
    """Fraction of trials per percentile bin, per sweep key
    (group_rank, ref mySimulate.py:478-517)."""
    bins, split_points, labels = rank_bins(seqsize)
    out = {}
    for k, ranks in results.items():
        counts = {lab: 0 for lab in labels}
        total = 0
        for r in ranks:
            r = int(r)
            if r <= 0:
                continue
            lab = bins.get(r, labels[-1]) if r <= split_points[-1] else labels[-1]
            counts[lab] += 1
            total += 1
        if total:
            out[k] = {lab: c / total for lab, c in counts.items()}
    return out, labels
