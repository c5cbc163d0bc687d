# Copied from nanomod_tpu/rank/ranking.py; only the imports differ.
"""Site ranking, dedup, and region-window ranking.

Replicates mtest2's ranking tail (ref bin/scripts/myDetect.py:447-520), the
top-N dedup walk of mboxplot (ref :279-297) and the window-completeness
check used by the sim harness's getTopRank (ref mySimulate.py:287-328).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from nanomod_tpu_torch.config import RankConfig, StatConfig
from nanomod_tpu_torch.stats.battery import TestResult


@dataclass
class SignTable:
    """The joined, tested position table — the reference's ``sign_test``
    list as dense arrays, ordered by (chrom, strand, pos) exactly like the
    reference's sorted-key iteration (ref myDetect.py:427-431)."""

    keys: List[Tuple[str, str]]      # per-group (chrom, strand), sorted
    group_ids: np.ndarray            # [P] index into keys
    positions: np.ndarray            # [P] int64 0-based genomic positions
    base: np.ndarray                 # [P] '<U1'
    cov1: np.ndarray                 # [P] int32
    cov2: np.ndarray                 # [P] int32
    res: TestResult = None

    def __len__(self):
        return len(self.positions)

    def chrom_strand(self, i: int) -> Tuple[str, str]:
        return self.keys[self.group_ids[i]]

    def columns(self, cfg: StatConfig):
        """(sorted_col_stat, sorted_col_p) used for ranking: the combined
        column when present, else the KS column (ref myDetect.py:452-454)."""
        if cfg.test_method != "ks" and self.res.pcomb is not None:
            return self.res.stcomb, self.res.pcomb
        return self.res.stks, self.res.pks


def sort_sites(table: SignTable, stat_cfg: StatConfig, rank_cfg: RankConfig) -> np.ndarray:
    """Order of sites by significance (indices into the table).

    Mirrors myDetect.py:459-462: stable sort by (rank_col, ks, u) on p-values
    ('pv') or statistics ('st', then reversed).
    """
    st_col, p_col = table.columns(stat_cfg)
    if rank_cfg.rank_use == "pv":
        prim, sec, ter = p_col, table.res.pks, table.res.pu
    else:
        prim, sec, ter = st_col, table.res.stks, table.res.stu
    order = np.lexsort((ter, sec, prim))  # stable: last key is primary
    if rank_cfg.rank_use == "st":
        order = order[::-1]
    return order


def _close_size(stat_cfg: StatConfig, rank_cfg: RankConfig) -> int:
    """Dedup radius (ref myDetect.py:279-283)."""
    if rank_cfg.region_rank_by_st:
        return max(rank_cfg.window, 1)
    return stat_cfg.neighbor_pvalues * 2


def _window_complete(table: SignTable, idx: int, window: int) -> bool:
    """pos_check over the ±window index neighborhood (ref
    mySimulate.py:315-318): every neighbor index must exist, share
    (chrom,strand) and be genomically contiguous."""
    n = len(table)
    gid = table.group_ids
    pos = table.positions
    for j in range(idx - window, idx + window + 1):
        if j < 0 or j >= n:
            return False
        if j == idx:
            continue
        if gid[j] != gid[idx] or (idx - j) != (pos[idx] - pos[j]):
            return False
    return True


@dataclass
class RankedSite:
    rank: int                        # 1-based output rank
    chrom: str
    strand: str
    pos: int                         # 0-based
    base: str
    table_index: int


def top_sites(
    table: SignTable,
    order: np.ndarray,
    stat_cfg: StatConfig,
    rank_cfg: RankConfig,
    top_n: Optional[int] = None,
    require_complete_window: bool = False,
    stop_at: Optional[Tuple[str, str, int, int]] = None,
) -> List[RankedSite]:
    """Walk the sorted site list applying min-distance dedup.

    Mirrors the mboxplot loop (ref myDetect.py:284-297) and, with
    require_complete_window, getTopRank (ref mySimulate.py:300-327).
    stop_at=(chrom,strand,pos,closesize) stops once a site within closesize
    of the target is emitted (getTopRank's early exit, mySimulate.py:327).
    """
    closesize = _close_size(stat_cfg, rank_cfg)
    out: List[RankedSite] = []
    emitted = set()          # (chrom, strand, pos) for O(closesize) dedup
    for oi in order:
        chrom, strand = table.chrom_strand(oi)
        pos = int(table.positions[oi])
        too_close = any(
            (chrom, strand, p) in emitted
            for p in range(pos - closesize + 1, pos + closesize)
        )
        if too_close:
            continue
        if require_complete_window and not _window_complete(table, oi, rank_cfg.window):
            continue
        out.append(RankedSite(len(out) + 1, chrom, strand, pos,
                              str(table.base[oi]), int(oi)))
        emitted.add((chrom, strand, pos))
        if stop_at is not None:
            tchrom, tstrand, tpos, tclose = stop_at
            if chrom == tchrom and strand == tstrand and abs(pos - tpos) < tclose:
                break
        if top_n is not None and len(out) >= top_n:
            break
    return out


def region_candidates(table: SignTable, stat_cfg: StatConfig,
                      rank_cfg: RankConfig, spans=None):
    """Score every complete region window of the table.

    Returns (q, tie, ti, gs, pk) arrays in (group, pk) append order —
    exactly the reference's windseg build (ref myDetect.py:478-508) before
    its sort.  ``spans`` optionally overrides each group's (pmin, pmax):
    the multi-host sharded path passes the GLOBAL span so window-grid
    alignment and the ``cp >= pmax`` quirk match the single-host run even
    though this table only holds one coordinate range (+halo).
    """
    w = rank_cfg.window + 1                       # ref :465 window += 1
    offsets = np.arange(-w, w + 1)                # 2w+1 window columns
    movesize = 1 if rank_cfg.wind_ovlp else w

    st_col, p_col = table.columns(stat_cfg)
    vals = np.asarray(p_col if rank_cfg.rank_use == "pv" else st_col,
                      dtype=np.float64)

    gid = table.group_ids
    pos = table.positions
    q_all, tie_all, ti_all, g_all, pk_all = [], [], [], [], []
    for g in range(len(table.keys)):
        sel = np.where(gid == g)[0]
        if len(sel) == 0:
            continue
        gpos = pos[sel]
        lmin, lmax = int(gpos.min()), int(gpos.max())
        pmin, pmax = (spans[g] if spans and g in spans else (lmin, lmax))
        # dense position -> table-index lookup over the LOCAL span
        idx_at = np.full(lmax - lmin + 1, -1, dtype=np.int64)
        idx_at[gpos - lmin] = sel

        # window centers on the global grid, restricted to local coverage
        first = pmin + max(0, -(-(lmin - pmin) // movesize)) * movesize
        cand = np.arange(first, min(pmax, lmax + 1), movesize,
                         dtype=np.int64)
        if len(cand) == 0:
            continue
        mat_pos = cand[:, None] + offsets[None, :]          # [K, 2w+1]
        inb = (mat_pos >= 0) & (mat_pos < pmax)             # quirk: < pmax
        ti = idx_at[np.clip(mat_pos - lmin, 0, lmax - lmin)]
        # mat_pos outside the local span would alias into the clip
        present = inb & (mat_pos >= lmin) & (mat_pos <= lmax) & (ti >= 0)
        complete = present.all(axis=1)
        center_ok = idx_at[np.clip(cand - lmin, 0, lmax - lmin)] >= 0
        center_ok &= (cand >= lmin) & (cand <= lmax)
        ti = np.where(present, ti, 0)

        include = present
        if rank_cfg.na:
            include = include & (table.base[ti] == rank_cfg.na)
        m = include.sum(axis=1)
        keep = complete & center_ok & (m > 5)
        if not keep.any():
            continue
        ti_k = ti[keep]
        include_k = include[keep]
        m_k = m[keep]

        pv = np.where(include_k, vals[ti_k], np.inf)
        # percentile-th smallest of the included values (ref :502)
        spv = np.sort(pv, axis=1)
        k_row = (rank_cfg.percentile * (m_k - 1) + 0.5).astype(np.int64)
        q = spv[np.arange(len(spv)), k_row]
        # tie = |w - index of the window minimum in the FILTERED order|
        # (ref :503: opv.index(spv[0]) on the NA-filtered list)
        amin = np.argmin(pv, axis=1)              # first occurrence of min
        filt_idx = np.cumsum(include_k, axis=1)[
            np.arange(len(amin)), amin] - 1
        tie = np.abs(w - filt_idx)

        q_all.append(q)
        tie_all.append(tie)
        ti_all.append(idx_at[cand[keep] - lmin])
        g_all.append(np.full(keep.sum(), g, dtype=np.int64))
        pk_all.append(cand[keep])

    if not q_all:
        z = np.empty(0, dtype=np.int64)
        return np.empty(0, np.float64), z, z, z, z
    return (np.concatenate(q_all), np.concatenate(tie_all),
            np.concatenate(ti_all), np.concatenate(g_all),
            np.concatenate(pk_all))


def dedup_region_windows(order: np.ndarray, gs: np.ndarray, pk: np.ndarray,
                         w: int) -> np.ndarray:
    """Overlap dedup of rank-ordered windows (ref myDetect.py:511-516):
    keep a window only if no kept window of the same group lies within w.
    Occupancy bitmaps make each accept O(w) and each reject O(1).  Returns
    the kept subsequence of `order`."""
    span = {}
    for g in set(gs.tolist()):
        gpk = pk[gs == g]
        span[g] = (int(gpk.min()), int(gpk.max()))
    occupied = {g: np.zeros(hi - lo + 2 * w + 2, dtype=bool)
                for g, (lo, hi) in span.items()}
    kept = []
    for oi in order:
        g = int(gs[oi])
        lo, _ = span[g]
        off = int(pk[oi]) - lo + w               # shifted by +w for margins
        occ = occupied[g]
        if occ[off]:
            continue
        occ[max(off - w + 1, 0): off + w] = True
        kept.append(int(oi))
    return np.asarray(kept, dtype=np.int64)


def region_rank(table: SignTable, stat_cfg: StatConfig, rank_cfg: RankConfig):
    """Region-window ranking mode (RegionRankbyST=1, ref myDetect.py:463-516).

    Fixed windows of full width 2*(window+1)+1 slide by window+1 (or 1 when
    overlapping); each window is ranked by the percentile-th smallest p in
    it, tie-broken by the center-distance of the window minimum.  Returns
    indices into the table for the (possibly dedup'd) windows in rank order.

    Fully vectorized: all candidate windows of a (chrom, strand) group are
    scored as one [K, 2w+1] gather + masked sort (the reference walks every
    window position in interpreted Python, prohibitive at 9.2M positions).
    Quirk preserved from the reference (:476): a window touching the
    group's MAXIMUM position is incomplete (``cp >= pmax`` excludes pmax
    itself).  ``region_rank_spec`` is the direct port kept as the test
    oracle.
    """
    q, tie, ti, gs, pk = region_candidates(table, stat_cfg, rank_cfg)
    if not len(q):
        return np.empty(0, dtype=np.int64)
    # stable sort by (q, tie), preserving (group, pk) append order on ties
    # like the reference's list.sort (ref :510)
    order = np.lexsort((tie, q))
    if not rank_cfg.wind_ovlp:
        return ti[order]
    kept = dedup_region_windows(order, gs, pk, rank_cfg.window + 1)
    return ti[kept]


def region_rank_spec(table: SignTable, stat_cfg: StatConfig,
                     rank_cfg: RankConfig):
    """Direct port of the reference's region-rank walk (myDetect.py:463-516)
    — interpreted and slow; kept ONLY as the parity oracle for
    ``region_rank`` (tests/test_rank_modes.py)."""
    w = rank_cfg.window + 1
    windlist = range(-w, w + 1)
    movesize = 1 if rank_cfg.wind_ovlp else w

    st_col, p_col = table.columns(stat_cfg)
    vals = p_col if rank_cfg.rank_use == "pv" else st_col

    windseg = []
    gid = table.group_ids
    pos = table.positions
    for g in range(len(table.keys)):
        sel = np.where(gid == g)[0]
        if len(sel) == 0:
            continue
        pmin, pmax = int(pos[sel].min()), int(pos[sel].max())
        lookup = dict(zip(pos[sel].tolist(), sel.tolist()))
        for pk in range(pmin, pmax, movesize):
            pvlist = []
            complete = True
            for wind in windlist:
                cp = pk + wind
                if cp < 0 or cp >= pmax or cp not in lookup:
                    complete = False
                    break
                ti = lookup[cp]
                if rank_cfg.na and str(table.base[ti]) != rank_cfg.na:
                    continue
                pvlist.append(float(vals[ti]))
            if not complete or len(pvlist) <= 5 or pk not in lookup:
                continue
            opv = list(pvlist)
            spv = sorted(pvlist)
            q = spv[int(rank_cfg.percentile * (len(spv) - 1) + 0.5)]
            tie = abs(w - opv.index(spv[0]))
            windseg.append((q, tie, lookup[pk], g, pk))

    windseg.sort(key=lambda x: (x[0], x[1]))
    ordered = []
    if rank_cfg.wind_ovlp:
        kept = []
        for q, tie, ti, g, pk in windseg:
            if any(kg == g and abs(kpk - pk) < w for kg, kpk in kept):
                continue
            kept.append((g, pk))
            ordered.append(ti)
    else:
        ordered = [ti for _, _, ti, _, _ in windseg]
    return np.asarray(ordered, dtype=np.int64)
