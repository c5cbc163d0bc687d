"""The plain reference of detect: NanoMod's myDetect.py under scipy 1.2.1,
written out in NumPy and SciPy, vectorized over positions.

From reads (chrom, strand, start, per-base means in genome order) it
builds each group's pools, keeps the positions that both groups cover at
least ``min_coverage`` times, and tests each position: Mann-Whitney U
(scipy 1.2.1's default: U = min(u1, u2), z from max(u1, u2) with the
continuity and tie corrections, p = norm.sf(|z|); a pool whose values are
all equal gets p = 1), Welch's t (two-sided, ddof 1) and the two-sample
Kolmogorov-Smirnov test (p = kstwobign.sf((en + 0.12 + 0.11 / en) D)).
Each position's KS p-value is combined with its +-k neighbours' by a
weighted Stouffer (weights 100 / weights_dif^|j|; a neighbour that is not
the next genome position of the same chrom and strand counts as p = 1),
p-values are clamped below at the smallest normal double and statistics
above at the largest, and the sites are ordered by (combined p, KS p,
U p).  ``rank_of_target`` is the simulation harness's getTopRank.

Nothing here comes from the program: it reads only what the benchmark
generated.  ``precision="bfloat16"`` rounds every value to bfloat16 before
the tests, the control that the comparison has to fail.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, List, Tuple

import numpy as np
from scipy.stats import distributions as dist

FLOAT_MIN = sys.float_info.min
FLOAT_MAX = sys.float_info.max
ROWS_A_BLOCK = 1 << 16


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 (nearest, ties to even), as float64."""
    f = np.asarray(x, np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def pools(reads: Iterable[Tuple[str, str, int, np.ndarray]]):
    """{(chrom, strand): (positions [P], values [P, C] NaN-padded,
    counts [P])} over the positions that some read covers."""
    spans: Dict[Tuple[str, str], List] = {}
    for chrom, strand, start, means in reads:
        spans.setdefault((chrom, strand), []).append(
            (int(start), np.asarray(means, np.float64)))
    out = {}
    for key, rs in spans.items():
        lo = min(s for s, _ in rs)
        hi = max(s + len(m) for s, m in rs)
        depth = np.zeros(hi - lo + 1, np.int64)
        for s, m in rs:
            depth[s - lo] += 1
            depth[s - lo + len(m)] -= 1
        depth = np.cumsum(depth)[:-1]
        vals = np.full((hi - lo, max(int(depth.max()), 1)), np.nan)
        fill = np.zeros(hi - lo, np.int64)
        for s, m in rs:
            rows = np.arange(s - lo, s - lo + len(m))
            vals[rows, fill[rows]] = m
            fill[rows] += 1
        keep = fill > 0
        out[key] = (np.flatnonzero(keep) + lo, vals[keep], fill[keep])
    return out


def _tests(v1, n1, v2, n2):
    """The three tests on one block of rows: values NaN-padded [R, C1] and
    [R, C2], counts [R].  Returns stu, pu, stt, pt, stks, pks."""
    rows, c1w = v1.shape
    z = np.concatenate([v1, v2], axis=1)
    lab = np.concatenate([np.full(c1w, 1), np.full(v2.shape[1], 2)])
    lab = np.broadcast_to(lab, z.shape)
    valid = ~np.isnan(z)
    key = np.where(valid, z, np.inf)
    idx = np.argsort(key, axis=1, kind="stable")
    zs = np.take_along_axis(key, idx, 1)
    ls = np.where(np.take_along_axis(valid, idx, 1),
                  np.take_along_axis(lab, idx, 1), 0)
    width = zs.shape[1]
    col = np.broadcast_to(np.arange(width), zs.shape)
    start = np.ones(zs.shape, bool)
    start[:, 1:] = zs[:, 1:] != zs[:, :-1]
    end = np.ones(zs.shape, bool)
    end[:, :-1] = zs[:, 1:] != zs[:, :-1]
    first = np.maximum.accumulate(np.where(start, col, 0), axis=1)
    last = (width - 1) - np.maximum.accumulate(
        np.where(end, width - 1 - col, 0)[:, ::-1], axis=1)[:, ::-1]
    f1 = n1.astype(np.float64)
    f2 = n2.astype(np.float64)
    nt = f1 + f2
    in1, in2 = ls == 1, ls == 2
    # Mann-Whitney U: average ranks over ties
    r1 = np.where(in1, (first + last) / 2.0 + 1.0, 0.0).sum(1)
    t = (last - first + 1).astype(np.float64)
    tie = np.where(ls > 0, t * t - 1.0, 0.0).sum(1)   # sum of t^3 - t
    u1 = f1 * f2 + f1 * (f1 + 1.0) / 2.0 - r1
    u2 = f1 * f2 - u1
    with np.errstate(divide="ignore", invalid="ignore"):
        sd = np.sqrt((1.0 - tie / (nt ** 3 - nt)) * f1 * f2 * (nt + 1.0)
                     / 12.0)
        zu = (np.maximum(u1, u2) - (f1 * f2 / 2.0 + 0.5)) / sd
        pu = np.where(sd > 0, dist.norm.sf(np.abs(zu)), 1.0)
    # Kolmogorov-Smirnov: the largest gap of the two empirical CDFs,
    # read at the last of each run of equal values
    k1 = np.cumsum(in1, axis=1)
    k2 = np.cumsum(in2, axis=1)
    gap = np.where(end & (ls > 0), np.abs(k1 * n2[:, None] - k2 * n1[:, None]),
                   0)
    d = gap.max(1) / (f1 * f2)
    with np.errstate(divide="ignore", invalid="ignore"):
        en = np.sqrt(f1 * f2 / nt)
        pks = dist.kstwobign.sf((en + 0.12 + 0.11 / en) * d)
    pks = np.where(np.isfinite(pks), pks, 1.0)
    # Welch's t
    x1 = np.where(np.isnan(v1), 0.0, v1)
    x2 = np.where(np.isnan(v2), 0.0, v2)
    m1 = x1.sum(1) / f1
    m2 = x2.sum(1) / f2
    ss1 = np.where(np.isnan(v1), 0.0, (v1 - m1[:, None]) ** 2).sum(1)
    ss2 = np.where(np.isnan(v2), 0.0, (v2 - m2[:, None]) ** 2).sum(1)
    vn1 = ss1 / np.maximum(f1 - 1.0, 1.0) / f1
    vn2 = ss2 / np.maximum(f2 - 1.0, 1.0) / f2
    with np.errstate(divide="ignore", invalid="ignore"):
        df = (vn1 + vn2) ** 2 / (vn1 ** 2 / (f1 - 1.0) + vn2 ** 2
                                 / (f2 - 1.0))
        tt = (m1 - m2) / np.sqrt(vn1 + vn2)
        pt = 2.0 * dist.t.sf(np.abs(tt), np.where(np.isnan(df), 1.0, df))
    return np.minimum(u1, u2), pu, tt, pt, d, pks


def _clamp_p(p):
    return np.where(p < FLOAT_MIN, FLOAT_MIN, p)


def _clamp_stat(s):
    return np.where(s > FLOAT_MAX, FLOAT_MAX, s)


def stouffer(group_ids, positions, pks, k: int, weights_dif: float):
    """(statistic, p) of the weighted Stouffer over the +-k neighbours."""
    w = [100.0]
    for _ in range(k):
        w = [w[0] / weights_dif] + w + [w[-1] / weights_dif]
    w = np.asarray(w)
    zk = dist.norm.isf(pks)
    n = len(pks)
    total = np.zeros(n)
    for j, off in enumerate(range(-k, k + 1)):
        if off == 0:
            total += w[j] * zk
            continue
        other = np.arange(n) + off
        ok = (other >= 0) & (other < n)
        oc = np.clip(other, 0, n - 1)
        ok &= (group_ids[oc] == group_ids) & (positions[oc] - positions == off)
        total += np.where(ok, w[j] * zk[oc], -np.inf)
    stat = total / np.sqrt((w * w).sum())
    stat = np.where(np.isnan(stat), -np.inf, stat)
    return _clamp_stat(stat), _clamp_p(dist.norm.sf(stat))


def detect(reads1, reads2, min_coverage=5, k=2, weights_dif=2.0,
           precision="float64") -> dict:
    """The whole table of two groups' reads: keys [(chrom, strand)],
    group_ids, positions, cov1, cov2, stu, pu, stt, pt, stks, pks, stcomb,
    pcomb, order."""
    p1, p2 = pools(reads1), pools(reads2)
    cols = {c: [] for c in ("group_ids", "positions", "cov1", "cov2", "stu",
                            "pu", "stt", "pt", "stks", "pks")}
    keys = []
    for key in sorted(set(p1) & set(p2)):
        pos1, val1, cnt1 = p1[key]
        pos2, val2, cnt2 = p2[key]
        ok1 = cnt1 >= min_coverage
        ok2 = cnt2 >= min_coverage
        common, i1, i2 = np.intersect1d(pos1[ok1], pos2[ok2],
                                        assume_unique=True,
                                        return_indices=True)
        if not len(common):
            continue
        v1 = val1[ok1][i1]
        v2 = val2[ok2][i2]
        n1 = cnt1[ok1][i1]
        n2 = cnt2[ok2][i2]
        if precision == "bfloat16":
            v1, v2 = to_bfloat16(v1), to_bfloat16(v2)
        gi = len(keys)
        keys.append(key)
        for lo in range(0, len(common), ROWS_A_BLOCK):
            sl = slice(lo, lo + ROWS_A_BLOCK)
            a, b = int(n1[sl].max()), int(n2[sl].max())
            res = _tests(v1[sl, :a], n1[sl], v2[sl, :b], n2[sl])
            for c, r in zip(("stu", "pu", "stt", "pt", "stks", "pks"), res):
                cols[c].append(r)
        cols["group_ids"].append(np.full(len(common), gi, np.int64))
        cols["positions"].append(common.astype(np.int64))
        cols["cov1"].append(n1)
        cols["cov2"].append(n2)
    out = {c: (np.concatenate(v) if v else np.empty(0))
           for c, v in cols.items()}
    for c in ("stu", "stt", "stks"):
        out[c] = _clamp_stat(out[c])
    for c in ("pu", "pt", "pks"):
        out[c] = _clamp_p(out[c])
    out["keys"] = keys
    out["stcomb"], out["pcomb"] = stouffer(out["group_ids"], out["positions"],
                                           out["pks"], k, weights_dif)
    out["order"] = np.lexsort((out["pu"], out["pks"], out["pcomb"]))
    return out


def rank_of_target(ref: dict, target: Tuple[str, str, int], close: int,
                   window: int) -> int:
    """getTopRank (NanoMod's mySimulate.py:287-328): walk the sites in
    order, skipping a site within ``close`` of one already emitted on its
    chrom and strand, and one whose +-window neighbours are not all the
    contiguous positions of its chrom and strand; the rank of the first
    emitted site within ``close`` of the target, or -1."""
    gid, pos = ref["group_ids"], ref["positions"]
    n = len(pos)
    emitted = set()
    rank = 0
    for i in ref["order"]:
        chrom, strand = ref["keys"][gid[i]]
        p = int(pos[i])
        if any((chrom, strand, q) in emitted
               for q in range(p - close + 1, p + close)):
            continue
        lo, hi = i - window, i + window
        if lo < 0 or hi >= n or gid[lo] != gid[i] or gid[hi] != gid[i] \
                or pos[hi] - pos[lo] != 2 * window:
            continue
        rank += 1
        emitted.add((chrom, strand, p))
        if (chrom, strand) == target[:2] and abs(p - target[2]) < close:
            return rank
    return -1
