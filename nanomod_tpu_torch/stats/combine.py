# Copied from nanomod_tpu/stats/combine.py; only the imports differ.
"""Neighbor-aware p-value combination as a 1-D stencil.

The reference walks the sorted sign_test list and, for each position, gathers
the KS p-values of the ±k index-neighbors, substituting 1.0 whenever the
neighbor is out of range or not genomically contiguous (``pos_check``:
same chrom+strand and index-distance == coordinate-distance), then applies
scipy combine_pvalues with Fisher or geometric-weighted Stouffer
(ref bin/scripts/myDetect.py:366-414).

Here the joined positions arrive as parallel arrays already sorted by
(chrom, strand, pos) — the same iteration order the reference produces from
its sorted dict keys — and the stencil is fully vectorized.
"""

from __future__ import annotations

import numpy as np

from nanomod_tpu_torch.config import StatConfig
from nanomod_tpu_torch.stats import special


def neighbor_matrix(group_ids: np.ndarray, positions: np.ndarray,
                    pks: np.ndarray, k: int) -> np.ndarray:
    """[P, 2k+1] matrix of neighbor KS p-values with 1.0 for invalid slots.

    group_ids: int array identifying (chrom, strand) runs; positions: int64
    genomic coordinates; both sorted so that contiguous genome positions are
    adjacent rows.  Neighbor at offset j is valid iff same group and
    position difference == j (pos_check, ref myDetect.py:366-371).
    """
    p_total = len(pks)
    out = np.ones((p_total, 2 * k + 1), dtype=np.float64)
    for col, off in enumerate(range(-k, k + 1)):
        if off == 0:
            out[:, col] = pks
            continue
        src_lo = max(0, off)
        src_hi = p_total + min(0, off)
        if src_hi <= src_lo:
            continue
        dst = slice(src_lo - off, src_hi - off)
        src = slice(src_lo, src_hi)
        valid = (group_ids[src] == group_ids[dst]) & (
            positions[src] - positions[dst] == off
        )
        out[dst, col] = np.where(valid, pks[src], 1.0)
    return out


def _stencil_sum(vals, group_ids, positions, k, weights, fill):
    """Σ_j w_j · shifted(vals, j) over the ±k stencil, with `fill`
    substituted where the neighbor at offset j is invalid (pos_check,
    ref myDetect.py:366-371).

    Accumulates offsets in ascending column order — the same order
    np.sum takes over the neighbor-matrix axis (numpy reduces a 2k+1-wide
    contiguous axis sequentially below its pairwise threshold), so the
    result is BITWISE identical to combining neighbor_matrix, at 1/(2k+1)
    of the special-function work: the expensive transform (norm.isf /
    log) runs once per position, not once per matrix cell.
    """
    p_total = len(vals)
    out = None
    for col, off in enumerate(range(-k, k + 1)):
        w = 1.0 if weights is None else float(weights[col])
        if off == 0:
            contrib = w * vals
        else:
            contrib = np.full(p_total, w * fill)
            src_lo = max(0, off)
            src_hi = p_total + min(0, off)
            if src_hi > src_lo:
                dst = slice(src_lo - off, src_hi - off)
                src = slice(src_lo, src_hi)
                valid = (group_ids[src] == group_ids[dst]) & (
                    positions[src] - positions[dst] == off
                )
                contrib[dst] = np.where(valid, w * vals[src], w * fill)
        out = contrib if out is None else out + contrib
    return out


def combine_neighbor_pvalues(group_ids, positions, pks, cfg: StatConfig):
    """Combined (statistic, p-value) per position, or None when the
    configuration produces no combination column.

    Mirrors combin_pvalues/get_combin_pvalue semantics
    (ref myDetect.py:373-414): with neighborPvalues == 0 the KS column is
    reused verbatim; with testMethod == 'ks' the caller should not call
    this.  Bitwise identical to combining the explicit neighbor_matrix
    (pinned by tests/test_stats.py and the golden byte-parity suite).
    """
    if cfg.test_method == "ks":
        return None
    if cfg.neighbor_pvalues == 0:
        # ref myDetect.py:413: the ks tuple itself is appended
        return None  # caller duplicates the KS column
    k = cfg.neighbor_pvalues
    gid = np.asarray(group_ids)
    pos = np.asarray(positions)
    pks = np.asarray(pks, dtype=np.float64)
    if cfg.test_method == "fisher":
        # stat = -2 Σ ln p; an invalid neighbor contributes ln(1) = 0
        with np.errstate(divide="ignore"):
            logp = np.log(pks)
        stat = -2.0 * _stencil_sum(logp, gid, pos, k, None, 0.0)
        p = special.chi2_sf(stat, 2 * (2 * k + 1))
    else:
        # z = norm.isf(p); an invalid neighbor contributes
        # isf(1) = -inf -> combined p = 1.0, exactly the reference's
        # missing-neighbor semantics (myDetect.py:383-389)
        w = special.stouffer_weights(k, cfg.weights_dif)
        z = special.norm_isf(pks)
        stat = _stencil_sum(z, gid, pos, k, w, -np.inf) / np.linalg.norm(w)
        stat = np.where(np.isnan(stat), -np.inf, stat)
        p = special.norm_sf(stat)
    return special.clamp_stat(stat), special.clamp_p(p)
