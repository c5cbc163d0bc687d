"""The comparison of a detect table with the reference's: each number is
the widest gap over the table, so that one wrong position shows.

* ``rows_differ``: rows of either table that the other lacks, or whose
  coverage differs (exact: limit 0);
* ``stat_gap``: the largest gap of U, t, D and the combined statistic,
  over max(|reference|, 1);
* ``p_gap``: the largest gap of the four p-values, over the reference's
  p-value;
* ``order_gap``: the largest gap, at any rank, between the reference's
  combined p of the site that the table ranks there and the reference's
  own p at that rank, over the latter.  Sites whose keys tie may come in
  any order; a wrong order shows as a gap.
"""

from __future__ import annotations

import numpy as np

STATS = ("stu", "stt", "stks", "stcomb")
PVALUES = ("pu", "pt", "pks", "pcomb")
# a gap that cannot be read (rows that do not align, a value not finite
# where the reference's is) counts as this
NO_READING = 1.0


def _row_keys(t: dict) -> np.ndarray:
    names = {k: i for i, k in enumerate(sorted(set(t["keys"])))}
    gid = np.array([names[k] for k in t["keys"]], np.int64)
    return gid[t["group_ids"]] * (1 << 40) + t["positions"]


def _gap(a, b, floor) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not len(a):
        return 0.0
    with np.errstate(invalid="ignore", over="ignore"):
        g = np.abs(a - b) / np.maximum(np.abs(b), floor)
    g = np.where(a == b, 0.0, g)
    return float(np.where(np.isfinite(g), g, NO_READING).max())


def compare(got: dict, ref: dict) -> dict:
    """{rows_differ, stat_gap, p_gap, order_gap} of ``got`` against
    ``ref`` (dicts of keys, group_ids, positions, cov1, cov2, the result
    columns and order, as reference.detect returns)."""
    if set(got["keys"]) != set(ref["keys"]):
        return {"rows_differ": abs(len(got["positions"])
                                   - len(ref["positions"])) or 1,
                "stat_gap": NO_READING, "p_gap": NO_READING,
                "order_gap": NO_READING}
    kg, kr = _row_keys(got), _row_keys(ref)
    common, ig, ir = np.intersect1d(kg, kr, assume_unique=True,
                                    return_indices=True)
    differ = (len(kg) - len(common)) + (len(kr) - len(common))
    differ += int(np.count_nonzero((got["cov1"][ig] != ref["cov1"][ir])
                                   | (got["cov2"][ig] != ref["cov2"][ir])))
    out = {"rows_differ": int(differ)}
    out["stat_gap"] = max(_gap(got[c][ig], ref[c][ir], 1.0) for c in STATS)
    out["p_gap"] = max(_gap(got[c][ig], ref[c][ir], 0.0) for c in PVALUES)
    if differ:
        out["order_gap"] = NO_READING
    else:
        # got's rows in ref's indexing
        to_ref = np.empty(len(kg), np.int64)
        to_ref[ig] = ir
        pc = ref["pcomb"]
        out["order_gap"] = _gap(pc[to_ref[got["order"]]], pc[ref["order"]],
                                0.0)
    return out

