# Copied from nanomod_tpu/resquiggle/annotate.py; only the imports differ.
"""Indel-corrected per-base signal annotation.

Behavior-faithful reimplementation of the reference's correction core
(ref bin/scripts/myRefBaseSignalAnnotation.py):

  * ``mark_repeat_indels``  — fix_repeat_del (:1131-1221): index indel
    columns and mark indels inside 5-mer-periodic repeats as '~' (signal
    shared with the predecessor base)
  * ``group_indels``        — group_indel (:1225-1391): merge nearby indels
    and grow each group's event window (merging backward into earlier
    groups) until the raw-signal span exceeds
    (expectna + max(1, round(expectna*0.3))) * MinNumSignal
  * ``find_split_points``   — find_sp (:1000-1094): greedy boundary-score
    resegmentation with minimum-separation constraint, retried with
    shrinking windows
  * ``annotate_read``       — annotate1 (:756-995): event-to-base
    assignment outside groups (recomputed mean/std per raw slice) and
    resegmented assignment inside groups

Inputs use genome-forward orientation throughout: ``columns`` are aligned
(refbase, readbase) pairs at ascending genome coordinates, and events are
pre-reordered to genome order (the reference instead keeps read order and
negative-indexes for '-' strands, :1098-1105 — same arithmetic).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

ACGT = set("ACGTacgtNn")   # ref myCom.py:23 (N counts as a nucleotide)
GAP_SYMBOLS = ("-", "+", "*")


@dataclass
class Columns:
    """Aligned columns in genome-forward order (the reference's
    base_map_info, ref :628)."""

    refbase: np.ndarray   # '<U1'
    readbase: np.ndarray  # '<U1'

    def __len__(self):
        return len(self.refbase)


def mark_repeat_indels(cols: Columns) -> Dict[int, Tuple[int, int]]:
    """fix_repeat_del (ref :1160-1221).

    Returns indel_pos {column -> (event_ind, kind)} where event_ind is the
    number of read bases consumed up to and including this column minus one,
    kind = +1 insertion / -1 deletion / 0 repeat-deletion; also rewrites
    readbase in place: indels whose ±2 reference context is 5-mer-periodic
    become '~' (plus their left neighbor if it is also an indel).
    """
    indel_pos: Dict[int, Tuple[int, int]] = {}
    event_ind = -1
    last_is_repeat = False
    last_non_indel = 0
    rb = cols.readbase
    fb = cols.refbase
    n = len(cols)
    for bmi in range(n):
        if rb[bmi] in ACGT:
            event_ind += 1
            if fb[bmi] == "-":
                indel_pos[bmi] = (event_ind, 1)        # insertion
        if rb[bmi] != "-":
            last_non_indel = bmi
            last_is_repeat = False
            if rb[bmi] == "*":
                indel_pos[bmi] = (event_ind, 0)
        else:
            if fb[bmi] == fb[last_non_indel] and fb[bmi] in ACGT:
                if last_non_indel == bmi - 1 and rb[last_non_indel] == fb[last_non_indel]:
                    last_is_repeat = True
            else:
                last_is_repeat = False
            if fb[bmi] in ACGT:
                indel_pos[bmi] = (event_ind, 0 if last_is_repeat else -1)
    # '~' marking for 5-mer-periodic repeat contexts (ref :1207-1212)
    for bmi in range(3, n - 2):
        if rb[bmi] in GAP_SYMBOLS:
            if "".join(fb[bmi - 2: bmi + 3]) == "".join(fb[bmi - 3: bmi + 2]):
                rb[bmi] = "~"
                if rb[bmi - 1] in GAP_SYMBOLS:
                    rb[bmi - 1] = "~"
    return indel_pos


def _expectna(cols: Columns, lo: int, hi: int) -> int:
    """Expected event count for columns [lo, hi] (ref :1259-1267, :826-840):
    ref-base columns, counting a run of '~' once."""
    cnt = 0
    rb = cols.readbase
    fb = cols.refbase
    for bmi in range(lo, hi + 1):
        if bmi < 0:
            continue
        if bmi >= len(cols):
            break
        if fb[bmi] == "-":
            continue
        if rb[bmi] == "~" and bmi > 0 and rb[bmi - 1] == "~":
            continue
        cnt += 1
    return cnt


class GenomeEvents:
    """Events in genome-forward order with raw-signal span helpers.

    For '-' strands the genome-forward event g maps to the read-order event
    (L-1-g); its raw span is unchanged, so the raw span of genome events
    [g1, g2] is [start[g2], start[g1]+len[g1]) (the reference's negative
    indexing, ref :1250-1255).
    """

    def __init__(self, start: np.ndarray, length: np.ndarray, strand: str):
        self.start = start.astype(np.int64)
        self.length = length.astype(np.int64)
        self.strand = strand

    def __len__(self):
        return len(self.start)

    def raw_span(self, g1: int, g2: int) -> Tuple[int, int]:
        if self.strand == "+":
            return int(self.start[g1]), int(self.start[g2] + self.length[g2])
        return int(self.start[g2]), int(self.start[g1] + self.length[g1])

    def event_span(self, g: int) -> Tuple[int, int]:
        return int(self.start[g]), int(self.start[g] + self.length[g])


def group_indels(indel_pos: Dict[int, Tuple[int, int]], events: GenomeEvents,
                 cols: Columns, min_num_signal: int,
                 more_signal_perc: float = 0.3):
    """group_indel (ref :1225-1306).

    Returns {first_col: (start_ev, end_ev, last_col, (leftnum, rightnum))}.
    """
    keys = sorted(indel_pos)
    # stage 1: merge indel columns <= 2 apart (ref :1228-1233)
    intervals: Dict[int, Tuple[int, int]] = {}
    pre = None
    for ipk in keys:
        if pre is None or not (ipk - intervals[pre][1] <= 2):
            intervals[ipk] = (ipk, ipk)
            pre = ipk
        else:
            intervals[pre] = (intervals[pre][0], ipk)

    group: Dict[int, Tuple[int, int, int, Tuple[int, int]]] = {}
    pre_ipk: Optional[int] = None
    lastipk: List[Optional[int]] = []
    n_ev = len(events)
    n_cols = len(cols)
    for ipk in sorted(intervals):
        i1pk, i2pk = intervals[ipk]
        leftnum = rightnum = 0
        if cols.refbase[i1pk] == "-":
            if indel_pos[i1pk][0] - 1 >= 0:
                start_ev, leftnum = indel_pos[i1pk][0] - 1, 1
            else:
                start_ev = 0
        else:
            start_ev, leftnum = indel_pos[i1pk][0], 1
            if start_ev < 0:
                start_ev, leftnum = 0, 0
        if indel_pos[i2pk][0] + 1 < n_ev:
            end_ev, rightnum = indel_pos[i2pk][0] + 1, 1
        else:
            end_ev = n_ev - 1

        # window growth (ref :1249-1294)
        while True:
            lo, hi = events.raw_span(max(start_ev, 0), end_ev)
            numsignals = hi - lo
            if numsignals >= 1:
                expectna = _expectna(cols, i1pk - leftnum, i2pk + rightnum)
                extra = 1 if expectna * more_signal_perc < 1 else int(
                    expectna * more_signal_perc + 0.5)
                if numsignals > (expectna + extra) * min_num_signal:
                    break
            at_left_stop = (start_ev == 0
                            or (pre_ipk is not None and start_ev <= group[pre_ipk][1]))
            if at_left_stop and end_ev == n_ev - 1:
                break
            if (pre_ipk is None and start_ev > 0) or (
                pre_ipk is not None and start_ev > group[pre_ipk][1]
            ):
                start_ev -= 1
                leftnum += 1
            elif pre_ipk is not None:
                # merge backward into the previous group (ref :1277-1284)
                start_ev = group[pre_ipk][0]
                i1pk = pre_ipk
                leftnum = group[pre_ipk][3][0]
                del group[pre_ipk]
                pre_ipk = lastipk.pop()
            if end_ev < n_ev - 1:
                rightnum += 1
                while True:
                    col = i2pk + rightnum
                    if col >= n_cols:
                        # reference would raise IndexError here; stop growing
                        rightnum -= 1
                        end_ev = n_ev - 1
                        break
                    rb_ok = cols.readbase[col] in ACGT
                    fb_ok = cols.refbase[col] in ACGT
                    if rb_ok and fb_ok:
                        end_ev += 1
                        break
                    if rb_ok and not fb_ok:
                        end_ev += 1
                        rightnum += 1
                    elif not rb_ok and fb_ok:
                        rightnum += 1
                    else:
                        break

        if pre_ipk is None or start_ev > group[pre_ipk][1]:
            group[i1pk] = (start_ev, end_ev, i2pk, (leftnum, rightnum))
            lastipk.append(pre_ipk)
            pre_ipk = i1pk
        elif start_ev <= group[pre_ipk][1]:
            if end_ev >= group[pre_ipk][1]:
                group[pre_ipk] = (group[pre_ipk][0], end_ev, i2pk,
                                  (group[pre_ipk][3][0], rightnum))
    return group


def find_split_points(pvsignals: np.ndarray, expectna: int,
                      signal_wind: int, min_num_signal: int):
    """find_sp (ref :1000-1094): boundary score at i =
    |mean(sig[i-w:i]) - mean(sig[i:i+w])| rounded to 9 decimals; greedy pick
    of expectna-1 splits with minimum separation min_num_signal; None if not
    enough splits can be placed."""
    n = len(pvsignals)
    lo = signal_wind
    hi = n - signal_wind + 1
    split_pos: List[Tuple[int, float]] = []
    if hi > lo:
        cs = np.concatenate([[0.0], np.cumsum(pvsignals, dtype=np.float64)])
        i = np.arange(lo, hi)
        left = (cs[i] - cs[i - signal_wind]) / signal_wind
        right = (cs[i + signal_wind] - cs[i]) / signal_wind
        scores = np.round(np.abs(left - right), 9)
        # stable sort by descending score (ties keep ascending i, matching
        # python sorted(key=-score) stability, ref :1059)
        order = np.argsort(-scores, kind="stable")
        for oi in order:
            cand = int(i[oi])
            if any(-min_num_signal < cand - sp < min_num_signal
                   for sp, _ in split_pos):
                continue
            split_pos.append((cand, float(scores[oi])))
            if len(split_pos) == expectna - 1:
                break
    # success iff exactly expectna-1 splits were placed (ref :1094 — note
    # expectna <= 1 therefore only succeeds when no candidates exist at all)
    if len(split_pos) != expectna - 1:
        return None
    split_pos.sort(key=lambda t: t[0])
    return split_pos


def _seg_mean_std(raw: np.ndarray, lo: int, hi: int) -> Tuple[float, float]:
    seg = raw[lo:hi]
    if len(seg) == 0:
        return 0.0, 0.0
    # np.round (round-half-even on the scaled double) — the native core
    # reproduces this bit-for-bit via numpy's pairwise summation
    return float(np.round(np.mean(seg), 3)), float(np.round(np.std(seg), 3))


def annotate_read(cols: Columns, events: GenomeEvents, raw: np.ndarray,
                  group: Dict[int, Tuple[int, int, int, Tuple[int, int]]],
                  resegment_signal_wind: int, min_num_signal: int):
    """annotate1 (ref :756-995).

    Returns (annotate_info {col -> (event_ind, mean, std, start, length)},
    signalnum {wind -> count}) where start/length are raw-signal
    coordinates.  Columns with refbase '-' get no entry.
    """
    ann: Dict[int, Tuple] = {}
    signalnum: Dict[int, int] = {}
    rb = cols.readbase
    fb = cols.refbase
    n_cols = len(cols)
    strand = events.strand

    gkeys = sorted(group)
    bmi = 0
    event_ind = -1

    def put_plain(col, ev):
        lo, hi = events.event_span(ev)
        mean, std = _seg_mean_std(raw, lo, hi)
        ann[col] = (ev, mean, std, lo, hi - lo)

    # pass 1: outside groups, 1:1 event <-> column (ref :775-810)
    for gipk in gkeys:
        g_start, g_end, g_last, (leftnum, rightnum) = group[gipk]
        lo_col = gipk - leftnum if gipk - leftnum > -1 else 0
        while bmi < lo_col:
            event_ind += 1
            put_plain(bmi, event_ind)
            bmi += 1
        while bmi < g_last + rightnum + 1 and bmi < n_cols:
            if rb[bmi] in ACGT:
                event_ind += 1
            if fb[bmi] in ACGT:
                ann[bmi] = (event_ind, False)
            bmi += 1
    while bmi < n_cols:
        event_ind += 1
        put_plain(bmi, event_ind)
        bmi += 1

    # pass 2: resegment within each group (ref :815-978)
    for gipk in gkeys:
        g_start, g_end, g_last, (leftnum, rightnum) = group[gipk]
        mstart1, mend2 = events.raw_span(g_start, g_end)
        pvsignals = raw[mstart1:mend2]
        expectna = _expectna(cols, gipk - leftnum, g_last + rightnum)

        split_pos = None
        currsw = resegment_signal_wind
        for currsw in range(resegment_signal_wind, 1, -1):
            split_pos = find_split_points(pvsignals, expectna, currsw,
                                          min_num_signal)
            if split_pos is not None:
                break
        if split_pos is not None:
            signalnum[currsw] = signalnum.get(currsw, 0) + 1
            all_mean = all_std = None
        else:
            signalnum[1] = signalnum.get(1, 0) + 1
            all_mean = (float(np.round(np.mean(pvsignals), 3))
                        if len(pvsignals) else 0.0)
            all_std = (float(np.round(np.std(pvsignals), 3))
                       if len(pvsignals) else 0.0)

        bmi2 = gipk - leftnum
        if bmi2 < 0:
            bmi2 = 0
        if strand == "-" and split_pos is not None:
            spind = len(split_pos) - 1
        else:
            spind = -1

        def segment(spind_now):
            """Raw segment for the current split index (ref :891-895)."""
            if split_pos is None:
                return all_mean, all_std, mstart1, mend2 - mstart1
            start_in_pv = 0 if spind_now == -1 else split_pos[spind_now][0]
            if spind_now == len(split_pos) - 1:
                end_in_pv = len(pvsignals)
            else:
                end_in_pv = split_pos[spind_now + 1][0]
            mean, std = _seg_mean_std(pvsignals, start_in_pv, end_in_pv)
            return mean, std, mstart1 + start_in_pv, end_in_pv - start_in_pv

        while bmi2 < g_last + rightnum + 1:
            if bmi2 >= n_cols:
                break
            if fb[bmi2] == "-":
                bmi2 += 1
                continue
            if rb[bmi2] == "~":
                if bmi2 > 0 and rb[bmi2 - 1] == "~":
                    ann[bmi2] = ann[bmi2 - 1]
                else:
                    mean, std, s, ln = segment(spind)
                    ann[bmi2] = (ann[bmi2][0], mean, std, s, ln)
                # advance split only when the '~' run ends (ref :902-904)
                if bmi2 < n_cols - 1 and rb[bmi2 + 1] != "~":
                    spind = spind + 1 if strand == "+" else spind - 1
                bmi2 += 1
            elif rb[bmi2] in ACGT or rb[bmi2] == "-":
                mean, std, s, ln = segment(spind)
                ann[bmi2] = (ann[bmi2][0], mean, std, s, ln)
                bmi2 += 1
                while bmi2 < n_cols and rb[bmi2] == "+":
                    mean, std, s, ln = segment(spind)
                    ann[bmi2] = (ann[bmi2][0], mean, std, s, ln)
                    bmi2 += 1
                spind = spind + 1 if strand == "+" else spind - 1
            elif rb[bmi2] == "*":
                mean, std, s, ln = segment(spind)
                ann[bmi2] = (ann[bmi2][0], mean, std, s, ln)
                bmi2 += 1
                while bmi2 < n_cols and rb[bmi2] == "*":
                    mean, std, s, ln = segment(spind)
                    ann[bmi2] = (ann[bmi2][0], mean, std, s, ln)
                    bmi2 += 1
                if bmi2 < n_cols and rb[bmi2] in ACGT:
                    mean, std, s, ln = segment(spind)
                    ann[bmi2] = (ann[bmi2][0], mean, std, s, ln)
                    bmi2 += 1
                spind = spind + 1 if strand == "+" else spind - 1
            else:
                break

    return ann, signalnum
