# Copied from nanomod_tpu/signal/events.py; only the imports differ.
"""Per-base event extraction from basecaller output tables.

Vectorized (numpy) reimplementation of the reference's per-row Python loops
(ref bin/scripts/myRefBaseSignalAnnotation.py:115-310 ``getEvent`` /
``getMove_Info``): collapse basecall event rows into one record per called
base, with raw-signal (start, length) spans.

Three dialects, as in the reference:
  * albacore 1.x — time-based starts/lengths, converted to sample indices
    via the channel sampling rate; leading/trailing move-0 rows trimmed
    (ref :141-224)
  * albacore 2.x — sample-based starts/lengths (ref :226-240)
  * guppy       — move table at stride 2 over the raw signal, per-base
    mean/std computed directly from the signal (ref :261-310)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EventTable:
    """Per-called-base events: arrays of equal length L."""

    mean: np.ndarray       # f4 basecaller event mean (pA space)
    stdv: np.ndarray       # f4
    start: np.ndarray      # u8 raw-signal sample offset
    length: np.ndarray     # u8 samples
    base: np.ndarray       # '<U1' called base (center of model_state)
    seq: str               # basecall sequence (''.join(base))


class EventError(Exception):
    """Matches the reference's raiseError taxonomy keys (ref :45-48)."""

    def __init__(self, key):
        super().__init__(key)
        self.key = key


def _centers(model_state: np.ndarray) -> np.ndarray:
    """Third character of each 5-mer model state (ref :217)."""
    ms = model_state.astype("S5")
    return ms.view("S1").reshape(-1, 5)[:, 2].astype("<U1")


def _group_rows(move: np.ndarray):
    """Boundary rows (move>0, row 0 forced) and group index per row."""
    is_new = move > 0
    is_new = np.asarray(is_new, dtype=bool).copy()
    is_new[0] = True
    starts = np.flatnonzero(is_new)
    return starts


def extract_albacore2(events: np.ndarray) -> EventTable:
    """Sample-indexed event tables (ref :226-240): group rows by move>0,
    keep the first row's mean/stdv/start/model_state, sum lengths."""
    starts = _group_rows(events["move"])
    lengths = np.add.reduceat(events["length"].astype(np.uint64), starts)
    base = _centers(events["model_state"][starts])
    return EventTable(
        mean=np.round(events["mean"][starts].astype(np.float32), 3),
        stdv=np.round(events["stdv"][starts].astype(np.float32), 3),
        start=events["start"][starts].astype(np.uint64),
        length=lengths,
        base=base,
        seq="".join(base),
    )


def extract_albacore1(events: np.ndarray, sampling_rate: float,
                      raw_start_time: int) -> EventTable:
    """Time-indexed event tables (ref :141-224).

    Trims leading/trailing move-0 rows (error if fewer than ~20 usable rows
    remain, ref :148-170), anchors the first base at
    round(start*rate) - raw_start_time, then chains starts by summed
    group lengths.
    """
    move = events["move"]
    nz = np.flatnonzero(move > 0)
    if len(nz) == 0:
        raise EventError("Remove too many bases on left")
    move0_left, move0_right = int(nz[0]), int(nz[-1])
    if move0_left > move0_right - 20:
        raise EventError("Remove too many bases on left")
    if move0_right < move0_left + 20:
        raise EventError("Remove too many bases on right")

    ev = events[move0_left: move0_right + 1]
    first = np.round(
        ev["start"][0].astype(np.float64) * sampling_rate
    ).astype(np.int64) - raw_start_time
    if first < -2:
        raise EventError("The index of the first base is less than -2")
    first = max(int(first), 0)

    samp_len = (ev["length"].astype(np.float64) * sampling_rate).astype(np.uint64)
    starts = _group_rows(ev["move"])
    lengths = np.add.reduceat(samp_len, starts)
    ev_start = np.uint64(first) + np.concatenate(
        [[np.uint64(0)], np.cumsum(lengths[:-1])]
    ).astype(np.uint64)
    base = _centers(ev["model_state"][starts])
    return EventTable(
        mean=np.round(ev["mean"][starts].astype(np.float32), 3),
        stdv=np.round(ev["stdv"][starts].astype(np.float32), 3),
        start=ev_start,
        length=lengths,
        base=base,
        seq="".join(base),
    )


def extract_guppy(move: np.ndarray, fq_seq: str, raw_signal: np.ndarray,
                  first_sample: int, stride: int = 2) -> EventTable:
    """Move-table segmentation (ref getMove_Info :261-310): base i spans
    raw samples [pivot, stride*j + first) where j is the next move==1 row;
    mean/std computed from the (normalized) raw signal."""
    nsig = len(raw_signal)
    # boundaries: reference scans i in [1, len(move)) for move==1
    ones = np.flatnonzero(move[1:] == 1) + 1
    pivots = np.concatenate([[first_sample], stride * ones + first_sample,
                             [nsig]]).astype(np.int64)
    starts = pivots[:-1]
    ends = pivots[1:]
    nseg = len(starts)
    if nseg > len(fq_seq):
        starts = starts[: len(fq_seq)]
        ends = ends[: len(fq_seq)]
        nseg = len(starts)
    # segment mean/std via cumulative sums
    cs = np.concatenate([[0.0], np.cumsum(raw_signal, dtype=np.float64)])
    cs2 = np.concatenate([[0.0], np.cumsum(raw_signal ** 2, dtype=np.float64)])
    n = np.maximum(ends - starts, 1)
    s = cs[ends] - cs[starts]
    s2 = cs2[ends] - cs2[starts]
    mean = s / n
    var = np.maximum(s2 / n - mean ** 2, 0.0)
    base = np.array(list(fq_seq[:nseg]), dtype="<U1")
    return EventTable(
        mean=mean.astype(np.float32),
        stdv=np.sqrt(var).astype(np.float32),
        start=starts.astype(np.uint64),
        length=(ends - starts).astype(np.uint64),
        base=base,
        seq=fq_seq[:nseg],
    )


def extract_events(raw_read) -> EventTable:
    """Dispatch on the basecaller dialect (ref getFast5Info :340-358)."""
    if raw_read.basecaller == "guppy":
        return extract_guppy(raw_read.move, raw_read.fastq_seq,
                             raw_read.raw_signal, raw_read.first_sample_template)
    if raw_read.basecaller == "albacore2":
        return extract_albacore2(raw_read.events)
    return extract_albacore1(
        raw_read.events,
        float(raw_read.channel["sampling_rate"]),
        raw_read.raw_start_time,
    )
