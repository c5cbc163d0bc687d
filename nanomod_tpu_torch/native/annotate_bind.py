# Copied from nanomod_tpu/native/annotate_bind.py; only the imports differ.
"""ctypes binding for the native indel-correction core
(native/annotate_core.cpp).  Drop-in accelerated equivalent of
resquiggle.annotate's mark_repeat_indels + group_indels + annotate_read;
tests/test_native.py asserts bit-identical outputs vs the Python
specification."""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from nanomod_tpu_torch.native.build import load_native

_sig_set = False


def _lib():
    global _sig_set
    lib = load_native("annotate_core")
    if lib is not None and not _sig_set:
        lib.annotate_core.restype = ctypes.c_int
        lib.annotate_core.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ]
        _sig_set = True
    return lib


def native_annotate_bytes(ref_u8: np.ndarray, read_u8: np.ndarray,
                          ev_start: np.ndarray, ev_length: np.ndarray,
                          strand: str, raw: np.ndarray,
                          min_num_signal: int, resegment_signal_wind: int,
                          more_signal_perc: float):
    """Array-in/array-out native correction core (zero string building).

    ref_u8/read_u8 are ASCII uint8 column arrays; read_u8 is MUTATED in
    place ('~' repeat marking, ref myRefBaseSignalAnnotation.py:1207-1212)
    so it must be a writable contiguous array.  Returns
    (mean, std, start, length, valid, hist) arrays of length n_cols
    (hist: 32), or None when the native library is unavailable.
    """
    lib = _lib()
    if lib is None:
        return None
    n_cols = len(ref_u8)
    ref_c = np.ascontiguousarray(ref_u8, dtype=np.uint8)
    assert read_u8.flags["C_CONTIGUOUS"] and read_u8.flags["WRITEABLE"]
    ev_s = np.ascontiguousarray(ev_start, dtype=np.int64)
    ev_l = np.ascontiguousarray(ev_length, dtype=np.int64)
    raw_d = np.ascontiguousarray(raw, dtype=np.float64)

    out_mean = np.zeros(n_cols, np.float64)
    out_std = np.zeros(n_cols, np.float64)
    out_start = np.zeros(n_cols, np.int64)
    out_len = np.zeros(n_cols, np.int64)
    out_valid = np.zeros(n_cols, np.uint8)
    hist = np.zeros(32, np.int64)

    lib.annotate_core(
        ref_c.ctypes.data_as(ctypes.c_char_p),
        read_u8.ctypes.data_as(ctypes.c_char_p), n_cols,
        ev_s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ev_l.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ev_s), 0 if strand == "+" else 1,
        raw_d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(raw_d),
        min_num_signal, resegment_signal_wind, more_signal_perc,
        out_mean.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_std.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out_mean, out_std, out_start, out_len, out_valid, hist


def native_annotate(refbase: np.ndarray, readbase: np.ndarray,
                    ev_start: np.ndarray, ev_length: np.ndarray,
                    strand: str, raw: np.ndarray,
                    min_num_signal: int, resegment_signal_wind: int,
                    more_signal_perc: float
                    ) -> Optional[Tuple[Dict[int, Tuple], Dict[int, int], np.ndarray]]:
    """Dict-API wrapper over native_annotate_bytes.

    Returns (annotate_info {col -> (None, mean, std, start, length)},
    signalnum histogram, mutated readbase array) or None when the native
    library is unavailable.  The event index slot of annotate_info is not
    produced natively (the writer does not use it).
    """
    read_u8 = np.ascontiguousarray(
        readbase.astype("S1").view(np.uint8))
    ref_u8 = refbase.astype("S1").view(np.uint8)
    res = native_annotate_bytes(
        ref_u8, read_u8, ev_start, ev_length, strand, raw,
        min_num_signal, resegment_signal_wind, more_signal_perc)
    if res is None:
        return None
    out_mean, out_std, out_start, out_len, out_valid, hist = res
    ann = {}
    for col in np.flatnonzero(out_valid):
        ann[int(col)] = (None, out_mean[col], out_std[col],
                         int(out_start[col]), int(out_len[col]))
    signalnum = {i: int(hist[i]) for i in range(32) if hist[i]}
    new_readbase = read_u8.view("S1").astype("<U1")
    return ann, signalnum, new_readbase


_batch_sig_set = False


def _batch_lib():
    global _batch_sig_set
    lib = load_native("annotate_core")
    if lib is None or not hasattr(lib, "annotate_codes_batch"):
        return None
    if not _batch_sig_set:
        P = ctypes.POINTER
        lib.annotate_codes_batch.restype = None
        lib.annotate_codes_batch.argtypes = [
            P(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,      # codes
            P(ctypes.c_int32), P(ctypes.c_int32),                   # bi, bk
            P(ctypes.c_uint8), P(ctypes.c_int64),                   # accept, ws
            P(ctypes.c_void_p), P(ctypes.c_int64),                  # gen
            P(ctypes.c_void_p), P(ctypes.c_int64),                  # seq
            P(ctypes.c_void_p), P(ctypes.c_void_p),                 # ev s/l
            P(ctypes.c_void_p), P(ctypes.c_int64),                  # sig
            P(ctypes.c_uint8),                                      # strands
            ctypes.c_int, ctypes.c_int, ctypes.c_double,            # cfg
            P(ctypes.c_uint8), P(ctypes.c_int64),                   # ev out
            P(ctypes.c_uint8), P(ctypes.c_uint8), P(ctypes.c_int64),  # al
            P(ctypes.c_int64), P(ctypes.c_int64), P(ctypes.c_int32),  # meta/hist/status
            ctypes.c_int, ctypes.c_int,
        ]
        _batch_sig_set = True
    return lib


def annotate_codes_batch_native(codes: np.ndarray, best_i: np.ndarray,
                                best_k: np.ndarray, accept: np.ndarray,
                                win_starts: np.ndarray, reads, fasta,
                                min_num_signal: int,
                                resegment_signal_wind: int,
                                more_signal_perc: float,
                                nthreads: int = 2,
                                packed: bool = False):
    """One native call per DP batch: decode device-walk codes, build
    alignment columns, run the correction core, and assemble write-ready
    payload pieces — C++ threads across reads, no per-read Python.

    codes [B, S] uint8 (3'->5' walk codes), accept [B] bool/uint8 (score
    gate), reads: list of PreparedRead, fasta: FastaIndex.  Returns a list
    of (payload dict | None, err str) aligned with ``reads``, or None when
    the native library is unavailable.  err is "" for payloads, "skip" for
    score-rejected reads (caller maps to its own taxonomy).
    """
    lib = _batch_lib()
    if lib is None:
        return None
    from nanomod_tpu_torch.io.fast5 import CORRECTED_EVENTS_DTYPE

    bsz, sb = codes.shape
    s = sb * 4 if packed else sb      # step count (packed: 4 steps/byte)
    n = len(reads)
    assert n <= bsz
    codes_c = np.ascontiguousarray(codes[:n], np.uint8)
    bi = np.ascontiguousarray(best_i[:n], np.int32)
    bk = np.ascontiguousarray(best_k[:n], np.int32)
    acc = np.ascontiguousarray(accept[:n], np.uint8)
    ws = np.ascontiguousarray(win_starts[:n], np.int64)

    # per-read pointer tables (no concatenation copies); keep every
    # backing array alive until after the call
    keep = []
    gen_p = (ctypes.c_void_p * n)()
    gen_l = np.empty(n, np.int64)
    seq_p = (ctypes.c_void_p * n)()
    seq_l = np.empty(n, np.int64)
    evs_p = (ctypes.c_void_p * n)()
    evl_p = (ctypes.c_void_p * n)()
    sig_p = (ctypes.c_void_p * n)()
    sig_l = np.empty(n, np.int64)
    strands = np.empty(n, np.uint8)
    for i, r in enumerate(reads):
        g = fasta.get_bytes(r.chrom)      # memoized contiguous uint8
        sq = np.frombuffer(r.fwd_seq.encode("ascii"), np.uint8)
        es = np.ascontiguousarray(r.events_start, np.int64)
        el = np.ascontiguousarray(r.events_length, np.int64)
        sg = np.ascontiguousarray(r.norm_signal, np.float64)
        keep.extend((g, sq, es, el, sg))
        gen_p[i] = g.ctypes.data
        gen_l[i] = len(g)
        seq_p[i] = sq.ctypes.data
        seq_l[i] = len(sq)
        evs_p[i] = es.ctypes.data
        evl_p[i] = el.ctypes.data
        sig_p[i] = sg.ctypes.data
        sig_l[i] = len(sg)
        strands[i] = 0 if r.strand == "+" else 1

    ev_rows = np.empty((n, s, 25), np.uint8)
    ev_n = np.zeros(n, np.int64)
    read_al = np.empty((n, s), np.uint8)
    genome_al = np.empty((n, s), np.uint8)
    al_n = np.zeros(n, np.int64)
    meta = np.zeros((n, 8), np.int64)
    hist = np.zeros((n, 32), np.int64)
    status = np.zeros(n, np.int32)

    P = ctypes.POINTER
    lib.annotate_codes_batch(
        codes_c.ctypes.data_as(P(ctypes.c_uint8)), n, s,
        bi.ctypes.data_as(P(ctypes.c_int32)),
        bk.ctypes.data_as(P(ctypes.c_int32)),
        acc.ctypes.data_as(P(ctypes.c_uint8)),
        ws.ctypes.data_as(P(ctypes.c_int64)),
        gen_p, gen_l.ctypes.data_as(P(ctypes.c_int64)),
        seq_p, seq_l.ctypes.data_as(P(ctypes.c_int64)),
        evs_p, evl_p,
        sig_p, sig_l.ctypes.data_as(P(ctypes.c_int64)),
        strands.ctypes.data_as(P(ctypes.c_uint8)),
        min_num_signal, resegment_signal_wind, more_signal_perc,
        ev_rows.ctypes.data_as(P(ctypes.c_uint8)),
        ev_n.ctypes.data_as(P(ctypes.c_int64)),
        read_al.ctypes.data_as(P(ctypes.c_uint8)),
        genome_al.ctypes.data_as(P(ctypes.c_uint8)),
        al_n.ctypes.data_as(P(ctypes.c_int64)),
        meta.ctypes.data_as(P(ctypes.c_int64)),
        hist.ctypes.data_as(P(ctypes.c_int64)),
        status.ctypes.data_as(P(ctypes.c_int32)), int(nthreads),
        1 if packed else 0)
    del keep

    out = []
    for i, r in enumerate(reads):
        if status[i] == 2:
            out.append((None, "skip"))
            continue
        if status[i] != 0:
            out.append((None, "Incorrect Alignment"))
            continue
        nr = int(ev_n[i])
        nc = int(al_n[i])
        events = np.frombuffer(ev_rows[i, :nr].tobytes(),
                               dtype=CORRECTED_EVENTS_DTYPE)
        payload = {
            "chrom": r.chrom,
            "start": int(meta[i, 0]),
            "strand": r.strand,
            "events": events,
            "read_alignment": read_al[i, :nc].copy().view("S1"),
            "genome_alignment": genome_al[i, :nc].copy().view("S1"),
            "clipped_start": int(meta[i, 1]),
            "clipped_end": int(meta[i, 2]),
            "num_insertions": int(meta[i, 3]),
            "num_deletions": int(meta[i, 4]),
            "num_matches": int(meta[i, 5]),
            "num_mismatches": int(meta[i, 6]),
            "signal_hist": {int(w): int(hist[i, w])
                            for w in np.nonzero(hist[i])[0]},
        }
        out.append((payload, ""))
    return out
