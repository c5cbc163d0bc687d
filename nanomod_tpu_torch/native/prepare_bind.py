# Copied from nanomod_tpu/native/prepare_bind.py; only the imports differ.
"""ctypes binding for the native raw-read prepare
(native/fast5_ingest.cpp f5_prepare_*): parse raw FAST5s, extract per-base
events (albacore1/2 + guppy dialects) and median/MAD-normalize the signal
in threaded C++.  The Python path (io/fast5.read_raw_basecall +
signal/events.extract_events + signal/normalize.mad_normalize) is the
specification; tests assert bit-identical outputs.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from nanomod_tpu_torch.native.build import load_native

# error codes of parse_raw (fast5_ingest.cpp) -> reference taxonomy keys
# (ref myRefBaseSignalAnnotation.py:45-48 raiseError call sites); None =
# retry through the Python path (h5py may parse what the mini-reader can't)
PREP_ERRORS = {
    1: "Cannot open fast5",
    2: "No Channel Info",
    3: "No Raw_reads/Signal",
    4: "No Fastq data",
    5: "No events/move data",
    6: "Remove too many bases on left",
    7: "Remove too many bases on right",
    8: "The index of the first base is less than -2",
    9: None,
    10: "Cannot nanopore correction",
}

_sig_set = False


def _lib():
    global _sig_set
    lib = load_native("fast5_ingest")
    if lib is not None and not _sig_set:
        c = ctypes
        lib.f5_prepare_batch.restype = c.c_void_p
        lib.f5_prepare_batch.argtypes = [
            c.POINTER(c.c_char_p), c.c_int64, c.c_char_p, c.c_char_p,
            c.POINTER(c.c_double), c.POINTER(c.c_double), c.c_int]
        lib.f5_prepare_sizes.restype = c.c_int64
        lib.f5_prepare_sizes.argtypes = [
            c.c_void_p, c.POINTER(c.c_int32), c.POINTER(c.c_int64),
            c.POINTER(c.c_int64), c.POINTER(c.c_int64)]
        lib.f5_prepare_fill.restype = None
        lib.f5_prepare_fill.argtypes = [
            c.c_void_p, c.POINTER(c.c_double), c.POINTER(c.c_int64),
            c.POINTER(c.c_int64), c.c_char_p, c.c_char_p]
        lib.f5_prepare_free.restype = None
        lib.f5_prepare_free.argtypes = [c.c_void_p]
        _sig_set = True
    return lib


class PreparedRaw:
    """One natively prepared read (basecall order)."""

    __slots__ = ("read_id", "seq", "ev_start", "ev_length", "norm_signal")

    def __init__(self, read_id, seq, ev_start, ev_length, norm_signal):
        self.read_id = read_id
        self.seq = seq
        self.ev_start = ev_start
        self.ev_length = ev_length
        self.norm_signal = norm_signal


def model_tables(kmer_model) -> Optional[tuple]:
    """Convert a load_kmer_model dict into the dense (levels, invvars)
    1024-entry 5-mer tables of f5_prepare_batch; None if the model does
    not cover all ACGT 5-mers (then the Python path must be used)."""
    if kmer_model is None:
        return None
    levels = np.empty(1024, np.float64)
    invvars = np.empty(1024, np.float64)
    bases = "ACGT"
    for code in range(1024):
        k = "".join(bases[(code >> (2 * (4 - j))) & 3] for j in range(5))
        ent = kmer_model.get(k)
        if ent is None:
            return None
        levels[code], invvars[code] = ent
    return levels, invvars


def native_prepare_batch(paths: List[str], basecall_1d: str,
                         basecall_2strand: str, nthreads: int = 4,
                         kmer_tables: Optional[tuple] = None
                         ) -> Optional[List]:
    """Parse + extract + normalize a batch of raw FAST5s natively.

    kmer_tables (from model_tables) enables the nanopolish-style
    shift/scale calibration before MAD normalization.  Returns a list
    aligned with `paths`: PreparedRaw on success, an error key string
    (reference taxonomy) on a classified failure, or None for "retry via
    the Python path".  Returns None (whole call) when the native library
    is unavailable.
    """
    lib = _lib()
    if lib is None:
        return None
    n = len(paths)
    if n == 0:
        return []
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if kmer_tables is not None:
        lv, iv = kmer_tables
        lv_p = lv.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        iv_p = iv.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    else:
        lv_p = iv_p = None
    h = lib.f5_prepare_batch(arr, n, basecall_1d.encode(),
                             basecall_2strand.encode(), lv_p, iv_p,
                             max(1, nthreads))
    try:
        err = np.zeros(n, np.int32)
        n_ev = np.zeros(n, np.int64)
        n_sig = np.zeros(n, np.int64)
        id_len = np.zeros(n, np.int64)
        lib.f5_prepare_sizes(
            h, err.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_ev.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_sig.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            id_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        tot_ev = int(n_ev.sum())
        tot_sig = int(n_sig.sum())
        tot_id = int(id_len.sum())
        norm = np.empty(tot_sig, np.float64)
        ev_s = np.empty(tot_ev, np.int64)
        ev_l = np.empty(tot_ev, np.int64)
        seq = ctypes.create_string_buffer(max(tot_ev, 1))
        ids = ctypes.create_string_buffer(max(tot_id, 1))
        lib.f5_prepare_fill(
            h, norm.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ev_s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ev_l.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            seq, ids)
    finally:
        lib.f5_prepare_free(h)

    seq_b = seq.raw[:tot_ev]
    ids_b = ids.raw[:tot_id]
    out = []
    eo = so = io = 0
    for i in range(n):
        if err[i] != 0:
            out.append(PREP_ERRORS.get(int(err[i])))
            continue
        ne, ns, ni = int(n_ev[i]), int(n_sig[i]), int(id_len[i])
        read_id = ids_b[io: io + ni].decode(errors="replace")
        # fastq header munging (ref myFast5.py read id handling)
        read_id = read_id.replace(" ", ":::").replace("\t", "|||")
        # views into the batch buffers (no per-read copies; ~0.2 MB/read
        # of memcpy saved) — the base arrays stay alive via the views
        out.append(PreparedRaw(
            read_id=read_id,
            seq=seq_b[eo: eo + ne].decode(errors="replace"),
            ev_start=ev_s[eo: eo + ne],
            ev_length=ev_l[eo: eo + ne],
            norm_signal=norm[so: so + ns],
        ))
        eo += ne
        so += ns
        io += ni
    return out
