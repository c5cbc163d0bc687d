# Copied from nanomod_tpu/native/fast5_write_bind.py; only the imports differ.
"""ctypes binding for the native FAST5 corrected-annotation writer
(fast5_write.cpp).

Replaces the h5py write-back (io/fast5.write_corrected_events — itself the
rebuild of save_annotation, ref myRefBaseSignalAnnotation.py:689-749) on the
Annotate hot path: libhdf5 serialises every write behind a process-global
lock (~2.1 ms/file measured), while this path appends + patches each file
lock-free on a C++ thread pool with the deflate fused in.

``write_corrected_batch_native`` returns a per-file bool array; files the
native writer declined (new-style HDF5 layouts, structural surprises) must
be written by the h5py fallback.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from nanomod_tpu_torch.native.build import load_native

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_CHARPP = ctypes.POINTER(ctypes.c_char_p)


def _lib():
    lib = load_native("fast5_write")
    if lib is None:
        return None
    if not getattr(lib, "_f5w_ready", False):
        lib.f5w_write_batch.restype = ctypes.c_int
        lib.f5w_write_batch.argtypes = [
            _CHARPP, ctypes.c_int,
            _U8P, _I64P, _U8P, _I64P, _U8P, _I64P,
            _CHARPP, _CHARPP, _CHARPP,
            _I64P, _I64P, _I64P, _I64P, _I64P, _I64P, _I64P,
            ctypes.c_int, ctypes.c_int, _I32P,
        ]
        lib._f5w_ready = True
    return lib


def _concat_offsets(arrays: List[np.ndarray]):
    offs = np.zeros(len(arrays) + 1, np.int64)
    for i, a in enumerate(arrays):
        offs[i + 1] = offs[i] + len(a)
    cat = (np.concatenate([np.ascontiguousarray(a).view(np.uint8).reshape(-1)
                           for a in arrays])
           if arrays else np.empty(0, np.uint8))
    return cat, offs


def write_corrected_batch_native(
    paths: List[str],
    payloads: List[dict],
    basecall_group: str = "Basecall_1D_000",
    level: int = 1,
    nthreads: int = 4,
) -> Optional[np.ndarray]:
    """Write each payload (the write_corrected_events kwargs dict) into its
    FAST5.  Returns ok-mask per file, or None when the native lib is
    unavailable (caller uses h5py for everything)."""
    lib = _lib()
    if lib is None or not paths:
        return None
    n = len(paths)
    from nanomod_tpu_torch.io.fast5 import CORRECTED_EVENTS_DTYPE

    ev_cat, ev_off = _concat_offsets(
        [np.ascontiguousarray(p["events"].astype(CORRECTED_EVENTS_DTYPE,
                                                 copy=False))
         for p in payloads])
    # ev offsets are in rows, not bytes (itemsize fixed at 25 in C++)
    ev_rows = np.zeros(n + 1, np.int64)
    for i, p in enumerate(payloads):
        ev_rows[i + 1] = ev_rows[i] + len(p["events"])
    ra_cat, ra_off = _concat_offsets([p["read_alignment"] for p in payloads])
    ga_cat, ga_off = _concat_offsets([p["genome_alignment"] for p in payloads])

    def charpp(strings):
        arr = (ctypes.c_char_p * n)()
        arr[:] = [s.encode() if isinstance(s, str) else s for s in strings]
        return arr

    c_paths = charpp(paths)
    c_chroms = charpp([p["chrom"] for p in payloads])
    c_strands = charpp([p["strand"] for p in payloads])
    c_bc = charpp([basecall_group] * n)

    def i64arr(key):
        return np.array([int(p[key]) for p in payloads], np.int64)

    starts = i64arr("start")
    clip_s = i64arr("clipped_start")
    clip_e = i64arr("clipped_end")
    n_ins = i64arr("num_insertions")
    n_del = i64arr("num_deletions")
    n_match = i64arr("num_matches")
    n_mm = i64arr("num_mismatches")
    status = np.empty(n, np.int32)

    def p64(a):
        return a.ctypes.data_as(_I64P)

    def p8(a):
        return (a.ctypes.data_as(_U8P) if a.size
                else ctypes.cast(ctypes.c_char_p(b"\0"), _U8P))

    lib.f5w_write_batch(
        c_paths, n,
        p8(ev_cat), p64(ev_rows),
        p8(ra_cat), p64(ra_off),
        p8(ga_cat), p64(ga_off),
        c_chroms, c_strands, c_bc,
        p64(starts), p64(clip_s), p64(clip_e),
        p64(n_ins), p64(n_del), p64(n_match), p64(n_mm),
        int(level), int(nthreads),
        status.ctypes.data_as(_I32P),
    )
    return status == 0
