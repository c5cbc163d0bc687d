# Copied from nanomod_tpu/native/fast5_bind.py; imports and stages differ.
# read_corrected_batch times two stages: ingest.read, the native open and
# parse of every file on nthreads threads (files), and ingest.unpack, the
# copy into numpy and the reads built (reads).
"""ctypes binding for the native FAST5 ingest (native/fast5_ingest.cpp).

Batch-reads NanomoCorrected_000 annotations (ref layout:
myRefBaseSignalAnnotation.py:689-742) from many FAST5 files with a C++
thread pool — a from-scratch HDF5 parser, so no libhdf5 global lock limits
parallelism.  Falls back to None when the toolchain is unavailable (callers
then use the h5py path in io.fast5)."""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

from nanomod_tpu_torch.io.fast5 import CorrectedRead
from nanomod_tpu_torch.native.build import load_native
from nanomod_tpu_torch.utils.observe import stage

_sig_set = False


def _lib():
    global _sig_set
    lib = load_native("fast5_ingest")
    if lib is not None and not _sig_set:
        lib.f5_batch_read.restype = ctypes.c_void_p
        lib.f5_batch_read.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int]
        lib.f5_batch_sizes.restype = ctypes.c_int64
        lib.f5_batch_sizes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.f5_batch_fill.restype = None
        lib.f5_batch_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_char_p]
        lib.f5_batch_free.restype = None
        lib.f5_batch_free.argtypes = [ctypes.c_void_p]
        _sig_set = True
    return lib


def native_ingest_available() -> bool:
    return _lib() is not None


def read_corrected_batch(paths: List[str],
                         nthreads: int = 0) -> Optional[List[Optional[CorrectedRead]]]:
    """Read many corrected FAST5s natively.

    Returns a list aligned with `paths` (None entries for files without a
    readable corrected group — matching read_corrected_events' tolerance,
    ref myDetect.py:41-45), or None if the native library is unavailable.
    """
    lib = _lib()
    if lib is None:
        return None
    n = len(paths)
    if n == 0:
        return []
    if nthreads <= 0:
        nthreads = min(32, os.cpu_count() or 4)

    with stage("ingest.read", unit="files") as s:
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        handle = lib.f5_batch_read(c_paths, n, nthreads)
        s.add(n)
    with stage("ingest.unpack", unit="reads") as s:
        try:
            n_events = np.zeros(n, np.int64)
            total = lib.f5_batch_sizes(
                handle,
                n_events.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))

            norm_mean = np.empty(total, np.float64)
            norm_stdev = np.empty(total, np.float64)
            ev_start = np.empty(total, np.uint32)
            ev_length = np.empty(total, np.uint32)
            base = np.empty(total, "S1")
            offsets = np.empty(n + 1, np.int64)
            map_start = np.empty(n, np.int64)
            strands = np.empty(n, "S1")
            chroms = np.empty(n, "S64")

            lib.f5_batch_fill(
                handle,
                norm_mean.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                norm_stdev.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ev_start.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ev_length.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                base.ctypes.data_as(ctypes.c_char_p),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                map_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                strands.ctypes.data_as(ctypes.c_char_p),
                chroms.ctypes.data_as(ctypes.c_char_p),
            )
        finally:
            lib.f5_batch_free(handle)

        out: List[Optional[CorrectedRead]] = []
        for i in range(n):
            if n_events[i] < 0:
                out.append(None)
                continue
            lo, hi = offsets[i], offsets[i] + n_events[i]
            out.append(CorrectedRead(
                chrom=chroms[i].decode(),
                start=int(map_start[i]),
                strand=strands[i].decode(),
                norm_mean=norm_mean[lo:hi],
                norm_stdev=norm_stdev[lo:hi],
                ev_start=ev_start[lo:hi],
                ev_length=ev_length[lo:hi],
                base=base[lo:hi],
                filename=paths[i],
            ))
        s.add(n - int((n_events < 0).sum()))
    return out
