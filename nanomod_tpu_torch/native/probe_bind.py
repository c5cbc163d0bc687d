"""ctypes binding of the port's FAST5 object probe (native/fast5_probe.cpp,
a port-only source): whether each of many FAST5 files holds an HDF5 group
or dataset at a path, read by the repo's own HDF5 parser on C++ threads,
without h5py.  Annotate --resume asks it for the corrected group."""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from nanomod_tpu_torch.native import require


def has_object_batch(paths: List[str], obj: str,
                     nthreads: int = 8) -> np.ndarray:
    """[len(paths)] int8: 1 where ``obj`` (a slash path from the root)
    resolves, 0 where it does not or the file is no HDF5 file (h5py's
    OSError), -1 where the parser failed on an HDF5 file (h5py must
    decide).  Raises when the library cannot be built."""
    lib, = require("fast5_probe")
    if not getattr(lib, "_probe_sig", False):
        lib.f5_has_object.restype = None
        lib.f5_has_object.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int8)]
        lib._probe_sig = True
    out = np.zeros(len(paths), np.int8)
    if paths:
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        lib.f5_has_object(arr, len(paths), obj.encode(),
                          max(1, min(nthreads, len(paths))),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out
