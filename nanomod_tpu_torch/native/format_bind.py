# Copied from nanomod_tpu/native/format_bind.py; only the imports differ.
"""ctypes binding for the threaded results-table formatter
(native/format_core.cpp).  Pure-Python fallback lives in
detect.save_sign_test; parity is pinned by adversarial-value tests and the
golden byte fixtures."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from nanomod_tpu_torch.native.build import load_native

_c_dp = ctypes.POINTER(ctypes.c_double)
_c_i32p = ctypes.POINTER(ctypes.c_int32)
_c_i64p = ctypes.POINTER(ctypes.c_int64)


def _lib():
    lib = load_native("format_core")
    if lib is None:
        return None
    if not getattr(lib, "_fmt_sig", False):
        lib.format_sign_test.restype = ctypes.c_int64
        lib.format_sign_test.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), _c_i32p, _c_i64p,
            ctypes.c_char_p, _c_i32p, _c_i32p,
            _c_dp, _c_dp, _c_dp, _c_dp, _c_dp, _c_dp, _c_dp, _c_dp,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_char_p,
        ]
        lib.format_meanstd.restype = ctypes.c_int64
        lib.format_meanstd.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), _c_i32p, _c_i64p,
            ctypes.c_char_p, _c_dp, ctypes.c_int64, ctypes.c_int,
            ctypes.c_char_p,
        ]
        lib._fmt_sig = True
    return lib


def _f64(a):
    """Contiguous f64 view/copy; the caller must hold the returned array
    alive for the duration of the C call."""
    return np.ascontiguousarray(a, dtype=np.float64)


def _common(table):
    prefixes = [f"{c} {s}".encode() for (c, s) in table.keys] or [b""]
    pre_arr = (ctypes.c_char_p * len(prefixes))(*prefixes)
    gid = np.ascontiguousarray(table.group_ids, dtype=np.int32)
    pos = np.ascontiguousarray(table.positions, dtype=np.int64)
    base = table.base.astype("S1").tobytes()
    return pre_arr, gid, pos, base


def write_sign_test_native(table, path: str, has_comb: bool,
                           nthreads: int = 4) -> bool:
    """True on success; False -> caller uses the Python fallback."""
    lib = _lib()
    if lib is None:
        return False
    r = table.res
    n = len(table)
    pre_arr, gid, pos, base = _common(table)
    cov1 = np.ascontiguousarray(table.cov1, dtype=np.int32)
    cov2 = np.ascontiguousarray(table.cov2, dtype=np.int32)
    cols = [_f64(x) for x in (
        r.stu, r.pu, r.stt, r.pt, r.stks, r.pks,
        r.stcomb if has_comb else r.stu, r.pcomb if has_comb else r.pu)]
    res = lib.format_sign_test(
        pre_arr, gid.ctypes.data_as(_c_i32p), pos.ctypes.data_as(_c_i64p),
        base, cov1.ctypes.data_as(_c_i32p), cov2.ctypes.data_as(_c_i32p),
        *(c.ctypes.data_as(_c_dp) for c in cols),
        int(has_comb), n, nthreads, path.encode())
    return res >= 0


def write_meanstd_native(table, path: str, nthreads: int = 4) -> bool:
    lib = _lib()
    if lib is None or table.res.mstd is None:
        return False
    n = len(table)
    pre_arr, gid, pos, base = _common(table)
    mstd = _f64(table.res.mstd)
    res = lib.format_meanstd(
        pre_arr, gid.ctypes.data_as(_c_i32p), pos.ctypes.data_as(_c_i64p),
        base, mstd.ctypes.data_as(_c_dp), n, nthreads, path.encode())
    return res >= 0
