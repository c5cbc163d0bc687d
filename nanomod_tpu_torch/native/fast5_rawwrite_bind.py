"""ctypes binding for the port's raw basecalled FAST5 writer
(native/fast5_rawwrite.cpp): whole new files, as the reference's
tools/scale_fullchain.py and tests/fixtures.py write them with h5py,
without h5py (which the card's machine does not have), and files that hold
only their root group, for the corrected writer to fill.  Files are
written on a C++ thread pool."""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from nanomod_tpu_torch.native.build import require

# the albacore2 basecall event table (tools/scale_fullchain.py)
ALBACORE2_EVENT_DTYPE = np.dtype([
    ("mean", "<f8"), ("stdv", "<f8"), ("start", "<u8"), ("length", "<u8"),
    ("model_state", "S5"), ("move", "<i4"),
])

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_CHARPP = ctypes.POINTER(ctypes.c_char_p)


def _lib():
    lib, = require("fast5_rawwrite")
    if not getattr(lib, "_rw_ready", False):
        lib.rw_write_batch.restype = ctypes.c_int
        lib.rw_write_batch.argtypes = [
            _CHARPP, ctypes.c_int, _I64P, _CHARPP,
            _U8P, _I64P, _U8P, _I64P, _U8P, _I64P,
            ctypes.POINTER(ctypes.c_double), _CHARPP, _I64P, _U8P,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        lib.rw_write_empty.restype = ctypes.c_int
        lib.rw_write_empty.argtypes = [ctypes.c_char_p]
        lib._rw_ready = True
    return lib


def _cat(arrays: List[np.ndarray]):
    """The arrays' bytes end to end and their exclusive prefix offsets in
    rows."""
    offs = np.zeros(len(arrays) + 1, np.int64)
    offs[1:] = np.cumsum([len(a) for a in arrays])
    cat = np.concatenate([np.ascontiguousarray(a).view(np.uint8).reshape(-1)
                          for a in arrays])
    return cat, offs


def write_raw_batch(paths: List[str], reads: List[dict], *,
                    basecall_group: str = "Basecall_1D_000",
                    template_group: str = "BaseCalled_template",
                    bc_name: bytes = b"ONT Albacore Sequencing Software",
                    bc_version: bytes = b"2.3.1", nthreads: int = 8):
    """Write one raw FAST5 a read (created or overwritten).  Each read is a
    dict: ``read_number`` (Read_<n>), ``read_id`` (str), ``signal`` (int16
    DAC samples), ``events`` (ALBACORE2_EVENT_DTYPE), ``fastq`` (bytes),
    ``channel`` (digitisation, offset, range, sampling_rate) and, where
    given, ``channel_number`` (bytes, a channel_id attribute) and
    ``start_time`` (int, a Read_<n> attribute).  Raises RuntimeError naming
    the files it could not write."""
    n = len(paths)
    if n != len(reads):
        raise ValueError("one read a path")
    if n == 0:
        return
    lib = _lib()
    sig, sig_off = _cat([np.asarray(r["signal"], "<i2") for r in reads])
    ev, ev_off = _cat([np.asarray(r["events"], ALBACORE2_EVENT_DTYPE)
                       for r in reads])
    fq, fq_off = _cat([np.frombuffer(r["fastq"], np.uint8) for r in reads])
    nums = np.array([int(r["read_number"]) for r in reads], np.int64)
    channel = np.ascontiguousarray(
        [[float(x) for x in r["channel"]] for r in reads], np.float64)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_ids = (ctypes.c_char_p * n)(*[r["read_id"].encode() for r in reads])
    c_chan = (ctypes.c_char_p * n)(*[r.get("channel_number") for r in reads])
    has_start = np.array([r.get("start_time") is not None for r in reads],
                         np.uint8)
    starts = np.array([int(r.get("start_time") or 0) for r in reads],
                      np.int64)
    status = np.empty(n, np.int32)
    lib.rw_write_batch(
        c_paths, n, nums.ctypes.data_as(_I64P), c_ids,
        sig.ctypes.data_as(_U8P), sig_off.ctypes.data_as(_I64P),
        ev.ctypes.data_as(_U8P), ev_off.ctypes.data_as(_I64P),
        fq.ctypes.data_as(_U8P), fq_off.ctypes.data_as(_I64P),
        channel.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), c_chan,
        starts.ctypes.data_as(_I64P), has_start.ctypes.data_as(_U8P),
        basecall_group.encode(), template_group.encode(), bc_name,
        bc_version, int(nthreads), status.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)))
    bad = [(p, int(s)) for p, s in zip(paths, status) if s != 0]
    if bad:
        raise RuntimeError(f"the raw FAST5 writer failed on {len(bad)} "
                           f"file(s): {bad[:5]}")


def write_empty(path: str):
    """Write an HDF5 file that holds only its root group (created or
    overwritten), as ``h5py.File(path, "w")`` leaves one.  Raises
    RuntimeError when it cannot."""
    status = _lib().rw_write_empty(path.encode())
    if status != 0:
        raise RuntimeError(f"the raw FAST5 writer failed on {path} "
                           f"(status {status})")
