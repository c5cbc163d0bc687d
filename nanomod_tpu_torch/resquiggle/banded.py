"""Batched banded affine-gap local alignment and its traceback walk.

Port of nanomod_tpu/resquiggle/banded.py (see there for the recurrences and
the closed-form deletion recurrence).  Two device functions dispatch on the
device of their tensors:

  * ``banded_sw``   CPU -> ``banded_sw_plain`` (plain PyTorch, a loop over
                    rows); CUDA -> kernel K1 (resquiggle/banded_kernel.py)
  * ``walk``        CPU -> the plain walk ``walk_device_plain`` (with
                    ``pack_codes2``: ``walk_packed_plain``); CUDA -> kernel
                    K2 (csrc/walk.cu), which packs the codes itself.  Its
                    codes are four a byte where the step count 2M+W is a
                    multiple of 4, else one a byte (the reference's modes)
  * ``walk_outputs`` the walk's codes behind the DP batch's 12-byte header
                    (the rows the host fetches): CPU -> ``pack_outputs`` of
                    the plain walk; CUDA -> K2, which writes the header

``pack_tb``, ``pack_outputs`` and ``pack_codes2`` are byte reshuffles in
plain PyTorch.  The host decoders (``unpack_outputs``,
``unpack_codes2``, ``decode_walk``, ``decode_walk_native``,
``traceback_batch_native``) are the reference's, loading the shared
``traceback`` native library.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nanomod_tpu_torch.kernels import build as kbuild

NEG = -1e9

# H-source codes (2 bits)
H_ZERO, H_DIAG, H_E, H_F = 0, 1, 2, 3


def banded_sw_plain(read_codes, ref_window_codes, read_len, *,
                    match=2, mismatch=-3, go=-5, ge=-2):
    """Plain PyTorch banded local alignment, row by row.

    read_codes [B, M] uint8 (0-3 ACGT, 4 = N/pad), ref_window_codes
    [B, M + W] uint8 (pad 5), read_len [B] int32.  Returns (tb [B, M, W]
    uint8, best [B] f32, best_i [B] i32, best_k [B] i32), array-equal to
    the reference: every f32 operation is taken in the reference's order.
    """
    bsz, m = read_codes.shape
    w = ref_window_codes.shape[1] - m
    dev = read_codes.device
    f32 = torch.float32
    karange = torch.arange(w, dtype=f32, device=dev)
    ge_k = ge * karange
    e_base = ge_k + go - ge
    neg_col = torch.full((bsz, 1), NEG, dtype=f32, device=dev)
    rc_all = read_codes.to(torch.int32)
    ref_all = ref_window_codes.to(torch.int32)
    lens = read_len.to(torch.int32)

    h_prev = torch.zeros((bsz, w), dtype=f32, device=dev)
    f_prev = torch.full((bsz, w), NEG, dtype=f32, device=dev)
    best = torch.zeros(bsz, dtype=f32, device=dev)
    best_i = torch.zeros(bsz, dtype=torch.int32, device=dev)
    best_k = torch.zeros(bsz, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    neg = torch.full((), NEG, dtype=f32, device=dev)
    rows = []
    for i in range(m):
        rc = rc_all[:, i:i + 1]
        refrow = ref_all[:, i:i + w]
        is_match = (refrow == rc) & (rc < 4) & (refrow < 4)
        sub = torch.where(is_match, float(match), float(mismatch)).to(f32)

        h_up = torch.cat([h_prev[:, 1:], neg_col], dim=1)
        f_up = torch.cat([f_prev[:, 1:], neg_col], dim=1)
        f_cur = torch.maximum(h_up + go, f_up + ge)
        hdiag = h_prev + sub
        h_noe = torch.maximum(torch.maximum(hdiag, f_cur), zero)

        cm = torch.cummax(h_noe - ge_k, dim=1).values
        cm_shift = torch.cat([neg_col, cm[:, :-1]], dim=1)
        e_cur = e_base + cm_shift
        h_cur = torch.maximum(h_noe, e_cur)

        valid = (i < lens)[:, None]
        h_cur = torch.where(valid, h_cur, zero)
        f_cur = torch.where(valid, f_cur, neg)

        src = torch.where(
            h_cur <= 0.0, H_ZERO,
            torch.where(e_cur >= h_noe, H_E,
                        torch.where(f_cur >= torch.maximum(hdiag, zero), H_F,
                                    H_DIAG)))
        h_noe_shift = torch.cat([neg_col, h_noe[:, :-1]], dim=1)
        e_ext = e_cur > h_noe_shift + go + 1e-4
        f_ext = f_cur > h_up + go + 1e-4
        rows.append((src.to(torch.uint8)
                     | (e_ext.to(torch.uint8) << 2)
                     | (f_ext.to(torch.uint8) << 3)))

        row_best, row_best_k = torch.max(h_cur, dim=1)
        improve = row_best > best
        best = torch.where(improve, row_best, best)
        best_i = torch.where(improve, torch.full_like(best_i, i), best_i)
        best_k = torch.where(improve, row_best_k.to(torch.int32), best_k)
        h_prev, f_prev = h_cur, f_cur
    tb = torch.stack(rows, dim=1)
    return tb, best, best_i, best_k


def banded_sw(read_codes, ref_window_codes, read_len, *,
              match=2, mismatch=-3, go=-5, ge=-2):
    """Banded DP on the device of ``read_codes``: the plain version for CPU
    tensors, kernel K1 for CUDA tensors (raises if it cannot launch)."""
    if read_codes.device.type == "cpu":
        return banded_sw_plain(read_codes, ref_window_codes, read_len,
                               match=match, mismatch=mismatch, go=go, ge=ge)
    from nanomod_tpu_torch.resquiggle.banded_kernel import banded_sw_cuda
    return banded_sw_cuda(read_codes, ref_window_codes, read_len,
                          match=match, mismatch=mismatch, go=go, ge=ge)


def pack_tb(tb):
    """Nibble-pack a [B, M, W] traceback matrix (two 4-bit cells per byte,
    low nibble = even k).  W must be even."""
    return tb[..., 0::2] | (tb[..., 1::2] << 4)


def pack_outputs(tb, best, best_i, best_k):
    """All DP outputs as one uint8 array [B, 12 + prod(tb.shape[1:])], so
    the device-to-host copy is a single transfer.  Row layout: best
    (little-endian i32, round half to even) | best_i (i32) | best_k (i32) |
    tb bytes, the reference's layout byte for byte."""
    bsz = tb.shape[0]
    extra = torch.stack(
        [torch.round(best).to(torch.int32), best_i.to(torch.int32),
         best_k.to(torch.int32)], dim=1).contiguous()
    return torch.cat([extra.view(torch.uint8).reshape(bsz, 12),
                      tb.reshape(bsz, -1)], dim=1)


def unpack_outputs(fetched: np.ndarray, tail_shape):
    """Host-side inverse of pack_outputs: returns (tb, best, best_i,
    best_k) numpy views; tail_shape is tb.shape[1:]."""
    extra = np.ascontiguousarray(fetched[:, :12]).view(np.int32)
    tb = fetched[:, 12:].reshape((fetched.shape[0],) + tuple(tail_shape))
    return tb, extra[:, 0], extra[:, 1], extra[:, 2]


def walk_device_plain(tb, best_i, best_k):
    """Plain PyTorch traceback walk of every read in lockstep.

    Returns codes [B, 2M+W] uint8 in walk (3'->5') order: 0 = stopped,
    1 = M, 2 = I, 3 = D; byte-equal to the reference's walk_device."""
    bsz, m, w = tb.shape
    dev = tb.device
    tbf = tb.reshape(bsz, m * w)
    steps = 2 * m + w
    i = best_i.to(torch.int64)
    k = best_k.to(torch.int64)
    st = torch.zeros(bsz, dtype=torch.int64, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    codes = torch.empty((bsz, steps), dtype=torch.uint8, device=dev)
    for s in range(steps):
        idx = i.clamp(0, m - 1) * w + k.clamp(0, w - 1)
        bits = tbf.gather(1, idx[:, None])[:, 0].to(torch.int64)
        src = bits & 3
        e_ext = (bits & 4) != 0
        f_ext = (bits & 8) != 0
        is_h = st == 0
        act_m = is_h & (src == H_DIAG)
        act_d = (is_h & (src == H_E)) | (st == 1)
        act_i = (is_h & (src == H_F)) | (st == 2)
        stop = is_h & (src == H_ZERO)
        codes[:, s] = torch.where(
            done | stop, 0,
            torch.where(act_m, 1, torch.where(act_i, 2, 3))).to(torch.uint8)
        ni = torch.where(act_m | act_i, i - 1, i)
        nk = torch.where(act_d, k - 1, torch.where(act_i, k + 1, k))
        nst = torch.where(act_m, 0,
                          torch.where(act_d, e_ext.to(torch.int64),
                                      torch.where(act_i,
                                                  2 * f_ext.to(torch.int64),
                                                  st)))
        ndone = done | stop | (ni < 0) | (nk < 0) | (nk >= w)
        i = torch.where(done, i, ni)
        k = torch.where(done, k, nk)
        st = torch.where(done, st, nst)
        done = ndone
    return codes


def walk_packed_plain(tb, best_i, best_k):
    """The walk's codes packed four a byte, [B, (2M+W)/4] uint8: plain
    PyTorch, ``pack_codes2(walk_device_plain(...))``."""
    return pack_codes2(walk_device_plain(tb, best_i, best_k))


def _pitched(tb):
    """(tb, pitch) as K2 reads it: rows of ``pitch`` bytes, a multiple of
    16 in [W, tb_pitch(MAX_W)], at a 16-byte aligned address.  K1's output
    (a [..., :W] view of rows padded to tb_pitch(W)) already is; any other
    tb is copied into such rows."""
    from nanomod_tpu_torch.resquiggle.banded_kernel import MAX_W, tb_pitch
    bsz, m, w = tb.shape
    s0, s1, s2 = tb.stride()
    if (s2 == 1 and s1 % 16 == 0 and w <= s1 <= tb_pitch(MAX_W)
            and s0 == m * s1
            and tb.data_ptr() % 16 == 0):
        return tb, s1
    pitch = tb_pitch(w)
    rows = torch.zeros((bsz, m, pitch), dtype=torch.uint8, device=tb.device)
    rows[..., :w] = tb
    return rows, pitch


def _walk_cuda(tb, best_i, best_k, packed: bool, best=None):
    """Kernel K2 (csrc/walk.cu) on CUDA tensors: the walk's codes, four a
    byte when ``packed``, else one a byte.  With ``best`` (the DP's [B] f32
    scores) each row is the DP batch's 12-byte header and then the codes,
    byte-equal to ``pack_outputs(codes, best, best_i, best_k)``."""
    from nanomod_tpu_torch.resquiggle.banded_kernel import MAX_W
    dev = tb.device
    if dev.type != "cuda":
        raise ValueError(f"the walk kernel needs CUDA tensors, got {dev}")
    if tb.dtype != torch.uint8 or tb.dim() != 3:
        raise ValueError(f"tb must be [B, M, W] uint8, got {tb.dtype} "
                         f"{tuple(tb.shape)}")
    bsz, m, w = tb.shape
    if not 1 <= w <= MAX_W:
        raise ValueError(f"band width {w} must be in [1, {MAX_W}]")
    steps = 2 * m + w
    if packed and steps % 4:
        raise ValueError(f"2M+W = {steps} steps do not pack four a byte")
    if best_i.shape != (bsz,) or best_k.shape != (bsz,):
        raise ValueError("best_i/best_k must be [B]")
    for x in (best_i, best_k):
        if x.device != dev or x.dtype != torch.int32:
            raise ValueError("best_i/best_k must be int32 on tb's device")
    hdr = 0
    if best is not None:
        if best.shape != (bsz,) or best.device != dev or \
                best.dtype != torch.float32:
            raise ValueError("best must be [B] float32 on tb's device")
        best = best.contiguous()
        hdr = 12
    rows, pitch = _pitched(tb)
    bi = best_i.contiguous()
    bk = best_k.contiguous()
    out = torch.empty((bsz, hdr + (steps // 4 if packed else steps)),
                      dtype=torch.uint8, device=dev)
    kbuild.launch("walk", "nm_walk", dev, rows.data_ptr(), bi.data_ptr(),
                  bk.data_ptr(), None if best is None else best.data_ptr(),
                  out.data_ptr(), bsz, m, w, pitch, int(packed))
    kbuild.LAUNCHES["walk"] += 1
    return out


def walk(tb, best_i, best_k, packed=None):
    """The traceback walk on the device of ``tb`` (the plain version for
    CPU tensors, kernel K2 for CUDA tensors; raises if it cannot launch).
    Returns (codes, packed): the codes four a byte, [B, (2M+W)/4], when
    ``packed``, else one a byte, [B, 2M+W].  ``packed=None`` takes the
    reference's mode (nanomod_tpu/resquiggle/pipeline.py dispatch_dp):
    packed exactly when 2M+W is a multiple of 4."""
    bsz, m, w = tb.shape
    if packed is None:
        packed = (2 * m + w) % 4 == 0
    if tb.device.type != "cpu":
        return _walk_cuda(tb, best_i, best_k, packed), packed
    codes = walk_device_plain(tb, best_i, best_k)
    return (pack_codes2(codes) if packed else codes), packed


def walk_outputs(tb, best, best_i, best_k, packed=None):
    """The DP batch's outputs as the host fetches them, on the device of
    ``tb``: [B, 12 + L] uint8 rows, each the 12-byte header of
    ``pack_outputs`` (round-half-to-even best, best_i, best_k as
    little-endian int32) and then the walk's L code bytes (as ``walk``:
    four codes a byte when ``packed``).  Returns (rows, packed).  CPU
    tensors take ``pack_outputs`` of the plain walk; CUDA tensors one
    launch of K2, which writes the header itself (raises if it cannot
    launch)."""
    bsz, m, w = tb.shape
    if packed is None:
        packed = (2 * m + w) % 4 == 0
    if tb.device.type != "cpu":
        return _walk_cuda(tb, best_i, best_k, packed, best=best), packed
    codes, packed = walk(tb, best_i, best_k, packed)
    return pack_outputs(codes, best, best_i, best_k), packed


def pack_codes2(codes):
    """Pack the 2-bit walk codes (0..3) four per byte.  The step count
    2M+W must be a multiple of 4."""
    b, s = codes.shape
    if s % 4:
        raise ValueError(f"{s} steps do not pack four a byte")
    c = codes.reshape(b, s // 4, 4)
    return (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
            | (c[..., 3] << 6))


def unpack_codes2(packed: np.ndarray) -> np.ndarray:
    """Host inverse of pack_codes2."""
    b, sb = packed.shape
    out = np.empty((b, sb * 4), np.uint8)
    for j in range(4):
        out[:, j::4] = (packed >> (2 * j)) & 3
    return out


def decode_walk(codes_row: np.ndarray, best_i: int, best_k: int):
    """Host decode of one read's walk codes into traceback-style ops
    (5'->3'), the pure-Python reference for decode_walk_native."""
    i, k = int(best_i), int(best_k)
    ops = []
    for c in codes_row:
        if c == 0:
            break
        if c == 1:
            ops.append(("M", i, i + k))
            i -= 1
        elif c == 2:
            ops.append(("I", i))
            i -= 1
            k += 1
        else:
            ops.append(("D", i + k))
            k -= 1
    ops.reverse()
    return ops


def _traceback_lib():
    from nanomod_tpu_torch.native import require
    lib, = require("traceback")
    return lib


def decode_walk_native(codes: np.ndarray, best_i: np.ndarray,
                       best_k: np.ndarray, nthreads: int = 8,
                       packed: bool = False):
    """Whole-batch C++ decode of walk codes (traceback.cpp
    decode_walk_batch); returns (ops_type, ops_a, ops_b) triples in 5'->3'
    order per read.  packed: codes are pack_codes2 bytes."""
    lib = _traceback_lib()
    if not getattr(lib, "_decode_sig", False):
        lib.decode_walk_batch.restype = None
        lib.decode_walk_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ]
        lib._decode_sig = True
    bsz, sb = codes.shape
    s = sb * 4 if packed else sb
    cap = s
    ot = np.empty((bsz, cap), np.int32)
    oa = np.empty((bsz, cap), np.int32)
    ob = np.empty((bsz, cap), np.int32)
    out_n = np.zeros(bsz, np.int64)
    codes_c = np.ascontiguousarray(codes, dtype=np.uint8)
    bi = np.ascontiguousarray(best_i, dtype=np.int32)
    bk = np.ascontiguousarray(best_k, dtype=np.int32)
    lib.decode_walk_batch(
        codes_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bsz, s,
        bi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ot.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        oa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ob.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        out_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nthreads,
        1 if packed else 0)
    return [(ot[b, : out_n[b]].copy(), oa[b, : out_n[b]].copy(),
             ob[b, : out_n[b]].copy()) for b in range(bsz)]


def traceback_batch_native(tb: np.ndarray, best_i: np.ndarray,
                           best_k: np.ndarray, *, packed: bool,
                           nthreads: int = 8):
    """Whole-batch C++ traceback (native/traceback.cpp traceback_batch).

    tb is [B, M, W] uint8 or, when packed, [B, M, W//2] nibble-packed.
    Returns a list of (ops_type, ops_a, ops_b) int32 array triples in
    5'->3' order.
    """
    lib = _traceback_lib()
    if not getattr(lib, "_batch_sig", False):
        lib.traceback_batch.restype = None
        lib.traceback_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        lib._batch_sig = True
    bsz, m, wbytes = tb.shape
    w = wbytes * 2 if packed else wbytes
    cap = 2 * m + w + 8
    ot = np.empty((bsz, cap), np.int32)
    oa = np.empty((bsz, cap), np.int32)
    ob = np.empty((bsz, cap), np.int32)
    out_n = np.zeros(bsz, np.int64)
    tb_c = np.ascontiguousarray(tb, dtype=np.uint8)
    bi = np.ascontiguousarray(best_i, dtype=np.int32)
    bk = np.ascontiguousarray(best_k, dtype=np.int32)
    lib.traceback_batch(
        tb_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bsz, m, wbytes,
        1 if packed else 0,
        bi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ot.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        oa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ob.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        out_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nthreads)
    return [(ot[b, : out_n[b]].copy(), oa[b, : out_n[b]].copy(),
             ob[b, : out_n[b]].copy()) for b in range(bsz)]
