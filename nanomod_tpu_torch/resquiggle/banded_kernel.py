"""Wrapper of kernel K1 (csrc/banded_sw.cu), the banded affine-gap DP.

Port of the Pallas TPU kernel nanomod_tpu/resquiggle/banded_pallas.py
banded_sw_pallas: same inputs and outputs as resquiggle/banded.py
banded_sw, array-equal to it.  Unlike the Pallas wrapper, no [B, M, W] f32
substitution array is built (the kernel scores the u8 codes itself) and B
need not be a multiple of 8, and W is any width in [1, MAX_W].  Up to
W = 1024 one warp aligns one read; a wider band runs a block of
ceil(W / (32 LP)) warps a read (LP = 8, 16 or 32 lanes a thread), which
exchange the band's boundary through shared memory once a row (see the
kernel's source note); the kernel picks its launch from W.  The traceback
rows are written with a pitch of W rounded up to a multiple of 32 bytes
(``tb_pitch``), and the [B, M, W] view of them is returned; K2 reads that
pitch.  The plain version is banded.banded_sw_plain.
"""

from __future__ import annotations

import torch

from nanomod_tpu_torch.kernels import build as kbuild

MAX_W = 32768  # 32 warps of 32 lanes a thread at most


def tb_pitch(w: int) -> int:
    """The row pitch of K1's traceback, in bytes: w rounded up to a
    multiple of 32."""
    return -(-w // 32) * 32


def banded_sw_cuda(read_codes, ref_window_codes, read_len, *,
                   match=2, mismatch=-3, go=-5, ge=-2):
    """Launch K1 on CUDA tensors: read_codes [B, M] uint8,
    ref_window_codes [B, M + W] uint8, read_len [B] int32, W in [1, MAX_W].
    Returns (tb [B, M, W] uint8, a view of rows of tb_pitch(W) bytes;
    best [B] f32, best_i [B] i32, best_k [B] i32)."""
    dev = read_codes.device
    if dev.type != "cuda":
        raise ValueError(f"banded_sw_cuda needs CUDA tensors, got {dev}")
    if read_codes.dtype != torch.uint8 or ref_window_codes.dtype != torch.uint8:
        raise ValueError("read/ref codes must be uint8")
    if read_len.dtype != torch.int32:
        raise ValueError(f"read_len must be int32, got {read_len.dtype}")
    if read_codes.dim() != 2 or ref_window_codes.dim() != 2:
        raise ValueError("read/ref codes must be 2-D")
    bsz, m = read_codes.shape
    w = ref_window_codes.shape[1] - m
    if ref_window_codes.shape[0] != bsz or read_len.shape != (bsz,):
        raise ValueError("batch sizes of read/ref/len disagree")
    if not 1 <= w <= MAX_W:
        raise ValueError(f"band width {w} must be in [1, {MAX_W}]")
    for t in (ref_window_codes, read_len):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
    read_c = read_codes.contiguous()
    ref_c = ref_window_codes.contiguous()
    lens = read_len.contiguous()
    pitch = tb_pitch(w)
    tb = torch.empty((bsz, m, pitch), dtype=torch.uint8, device=dev)
    best = torch.empty(bsz, dtype=torch.float32, device=dev)
    bi = torch.empty(bsz, dtype=torch.int32, device=dev)
    bk = torch.empty(bsz, dtype=torch.int32, device=dev)
    kbuild.launch(
        "banded_sw", "nm_banded_sw", dev,
        read_c.data_ptr(), ref_c.data_ptr(), lens.data_ptr(),
        tb.data_ptr(), best.data_ptr(), bi.data_ptr(), bk.data_ptr(),
        bsz, m, w, pitch, float(match), float(mismatch), float(go),
        float(ge))
    kbuild.LAUNCHES["banded_sw"] += 1
    return tb[..., :w], best, bi, bk
