"""Wrapper of kernel K1 (csrc/banded_sw.cu), the banded affine-gap DP.

Port of the Pallas TPU kernel nanomod_tpu/resquiggle/banded_pallas.py
banded_sw_pallas: same inputs and outputs as resquiggle/banded.py
banded_sw, array-equal to it.  Unlike the Pallas wrapper, no [B, M, W] f32
substitution array is built (the kernel scores the u8 codes itself) and B
need not be a multiple of 8, and W is any width in [1, MAX_W].  Up to
W = NARROW_MAX_W (256) one warp aligns one read; a wider band runs a block
of ceil(W / (32 LP)) warps a read, which exchange the band's boundary
through shared memory once a row (see the kernel's source note), and
which is the faster of the two from W 257 on (kernels/k1_plans.py).  LP,
the lanes a thread, comes from W and the batch B through the plan table
WIDE_PLANS and FULL_BATCH, which the kernel's dispatch holds too
(``wide_plan`` gives a launch).
The traceback rows are written with a pitch of W rounded up to a multiple
of 32 bytes (``tb_pitch``), and the [B, M, W] view of them is returned; K2
reads that pitch.  The plain version is banded.banded_sw_plain.
"""

from __future__ import annotations

import torch

from nanomod_tpu_torch.kernels import build as kbuild

MAX_W = 32768  # 32 warps of 32 lanes a thread at most
NARROW_MAX_W = 256  # one warp a read up to here (csrc/banded_sw.cu's too)

# K1's launch plans above NARROW_MAX_W, the same table as csrc/banded_sw.cu
# WIDE_PLANS and FULL_BATCH: (largest W, the plan of a batch of fewer than
# FULL_BATCH reads, the plan of a batch of at least FULL_BATCH), each plan
# (lanes a thread, threads bound, blocks an SM asked of the compiler); a
# band width takes the first row whose largest W is >= it.
FULL_BATCH = 132
WIDE_PLANS = (
    (384, (2, 1024, 1), (2, 1024, 1)),
    (449, (4, 512, 1), (4, 512, 1)),
    (512, (4, 512, 1), (8, 512, 1)),
    (513, (2, 1024, 1), (4, 512, 1)),
    (768, (4, 512, 1), (4, 512, 1)),
    (896, (4, 512, 1), (8, 512, 1)),
    (1024, (8, 512, 1), (8, 512, 1)),
    (1152, (4, 512, 1), (4, 512, 1)),
    (1536, (4, 512, 1), (8, 512, 1)),
    (2048, (8, 512, 1), (16, 256, 1)),
    (3072, (8, 512, 1), (8, 512, 1)),
    (4096, (16, 256, 1), (16, 512, 1)),
    (8192, (16, 512, 1), (16, 512, 1)),
    (16384, (16, 1024, 1), (16, 1024, 1)),
    (32768, (32, 1024, 1), (32, 1024, 1)),
)
# banded_sw_wide_kernel's static shared memory, bytes: the read codes of a
# chunk (RC = 32 uint32), the [2][4][32] float row-parity slots, the best
# cell's three [32] arrays
WIDE_STATIC_SMEM = 32 * 4 + 2 * 4 * 32 * 4 + 3 * 32 * 4
SMEM_PER_BLOCK = 232448  # an H100 block's shared memory at most, bytes


def wide_plan(w: int, bsz: int) -> dict:
    """K1's launch for a band width in (NARROW_MAX_W, MAX_W] and a batch of
    ``bsz`` reads: lanes a thread, threads (ceil(W / (32 lanes)) warps),
    the threads bound and blocks an SM of its instantiation, and its
    shared memory (the chunk's reference codes, (lanes + 1) bytes a thread,
    and the static slots)."""
    if not NARROW_MAX_W < w <= MAX_W:
        raise ValueError(f"band width {w} is not in ({NARROW_MAX_W}, "
                         f"{MAX_W}]")
    if bsz < 1:
        raise ValueError(f"a batch of {bsz} reads")
    _, part, full = next(p for p in WIDE_PLANS if w <= p[0])
    lanes, max_threads, min_blocks = full if bsz >= FULL_BATCH else part
    threads = 32 * -(-w // (32 * lanes))
    return {"lanes": lanes, "threads": threads, "warps": threads // 32,
            "max_threads": max_threads, "min_blocks": min_blocks,
            "smem_bytes": (lanes + 1) * threads + WIDE_STATIC_SMEM}


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
