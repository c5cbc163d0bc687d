# Copied from chip_smoke.py (bound, k1_work, k2_work, k3_work, sort_compares and their constants); counts numpy arrays and shapes instead of card tensors, and adds the tiles that run_battery cuts.
"""The least time the chip could take for a kernel's work: the larger of
the bytes moved (inputs read once, outputs written once) over HBM's
3.35 TB/s and the operations over their peak (f32 67 TFLOP/s; INT32 as
128 lanes x 132 SMs x 1.98 GHz), for one NVIDIA H100 SXM at 700 W."""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# K1's f32 operations a DP cell: F (2 adds, 1 max), diagonal (1 add), Hnoe
# (2 max), Hnoe - ge*k (1 sub), running max (1), E (1 add), H (1 max), the
# extend tests (4 adds, 2 compares), the source (3 compares), the best (1)
K1_OPS_PER_CELL = 20
# K2's integer operations a walk step (decode, automaton, pack)
K2_OPS_PER_STEP = 12
# The battery's least work is a sort-and-merge evaluation: n log2 n
# compares to sort each group, then one merge walk over the n1 + n2 pooled
# values.  Operations a pooled value in the walk: for the KS numerator a
# compare, two multiplies, a subtract, an abs and a max; for the rank and
# tie sums two adds and a multiply.  The milli moments: an add, a
# multiply, a shift and a mask a value.
WALK_KS_OPS = 6
WALK_RANK_OPS = 3
MILLI_MOMENT_OPS = 4


def bound(bytes_moved, f32_ops=0, int_ops=0):
    """(seconds, "bytes" or "operations")."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = max(f32_ops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def k1_work(bsz: int, m: int, w: int) -> dict:
    """K1's bytes (codes and lengths read, the [B, M, W] traceback and the
    three [B] outputs written) and f32 operations."""
    cells = bsz * m * w
    return dict(bytes_moved=bsz * m + bsz * (m + w) + 4 * bsz + cells
                + 12 * bsz, f32_ops=K1_OPS_PER_CELL * cells)


def k2_work(bsz: int, steps: int, code_bytes: int, header=True) -> dict:
    """K2's bytes for walks of ``steps`` steps in all (a traceback byte a
    step, best_i and best_k read, the codes and, with ``header``, 16 bytes
    a read written) and integer operations."""
    return dict(bytes_moved=steps + 8 * bsz + code_bytes
                + (16 * bsz if header else 0),
                int_ops=K2_OPS_PER_STEP * steps)


def sort_compares(n: np.ndarray) -> np.ndarray:
    """n log2 n a group of n values (0 for n <= 1)."""
    n = np.asarray(n, np.float64)
    return (n * np.log2(np.maximum(n, 1))).astype(np.int64)


def k3_work(c1_shape, c2_shape, n1, n2, value_bytes=2, milli=True) -> dict:
    """K3's bytes on one tile (values [P, C1] and [P, C2] and the two
    int32 count rows read, 9 int32 rows written; 3 without the milli
    moments) and the operations of a sort-and-merge evaluation of every
    row; int16 values count at the INT32 peak, f32 at the f32 peak."""
    c1 = np.minimum(np.asarray(n1, np.int64), c1_shape[1])
    c2 = np.minimum(np.asarray(n2, np.int64), c2_shape[1])
    per_value = WALK_KS_OPS + WALK_RANK_OPS + (MILLI_MOMENT_OPS if milli
                                               else 0)
    ops = int((sort_compares(c1) + sort_compares(c2)
               + per_value * (c1 + c2)).sum())
    p = c1_shape[0]
    nbytes = (value_bytes * (c1_shape[0] * c1_shape[1]
                             + c2_shape[0] * c2_shape[1]) + 8 * p
              + (36 if milli else 12) * p)
    return dict(bytes_moved=nbytes,
                **{("int_ops" if value_bytes == 2 else "f32_ops"): ops})


def capacity_bucket(c: int) -> int:
    """A tile's column capacity: its deepest row rounded up to a power of
    two, at least 8 (stats/battery.py:_capacity_bucket)."""
    c = max(int(c), 8)
    return 1 << (c - 1).bit_length()


def battery_bound_s(rows, tile_positions: int) -> float:
    """K3's least time over the tiles that run_battery cuts from joins
    whose per-row counts are ``rows`` [(n1, n2)]: tiles of
    ``tile_positions`` rows (padded to a multiple of 8), each group's
    values int16 in a column capacity of its deepest row's bucket."""
    total = 0.0
    for n1, n2 in rows:
        for lo in range(0, len(n1), tile_positions):
            a = np.asarray(n1[lo:lo + tile_positions])
            b = np.asarray(n2[lo:lo + tile_positions])
            p = -(-len(a) // 8) * 8
            total += bound(**k3_work((p, capacity_bucket(a.max(initial=1))),
                                     (p, capacity_bucket(b.max(initial=1))),
                                     a, b))[0]
    return total
