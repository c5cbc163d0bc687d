"""Hard-case tiles for the battery kernels K3 (``battery_rows``, and
``pooled_rank_components`` through K3's pooled entry) and K6
(``capped_ks_d``): the inputs on which a kernel that sorts can go wrong
where one that compares every pair cannot.

    k3_tile(case, p, seed) -> (values1, counts1, values2, counts2)
    pooled_tile(case, seed) -> (z, lab, n1, n2)
    k6_tile(case, p, width, cov, seed) -> (values1, counts1, values2, counts2)

numpy arrays made from ``seed``; values int16 milli (value * 1000) or f32,
counts int32 [P] within the widths.  The tests hold the plain versions to
the JAX package on small tiles and the kernels to their plain versions on
the card; chip_smoke.py runs them as whole tiles at the main path's shapes.

K3 cases (widths from ``K3_WIDTHS``):
    nan_prefix    f32, NaN inside the valid prefix of either group (rows
                  with every valid value NaN in one or both groups)
    signed_zero   f32, -0.0 and +0.0 in both groups (they compare equal)
    all_equal     every value of a row equal, in both groups
    one_distinct  one distinct value a group (equal, below or above)
    counts_01     counts 0 and 1 only
    deep_645      645 + 645 milli values in a capacity of 1,024 a group
    warp_edge     pooled width 256 (128 + 128), full rows: the widest tile
                  of K3's one-warp-a-row variant
    block_edge    pooled width 257 (129 + 128), full rows: the narrowest
                  tile of its one-block-a-row variant

Pooled cases (z, lab [P, N] f32, n1, n2 [P] f32; shapes from
``POOLED_SHAPES``; values with heavy ties, +inf pads):
    random        the sharded demo step's layout, n1/n2 the groups' counts
    empty_group1  group 1 (or 2) empty on some rows, n = max(count, 1)
    counts_differ n1/n2 off the groups' counts: above, below, 0 (d inf or
                  NaN) and fractional (truncated in the KS term only)
    nan_neginf    NaN (a pad) and -inf (valid) in z, -0.0 and +0.0, NaN
                  labels (in neither group) and labels of exactly 0.5
    width_1       N = 1
    width_256     N = 256, the widest row of the one-warp-a-row variant
    width_257     N = 257, the narrowest of the one-block-a-row variant
    no_rows       P = 0

K6 cases (``cov`` the cap):
    nan_prefix    f32, NaN inside the valid prefix of either group
    signed_zero   f32, -0.0 and +0.0 in both groups
    one_run       every value of a row equal: one tie run (k = 1)
    all_distinct  every value of a row distinct, across the groups
    counts_01     counts 0, 1, cov and cov + 1
    under_over    one group under cov, the other over it
"""

from __future__ import annotations

import numpy as np

K3_WIDTHS = {
    "nan_prefix": (128, 128), "signed_zero": (128, 128),
    "all_equal": (128, 128), "one_distinct": (128, 128),
    "counts_01": (128, 128), "deep_645": (1024, 1024),
    "warp_edge": (128, 128), "block_edge": (129, 128),
}
K3_CASES = tuple(K3_WIDTHS)
K6_CASES = ("nan_prefix", "signed_zero", "one_run", "all_distinct",
            "counts_01", "under_over")
F32_CASES = ("nan_prefix", "signed_zero")
POOLED_SHAPES = {
    "random": (200, 64), "empty_group1": (64, 32), "counts_differ": (64, 48),
    "nan_neginf": (64, 40), "width_1": (50, 1), "width_256": (24, 256),
    "width_257": (24, 257), "no_rows": (0, 16),
}
POOLED_CASES = tuple(POOLED_SHAPES)


def _milli(rng, shape, levels):
    return (rng.integers(-levels, levels + 1, shape) * 25).astype(np.int16)


def _signed_zeros(rng, shape):
    pick = np.array([-0.0, 0.0, -0.001, 0.001, 0.5], np.float32)
    return pick[rng.integers(0, len(pick), shape)]


def _nan_inside(rng, v, n):
    """NaN at ~10 % of the valid entries of ``v`` (counts ``n``)."""
    valid = np.arange(v.shape[1])[None, :] < n[:, None]
    v[valid & (rng.random(v.shape) < 0.1)] = np.nan
    return v


def k3_tile(case: str, p: int, seed: int = 0):
    """One K3 hard case: (values1, counts1, values2, counts2)."""
    rng = np.random.default_rng(seed)
    c1, c2 = K3_WIDTHS[case]
    n1 = rng.integers(0, c1 + 1, p).astype(np.int32)
    n2 = rng.integers(0, c2 + 1, p).astype(np.int32)
    if case == "nan_prefix":
        v1 = (_milli(rng, (p, c1), 20) / np.float32(1000)).astype(np.float32)
        v2 = (_milli(rng, (p, c2), 20) / np.float32(1000)).astype(np.float32)
        v1 = _nan_inside(rng, v1, n1)
        v2 = _nan_inside(rng, v2, n2)
        v1[0] = v2[1] = np.nan
        v1[2] = v2[2] = np.nan
    elif case == "signed_zero":
        v1 = _signed_zeros(rng, (p, c1))
        v2 = _signed_zeros(rng, (p, c2))
    elif case == "all_equal":
        level = _milli(rng, (p, 1), 40)
        v1 = np.repeat(level, c1, axis=1)
        v2 = np.repeat(level, c2, axis=1)
    elif case == "one_distinct":
        a = _milli(rng, (p, 1), 2)
        b = _milli(rng, (p, 1), 2)
        v1 = np.repeat(a, c1, axis=1)
        v2 = np.repeat(b, c2, axis=1)
    elif case == "counts_01":
        v1 = _milli(rng, (p, c1), 3)
        v2 = _milli(rng, (p, c2), 3)
        n1 = rng.integers(0, 2, p).astype(np.int32)
        n2 = rng.integers(0, 2, p).astype(np.int32)
    elif case == "deep_645":
        v1 = _milli(rng, (p, c1), 10)
        v2 = _milli(rng, (p, c2), 10)
        n1 = rng.integers(600, 646, p).astype(np.int32)
        n2 = rng.integers(600, 646, p).astype(np.int32)
        n1[: p // 2] = 645
        n2[: p // 2] = 645
    else:  # warp_edge, block_edge: full rows at the variant's edge
        v1 = _milli(rng, (p, c1), 40)
        v2 = _milli(rng, (p, c2), 40)
        n1[: (3 * p) // 4] = c1
        n2[: (3 * p) // 4] = c2
    return v1, n1, v2, n2


def pooled_tile(case: str, seed: int = 0):
    """One pooled case: (z, lab, n1, n2)."""
    rng = np.random.default_rng(seed)
    p, n = POOLED_SHAPES[case]
    z = (_milli(rng, (p, n), 20) / np.float32(1000)).astype(np.float32)
    z[rng.random((p, n)) < 0.2] = np.inf
    lab = (rng.random((p, n)) < 0.5).astype(np.float32)
    if case == "empty_group1":
        lab[::2] = 0.0
        lab[1::4] = 1.0
    elif case == "nan_neginf":
        pick = rng.random((p, n))
        z[pick < 0.1] = np.nan
        z[(pick >= 0.1) & (pick < 0.2)] = -np.inf
        z[(pick >= 0.2) & (pick < 0.3)] = -0.0
        z[(pick >= 0.3) & (pick < 0.35)] = 0.0
        z[0] = -np.inf
        z[1] = np.nan
        mark = rng.random((p, n))
        lab[mark < 0.1] = np.nan
        lab[(mark >= 0.1) & (mark < 0.2)] = 0.5
    valid = z < np.inf
    n1 = (valid & (lab > 0.5)).sum(1).astype(np.float32)
    n2 = (valid & (lab <= 0.5)).sum(1).astype(np.float32)
    if case == "empty_group1":
        n1, n2 = np.maximum(n1, 1), np.maximum(n2, 1)
    elif case == "counts_differ":
        n1 = np.maximum(n1 + rng.integers(-3, 4, p), 0).astype(np.float32)
        n2 = np.maximum(n2 + rng.integers(-3, 4, p), 0).astype(np.float32)
        n1[::5] += np.float32(0.75)
        n2[1::7] = 0.0
        n1[2::7] = 0.0
        z[3] = np.inf                  # no member: 0 / 0
        n1[3] = 0.0
    return z, lab, n1, n2


def k6_tile(case: str, p: int, width: int, cov: int, seed: int = 0):
    """One K6 hard case at pools of ``width`` columns a group."""
    rng = np.random.default_rng(seed)
    w = width
    n1 = rng.integers(0, w + 1, p).astype(np.int32)
    n2 = rng.integers(0, w + 1, p).astype(np.int32)
    if case == "nan_prefix":
        v1 = (_milli(rng, (p, w), 30) / np.float32(1000)).astype(np.float32)
        v2 = (_milli(rng, (p, w), 30) / np.float32(1000)).astype(np.float32)
        v1 = _nan_inside(rng, v1, n1)
        v2 = _nan_inside(rng, v2, n2)
        v1[0] = v2[1] = np.nan
    elif case == "signed_zero":
        v1 = _signed_zeros(rng, (p, w))
        v2 = _signed_zeros(rng, (p, w))
    elif case == "one_run":
        level = _milli(rng, (p, 1), 40)
        v1 = np.repeat(level, w, axis=1)
        v2 = np.repeat(level, w, axis=1)
    elif case == "all_distinct":
        # 2 w distinct milli values a row, shuffled over the two groups
        pool = np.stack([rng.permutation(2 * w) for _ in range(p)])
        pool = ((pool - w) * 7).astype(np.int16)
        v1, v2 = pool[:, :w].copy(), pool[:, w:].copy()
    else:
        v1 = _milli(rng, (p, w), 30)
        v2 = _milli(rng, (p, w), 30)
        if case == "counts_01":
            edge = np.array([0, 1, min(cov, w), min(cov + 1, w)], np.int32)
            n1 = edge[rng.integers(0, 4, p)]
            n2 = edge[rng.integers(0, 4, p)]
        elif case == "under_over":
            over = rng.integers(min(cov + 1, w), w + 1, p).astype(np.int32)
            under = rng.integers(0, min(cov, w) + 1, p).astype(np.int32)
            flip = rng.random(p) < 0.5
            n1 = np.where(flip, over, under).astype(np.int32)
            n2 = np.where(flip, under, over).astype(np.int32)
        else:
            raise ValueError(f"unknown K6 case {case!r}")
    return v1, n1, v2, n2
