"""Per-position two-sample statistic components on the device.

Port of nanomod_tpu/stats/kernels.py (see there for the pairwise-count
formulation).  For a tile of positions

    values1 [P, C1] int16 milli (value*1000) or f32, counts1 [P] int32
    values2 [P, C2] likewise,                         counts2 [P] int32

(padding beyond the counts is ignored) every rank statistic reduces to
pairwise <= / < counts of each pooled value against each group, exact in
int32.  ``battery_rows`` dispatches on the device of its tensors: the plain
PyTorch version ``battery_rows_plain`` for CPU tensors, kernel K3
(csrc/battery.cu) for CUDA tensors.  The float64 host finalizers
(``mwu_from_components``, ``welch_finalize_exact``, ``welch_finalize``) are
the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from nanomod_tpu_torch.kernels import build as kbuild

# compare elements per chunk of the plain version (bounds its memory)
_PLAIN_CHUNK_ELEMS = 1 << 25


def _masks(values1, counts1, values2, counts2):
    c1 = values1.shape[1]
    c2 = values2.shape[1]
    dev = values1.device
    mask1 = torch.arange(c1, device=dev)[None, :] < counts1[:, None]
    mask2 = torch.arange(c2, device=dev)[None, :] < counts2[:, None]
    return mask1, mask2


def _promote(values1, values2):
    """Both groups in one comparable dtype, as the reference's concatenate
    promotes them (int16 with f32 -> f32)."""
    if values1.dtype != values2.dtype:
        return values1.to(torch.float32), values2.to(torch.float32)
    return values1, values2


def _pairwise_counts(vals, mask, z):
    """le/lt counts [P, N] int32 of the masked rows of ``vals`` against the
    queries ``z`` (the reference's _pairwise_counts)."""
    vj = vals[:, :, None]
    zq = z[:, None, :]
    m = mask[:, :, None]
    le = (m & (vj <= zq)).sum(dim=1, dtype=torch.int32)
    lt = (m & (vj < zq)).sum(dim=1, dtype=torch.int32)
    return le, lt


def _pairwise_components(values1, mask1, values2, mask2, n1i, n2i):
    """(ks_num, two_rank_sum, tie_sum) int32 [P] (the reference's
    _pairwise_components)."""
    z = torch.cat([values1, values2], dim=1)
    validq = torch.cat([mask1, mask2], dim=1)
    le_a, lt_a = _pairwise_counts(values1, mask1, z)
    le_b, lt_b = _pairwise_counts(values2, mask2, z)
    num = torch.abs(le_a * n2i[:, None] - le_b * n1i[:, None])
    zero = torch.zeros((), dtype=torch.int32, device=z.device)
    d_num = torch.where(validq, num, zero).amax(dim=1)
    cnt_le = le_a + le_b
    cnt_lt = lt_a + lt_b
    g1q = torch.cat([mask1, torch.zeros_like(mask2)], dim=1)
    two_rank_sum = torch.where(g1q, cnt_lt + cnt_le + 1, zero).sum(
        dim=1, dtype=torch.int32)
    t_run = cnt_le - cnt_lt
    tie_sum = torch.where(validq, t_run * t_run - 1, zero).sum(
        dim=1, dtype=torch.int32)
    return d_num, two_rank_sum, tie_sum


def _milli_exact_sums(values_i16, mask):
    """Exact Σx, Σ(x² >> 15), Σ(x² & 0x7fff) in int32 (the reference's
    _milli_exact_sums)."""
    v = torch.where(mask, values_i16.to(torch.int32),
                    torch.zeros((), dtype=torch.int32,
                                device=values_i16.device))
    sq = v * v
    return (v.sum(dim=1, dtype=torch.int32),
            (sq >> 15).sum(dim=1, dtype=torch.int32),
            (sq & 0x7FFF).sum(dim=1, dtype=torch.int32))


def battery_rows_plain(values1, counts1, values2, counts2, *, milli: bool):
    """Plain PyTorch twin of K3: [9, P] int32 rows (milli) or the first
    three, in the order of battery_components_packed_milli.  Works in row
    chunks so the [P, C, N] compare tensor stays bounded."""
    v1, v2 = _promote(values1, values2)
    p_dim, c1 = v1.shape
    c2 = v2.shape[1]
    n1i = counts1.to(torch.int32)
    n2i = counts2.to(torch.int32)
    mask1, mask2 = _masks(v1, n1i, v2, n2i)
    nrows = 9 if milli else 3
    out = torch.empty((nrows, p_dim), dtype=torch.int32, device=v1.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, max(c1, c2) * (c1 + c2)))
    for lo in range(0, p_dim, step):
        sl = slice(lo, min(lo + step, p_dim))
        rows = list(_pairwise_components(v1[sl], mask1[sl], v2[sl],
                                         mask2[sl], n1i[sl], n2i[sl]))
        if milli:
            rows += _milli_exact_sums(v1[sl], mask1[sl])
            rows += _milli_exact_sums(v2[sl], mask2[sl])
        out[:, sl] = torch.stack(rows)
    return out


def battery_rows_cuda(values1, counts1, values2, counts2, *, milli: bool):
    """Launch K3 on CUDA tensors; same result as battery_rows_plain."""
    dev = values1.device
    if dev.type != "cuda":
        raise ValueError(f"battery_rows_cuda needs CUDA tensors, got {dev}")
    for t in (counts1, values2, counts2):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
    v1, v2 = _promote(values1, values2)
    if v1.dtype not in (torch.int16, torch.float32):
        raise ValueError(f"values must be int16 or float32, got {v1.dtype}")
    if milli and v1.dtype != torch.int16:
        raise ValueError("milli rows need int16 values")
    if v1.dim() != 2 or v2.dim() != 2 or v1.shape[0] != v2.shape[0]:
        raise ValueError("values must be [P, C1] and [P, C2]")
    p_dim, c1 = v1.shape
    c2 = v2.shape[1]
    if counts1.shape != (p_dim,) or counts2.shape != (p_dim,):
        raise ValueError("counts must be [P]")
    if c1 + c2 > 8192:
        raise ValueError(f"pooled width {c1 + c2} exceeds the kernel's "
                         f"shared-memory stage (8192)")
    v1 = v1.contiguous()
    v2 = v2.contiguous()
    n1 = counts1.to(torch.int32).contiguous()
    n2 = counts2.to(torch.int32).contiguous()
    out = torch.empty((9 if milli else 3, p_dim), dtype=torch.int32,
                      device=dev)
    lib = kbuild.lib()
    rc = lib.nm_battery(v1.data_ptr(), n1.data_ptr(), c1, v2.data_ptr(),
                        n2.data_ptr(), c2, p_dim,
                        1 if v1.dtype == torch.int16 else 0,
                        1 if milli else 0, out.data_ptr(),
                        kbuild.stream_ptr(dev))
    kbuild.check(rc, "battery")
    kbuild.LAUNCHES["battery"] += 1
    return out


def battery_rows(values1, counts1, values2, counts2, *, milli: bool):
    """Battery rows on the device of ``values1``: the plain version for CPU
    tensors, kernel K3 for CUDA tensors (raises if it cannot launch)."""
    if values1.device.type == "cpu":
        return battery_rows_plain(values1, counts1, values2, counts2,
                                  milli=milli)
    return battery_rows_cuda(values1, counts1, values2, counts2, milli=milli)


def battery_components_packed_milli(values1, counts1, values2, counts2):
    """[9, P] f32 whose every row is an exact int32 bitcast to f32, as the
    reference's battery_components_packed_milli: 0 ks_num, 1
    two_rank_sum, 2 tie_sum, 3 sum1, 4 sumsq1_hi, 5 sumsq1_lo, 6 sum2,
    7 sumsq2_hi, 8 sumsq2_lo."""
    return battery_rows(values1, counts1, values2, counts2,
                        milli=True).view(torch.float32)


def battery_components_packed(values1, counts1, values2, counts2):
    """[7, P] f32, as the reference's battery_components_packed: rows 0-2
    (ks_num, two_rank_sum, tie_sum) exact int32 bitcast to f32 (from K3 on
    CUDA), then two-pass f32 Welch moments mean1, ss1, mean2, ss2 in plain
    PyTorch (sums in another order than XLA's: agree to ~1e-6 relative)."""
    ranks = battery_rows(values1, counts1, values2, counts2, milli=False)
    mask1, mask2 = _masks(values1, counts1, values2, counts2)
    f32 = torch.float32
    if values1.dtype == torch.int16:
        values1 = values1.to(f32) * 1e-3
    if values2.dtype == torch.int16:
        values2 = values2.to(f32) * 1e-3
    zero = torch.zeros((), dtype=f32, device=values1.device)
    n1f = counts1.to(f32)
    n2f = counts2.to(f32)
    m1 = torch.where(mask1, values1, zero).sum(dim=1) / n1f.clamp(min=1.0)
    m2 = torch.where(mask2, values2, zero).sum(dim=1) / n2f.clamp(min=1.0)
    ss1 = torch.where(mask1, (values1 - m1[:, None]) ** 2, zero).sum(dim=1)
    ss2 = torch.where(mask2, (values2 - m2[:, None]) ** 2, zero).sum(dim=1)
    return torch.cat([ranks.view(f32),
                      torch.stack([m1.to(f32), ss1, m2.to(f32), ss2])])


def welch_finalize_exact(sum1, sumsq1, n1, sum2, sumsq2, n2):
    """Host float64 Welch t + df + means from exact milli-domain sums.

    sum*/sumsq* are exact int64 Σx / Σx² in the milli (value*1000) domain.
    Returns (t, df, (v1, v2), (mean1, mean2), (ss1, ss2))."""
    n1 = n1.astype(np.float64)
    n2 = n2.astype(np.float64)
    s1 = sum1.astype(np.float64)
    s2 = sum2.astype(np.float64)
    sq1 = np.asarray(sumsq1).astype(np.float64)
    sq2 = np.asarray(sumsq2).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean1 = s1 / (1e3 * n1)
        mean2 = s2 / (1e3 * n2)
        # Σ(x-x̄)² = Σx² - (Σx)²/n, exact integer sums -> f64 ops only
        ss1 = (sq1 - s1 * s1 / n1) / 1e6
        ss2 = (sq2 - s2 * s2 / n2) / 1e6
    v1 = np.maximum(ss1, 0.0) / np.maximum(n1 - 1.0, 1.0)
    v2 = np.maximum(ss2, 0.0) / np.maximum(n2 - 1.0, 1.0)
    vn1 = v1 / n1
    vn2 = v2 / n2
    with np.errstate(divide="ignore", invalid="ignore"):
        df = (vn1 + vn2) ** 2 / (vn1 ** 2 / (n1 - 1.0) + vn2 ** 2 / (n2 - 1.0))
        t = (mean1 - mean2) / np.sqrt(vn1 + vn2)
    df = np.where(np.isnan(df), 1.0, df)
    return t, df, (v1, v2), (mean1, mean2), (ss1, ss2)


def mwu_from_components(two_rank_sum, tie_sum, n1, n2):
    """Host-side float64 Mann-Whitney U from device components (scipy 1.2.1
    mannwhitneyu defaults; z = NaN for degenerate pools, p = 1.0 later)."""
    n1 = n1.astype(np.float64)
    n2 = n2.astype(np.float64)
    r1 = two_rank_sum.astype(np.float64) / 2.0
    u1 = n1 * n2 + n1 * (n1 + 1.0) / 2.0 - r1
    u2 = n1 * n2 - u1
    nt = n1 + n2
    with np.errstate(divide="ignore", invalid="ignore"):
        t_corr = 1.0 - tie_sum.astype(np.float64) / (nt ** 3 - nt)
    sd = np.sqrt(t_corr * n1 * n2 * (nt + 1.0) / 12.0)
    meanrank = n1 * n2 / 2.0 + 0.5
    bigu = np.maximum(u1, u2)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (bigu - meanrank) / sd
    z = np.where(sd == 0, np.nan, z)
    return np.minimum(u1, u2), z


def welch_finalize(mean1, ss1, n1, mean2, ss2, n2):
    """Host float64 Welch t + df from device f32 moments (scipy
    ttest_ind(equal_var=False): ddof=1, df := 1 where undefined)."""
    n1 = n1.astype(np.float64)
    n2 = n2.astype(np.float64)
    v1 = ss1.astype(np.float64) / np.maximum(n1 - 1.0, 1.0)
    v2 = ss2.astype(np.float64) / np.maximum(n2 - 1.0, 1.0)
    vn1 = v1 / n1
    vn2 = v2 / n2
    with np.errstate(divide="ignore", invalid="ignore"):
        df = (vn1 + vn2) ** 2 / (vn1 ** 2 / (n1 - 1.0) + vn2 ** 2 / (n2 - 1.0))
        t = (mean1.astype(np.float64) - mean2.astype(np.float64)) / np.sqrt(vn1 + vn2)
    df = np.where(np.isnan(df), 1.0, df)
    return t, df, (v1, v2)
