"""Per-position two-sample statistic components on the device.

Port of nanomod_tpu/stats/kernels.py (see there for the pairwise-count
formulation).  For a tile of positions

    values1 [P, C1] int16 milli (value*1000) or f32, counts1 [P] int32
    values2 [P, C2] likewise,                         counts2 [P] int32

(padding beyond the counts is ignored) every rank statistic reduces to
pairwise <= / < counts of each pooled value against each group, exact in
int32.  ``battery_rows`` dispatches on the device of its tensors: the plain
PyTorch version ``battery_rows_plain`` for CPU tensors, kernel K3
(csrc/battery.cu) for CUDA tensors.  ``capped_ks_d``, the coverage-capped
KS, dispatches the same way between ``capped_ks_d_plain`` and kernel K6
(csrc/capped_ks.cu).  The float64 host finalizers
(``mwu_from_components``, ``welch_finalize_exact``, ``welch_finalize``) are
the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from nanomod_tpu_torch.kernels import build as kbuild
from nanomod_tpu_torch.stats import threefry

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


# ---------------------------------------------------------------------------
# Coverage-capped repeated-subsample KS (the reference's capped_ks_d): where
# a group's count exceeds the per-strand cap `cov`, KS is repeated on
# `repeats` subsamples of size cov drawn with replacement, and the
# quantile_idx-th largest numerator is kept.  The draws are jax.random's,
# reproduced bit for bit by stats/threefry.py (plain) and csrc/threefry.cuh
# (kernel K6, csrc/capped_ks.cu).
# ---------------------------------------------------------------------------

# shared memory a block of K6 may use on Hopper (227 KB): the two
# subsamples (min(cov, width) floats a group) and the R numerators
SMEM_LIMIT = 232448


def capped_draws_plain(counts, row_index, *, cov, repeats, seed, group):
    """The subsample indices capped_ks_d draws for one group (0 or 1):
    [P, repeats * cov] int32, row p drawn in [0, max(counts[p], 1))."""
    k1, k2 = threefry.row_keys(seed, row_index)
    key = k1 if group == 0 else k2
    counters = torch.arange(repeats * cov, dtype=torch.int64,
                            device=counts.device)
    span = counts.to(torch.int64).clamp(min=1)[:, None]
    idx = threefry.randint((key[0][:, None], key[1][:, None]),
                           counters[None, :], span)
    return idx.to(torch.int32)


def _subsample(values, counts, row_index, *, cov, repeats, seed, group):
    """[p, repeats, cov] values of one group per repeat: the drawn values
    where the count exceeds cov, else the prefix values[:, :cov]."""
    p_dim = values.shape[0]
    prefix = values[:, :cov][:, None, :].expand(p_dim, repeats, cov)
    capped = counts > cov
    if not bool(capped.any()):
        return prefix
    idx = capped_draws_plain(counts, row_index, cov=cov, repeats=repeats,
                             seed=seed, group=group).to(torch.int64)
    drawn = torch.gather(values, 1, idx).view(p_dim, repeats, cov)
    return torch.where(capped[:, None, None], drawn, prefix)


def _check_capped_args(cov, repeats, quantile_idx):
    if cov < 1:
        raise ValueError(f"cov must be at least 1, got {cov}")
    if repeats < 1:
        raise ValueError(f"repeats must be at least 1, got {repeats}")
    if not 0 <= quantile_idx < repeats:
        raise ValueError(f"quantile_idx must be in [0, {repeats}), "
                         f"got {quantile_idx}")


def capped_ks_d_plain(values1, counts1, values2, counts2, row_index=None, *,
                      cov, repeats, quantile_idx, seed):
    """Plain PyTorch twin of K6, a transcription of the reference's
    capped_ks_d: [P] int32, the quantile_idx-th largest KS numerator over
    ``repeats`` subsamples (effective sizes min(count, cov)).  Counts must
    not exceed the pool widths.  Works in row chunks so the [p, R, cov,
    2 cov] compare tensor stays bounded."""
    _check_capped_args(cov, repeats, quantile_idx)
    v1, v2 = _promote(values1, values2)
    p_dim = v1.shape[0]
    dev = v1.device
    if row_index is None:
        row_index = torch.arange(p_dim, dtype=torch.int32, device=dev)
    # pad to >= cov columns so the prefix is shape-valid (padding is masked)
    if v1.shape[1] < cov:
        v1 = torch.nn.functional.pad(v1, (0, cov - v1.shape[1]))
    if v2.shape[1] < cov:
        v2 = torch.nn.functional.pad(v2, (0, cov - v2.shape[1]))
    n1 = counts1.to(torch.int64)
    n2 = counts2.to(torch.int64)
    col = torch.arange(cov, device=dev)[None, :]
    out = torch.empty(p_dim, dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_CHUNK_ELEMS // (repeats * cov * 2 * cov))
    for lo in range(0, p_dim, step):
        sl = slice(lo, min(lo + step, p_dim))
        a, b, ri = n1[sl], n2[sl], row_index[sl]
        kw = dict(cov=cov, repeats=repeats, seed=seed)
        s1 = _subsample(v1[sl], a, ri, group=0, **kw)
        s2 = _subsample(v2[sl], b, ri, group=1, **kw)
        m1 = (a > cov)[:, None] | (col < a[:, None])
        m2 = (b > cov)[:, None] | (col < b[:, None])
        ne1 = a.clamp(max=cov)[:, None, None]
        ne2 = b.clamp(max=cov)[:, None, None]
        z = torch.cat([s1, s2], dim=2)                       # [p, R, 2 cov]
        le_a = (m1[:, None, :, None] & (s1[..., None] <= z[:, :, None, :])
                ).sum(dim=2)
        le_b = (m2[:, None, :, None] & (s2[..., None] <= z[:, :, None, :])
                ).sum(dim=2)
        num = torch.abs(le_a * ne2 - le_b * ne1)
        validq = torch.cat([m1, m2], dim=1)[:, None, :]
        nums = torch.where(validq, num, 0).amax(dim=2)       # [p, R]
        out[sl] = torch.sort(nums, dim=1, descending=True).values[
            :, quantile_idx].to(torch.int32)
    return out


def capped_ks_d_cuda(values1, counts1, values2, counts2, row_index=None, *,
                     cov, repeats, quantile_idx, seed):
    """Launch K6 on CUDA tensors; same result as capped_ks_d_plain."""
    _check_capped_args(cov, repeats, quantile_idx)
    dev = values1.device
    if dev.type != "cuda":
        raise ValueError(f"capped_ks_d_cuda needs CUDA tensors, got {dev}")
    p_dim = values1.shape[0]
    if row_index is None:
        row_index = torch.arange(p_dim, dtype=torch.int32, device=dev)
    for t in (counts1, values2, counts2, row_index):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
    v1, v2 = _promote(values1, values2)
    if v1.dtype not in (torch.int16, torch.float32):
        raise ValueError(f"values must be int16 or float32, got {v1.dtype}")
    if v1.dim() != 2 or v2.dim() != 2 or v2.shape[0] != p_dim:
        raise ValueError("values must be [P, C1] and [P, C2]")
    if (counts1.shape != (p_dim,) or counts2.shape != (p_dim,)
            or row_index.shape != (p_dim,)):
        raise ValueError("counts and row_index must be [P]")
    if row_index.dtype != torch.int32:
        raise ValueError(f"row_index must be int32, got {row_index.dtype}")
    if repeats * cov >= 2 ** 31:
        raise ValueError("repeats * cov must stay below 2^31")
    smem = 4 * (min(cov, v1.shape[1]) + min(cov, v2.shape[1]) + repeats)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K6 needs {smem} bytes of shared memory a block "
                         f"(cov {cov}, widths {v1.shape[1]} and "
                         f"{v2.shape[1]}, repeats {repeats}): more than the "
                         f"card's {SMEM_LIMIT}")
    v1 = v1.contiguous()
    v2 = v2.contiguous()
    n1 = counts1.to(torch.int32).contiguous()
    n2 = counts2.to(torch.int32).contiguous()
    ri = row_index.contiguous()
    out = torch.empty(p_dim, dtype=torch.int32, device=dev)
    k_hi, k_lo = threefry.prng_key(seed)
    lib = kbuild.lib()
    rc = lib.nm_capped_ks(v1.data_ptr(), n1.data_ptr(), v1.shape[1],
                          v2.data_ptr(), n2.data_ptr(), v2.shape[1],
                          ri.data_ptr(), p_dim, cov, repeats, quantile_idx,
                          k_hi, k_lo, 1 if v1.dtype == torch.int16 else 0,
                          out.data_ptr(), kbuild.stream_ptr(dev))
    kbuild.check(rc, "capped_ks")
    kbuild.LAUNCHES["capped_ks"] += 1
    return out


def capped_draws_cuda(counts, row_index, *, cov, repeats, seed, group):
    """K6's own draws (csrc/capped_ks.cu nm_capped_draws) on CUDA tensors:
    what capped_draws_plain gives.  A check of the kernel's threefry, not
    a step of the main path, so it is not counted in LAUNCHES."""
    dev = counts.device
    if dev.type != "cuda" or row_index.device != dev:
        raise ValueError("capped_draws_cuda needs CUDA tensors on one device")
    if row_index.dtype != torch.int32 or group not in (0, 1):
        raise ValueError("row_index must be int32 and group 0 or 1")
    p_dim = counts.shape[0]
    n = counts.to(torch.int32).contiguous()
    ri = row_index.contiguous()
    out = torch.empty((p_dim, repeats * cov), dtype=torch.int32, device=dev)
    k_hi, k_lo = threefry.prng_key(seed)
    rc = kbuild.lib().nm_capped_draws(n.data_ptr(), ri.data_ptr(), p_dim,
                                      repeats * cov, k_hi, k_lo, group,
                                      out.data_ptr(), kbuild.stream_ptr(dev))
    kbuild.check(rc, "capped_draws")
    return out


def capped_ks_d(values1, counts1, values2, counts2, row_index=None, *, cov,
                repeats, quantile_idx, seed):
    """Capped-KS numerators [P] int32 on the device of ``values1``: the
    plain version for CPU tensors, kernel K6 for CUDA tensors (raises if it
    cannot launch).  ``row_index`` [P] int32 keys each row's draws by its
    absolute row in its (chrom, strand) join, so tiling does not change
    them (default: 0..P-1)."""
    fn = capped_ks_d_plain if values1.device.type == "cpu" else capped_ks_d_cuda
    return fn(values1, counts1, values2, counts2, row_index, cov=cov,
              repeats=repeats, quantile_idx=quantile_idx, seed=seed)


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
