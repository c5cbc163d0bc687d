"""Per-position two-sample test battery, tiled over positions.

Port of nanomod_tpu/stats/battery.py.  Only the raw pools (values + counts)
cross to the device, through pinned, non-blocking copies; the exact integer
components come from kernel K3 (stats/kernels.py) and the float64 p-value
transforms run on the host (stats/special.py).

``backend`` is "device" (K3 on the given device; the default) or "host"
(the native sort_core.cpp battery), chosen by argument or by the
NANOMOD_BATTERY_BACKEND environment variable; an unknown value raises.
The coverage-capped KS (``StatConfig.coverages != (0, 0)``) runs kernel K6
(stats/kernels.capped_ks_d) on the device for both backends, so both draw
the same subsamples.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from nanomod_tpu_torch.config import StatConfig
from nanomod_tpu_torch.device import resolve_device, to_device
from nanomod_tpu_torch.stats import kernels, special
from nanomod_tpu_torch.utils.observe import stage

BACKENDS = ("device", "host")


@dataclass
class TestResult:
    """Per-position results, order-aligned with the caller's position list
    (the reference's sign_test tuples as dense arrays)."""

    __test__ = False   # not a pytest class

    stu: np.ndarray
    pu: np.ndarray
    stt: np.ndarray
    pt: np.ndarray
    stks: np.ndarray
    pks: np.ndarray
    # filled by the caller via combine_neighbor_pvalues when applicable
    stcomb: np.ndarray | None = None
    pcomb: np.ndarray | None = None
    # optional per-group mean/std (--mstd)
    mstd: np.ndarray | None = None

    def __len__(self):
        return len(self.stu)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _check_i32_bounds(counts1, counts2):
    """The exact integer components (KS numerator max|k*n2 - m*n1|, tie
    sums) require n1*n2 < 2^31 and pooled width <= 1290 per position."""
    c1 = int(counts1.max(initial=0))
    c2 = int(counts2.max(initial=0))
    if c1 * c2 >= 2 ** 31 or (c1 + c2) > 1290:
        raise ValueError(
            f"per-position coverage too deep for exact int32 statistics "
            f"(max n1={c1}, n2={c2}); cap the pools with "
            f"--pool_capacity <= 645")


def _capacity_bucket(c: int) -> int:
    """Round a column capacity up to a power of two (min 8)."""
    c = max(c, 8)
    return 1 << (c - 1).bit_length()


def _tile_slice(values, counts, lo, hi, cap, p_tile):
    """[p_tile, cap] tile + [p_tile] i32 counts (content beyond counts is
    ignored by the kernel).  A tile whose values are all exact multiples
    of 0.001 within int16 range is encoded as int16 milli values
    (value*1000), exact and order/tie preserving; otherwise it stays f32."""
    w = min(cap, values.shape[1])
    c = np.zeros(p_tile, dtype=np.int32)
    c[: hi - lo] = np.minimum(counts[lo:hi], cap)
    chunk = values[lo:hi, :w]
    if chunk.dtype != np.int16:
        milli = _milli_values(chunk)
        if milli is not None:
            chunk = milli
    if hi - lo == p_tile and w == cap:
        return np.ascontiguousarray(chunk), c
    v = np.zeros((p_tile, cap), dtype=chunk.dtype)
    v[: hi - lo, :w] = chunk
    return v, c


def _milli_values(chunk: np.ndarray) -> np.ndarray | None:
    """``chunk`` as int16 milli values (value*1000) when every value is an
    exact multiple of 0.001 within int16 range, else None."""
    with np.errstate(invalid="ignore"):
        scaled = chunk * np.float32(1000.0)
        r = np.rint(scaled)
        exact = bool(np.abs(scaled).max(initial=0.0) < 32767.0) and bool(
            (np.abs(scaled - r) < 0.01).all())
    return r.astype(np.int16) if exact else None


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """Start a non-blocking copy of a device tensor into pinned host
    memory; the caller records an event to wait on before reading it."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def to_device_tile(values: np.ndarray, counts: np.ndarray, device):
    """A numpy tile (values [P, C], counts [P]) as the port's tensors on
    ``device`` (pinned, non-blocking copies on CUDA); counts as int32."""
    device = torch.device(device)
    return (to_device(values, device),
            to_device(np.asarray(counts, dtype=np.int32), device))


def finalize_exact_components(ks_num, two_rank_sum, tie_sum, n1, n2,
                              sum1, sumsq1, sum2, sumsq2,
                              cap_np, cov, want_mstd) -> dict:
    """Host float64 finalization from exact integer battery components.

    ks_num/two_rank_sum/tie_sum int32 [P]; sum*/sumsq* exact int64
    milli-domain Σx / Σx²; cap_np the capped-KS numerator (or None); n1/n2
    the TRUE counts.  Returns {stu, pu, stt, pt, stks, pks[, mstd]}.
    """
    n_rows = len(ks_num)
    out = {}
    n1f = n1.astype(np.float64)
    n2f = n2.astype(np.float64)

    u_min, zstat = kernels.mwu_from_components(two_rank_sum, tie_sum, n1, n2)
    out["stu"] = special.clamp_stat(u_min)
    out["pu"] = special.clamp_p(special.mwu_pvalue(zstat))

    t, df, (va1, va2), (m1, m2), (ssx1, ssx2) = \
        kernels.welch_finalize_exact(sum1, sumsq1, n1, sum2, sumsq2, n2)
    out["stt"] = special.clamp_stat(t)
    out["pt"] = special.clamp_p(special.welch_pvalue(t, df))
    if want_mstd:
        mstd = np.empty((n_rows, 4), dtype=np.float64)
        mstd[:, 0] = m1
        mstd[:, 2] = m2
        mstd[:, 1] = np.sqrt(np.maximum(ssx1, 0.0) / np.maximum(n1f, 1))
        mstd[:, 3] = np.sqrt(np.maximum(ssx2, 0.0) / np.maximum(n2f, 1))
        out["mstd"] = mstd

    d_plain = ks_num.astype(np.float64) / (n1f * n2f)
    if cov > 0:
        need_cap = (n1 > cov) | (n2 > cov)
    else:
        need_cap = np.zeros(n_rows, dtype=bool)
    if cap_np is not None and need_cap.any():
        ne1 = np.minimum(n1f, cov)
        ne2 = np.minimum(n2f, cov)
        with np.errstate(divide="ignore", invalid="ignore"):
            d_cap = cap_np.astype(np.float64) / (ne1 * ne2)
        d_sel = np.where(need_cap, d_cap, d_plain)
        p_ks = np.where(
            need_cap,
            special.ks_pvalue(d_cap, ne1, ne2),
            special.ks_pvalue(d_plain, n1f, n2f),
        )
    else:
        d_sel = d_plain
        p_ks = special.ks_pvalue(d_plain, n1f, n2f)
    out["stks"] = special.clamp_stat(d_sel)
    out["pks"] = special.clamp_p(p_ks)
    return out


def finalize_packed(packed: np.ndarray, n_rows: int, n1: np.ndarray,
                    n2: np.ndarray, cap_np: np.ndarray | None, cov: int,
                    is_milli: bool, want_mstd: bool) -> dict:
    """Host float64 finalization of one fetched packed-component block.

    packed [7|9, >=n_rows] from battery_components_packed[_milli]; cap_np
    the capped-KS D (or None); n1/n2 the TRUE counts [n_rows].
    Returns {stu, pu, stt, pt, stks, pks[, mstd]}.
    """
    sl = slice(0, n_rows)
    i32 = lambda row: packed[row].view(np.int32)[sl]
    cap_sl = None if cap_np is None else cap_np[sl]
    if is_milli:
        sq1 = (i32(4).astype(np.int64) << 15) + i32(5)
        sq2 = (i32(7).astype(np.int64) << 15) + i32(8)
        return finalize_exact_components(
            i32(0), i32(1), i32(2), n1, n2,
            i32(3).astype(np.int64), sq1, i32(6).astype(np.int64), sq2,
            cap_sl, cov, want_mstd)

    # f32 tiles: two-pass f32 device moments (~1e-6 relative)
    out = {}
    two_rank_sum = i32(1)
    tie_sum = i32(2)
    n1f = n1.astype(np.float64)
    n2f = n2.astype(np.float64)
    u_min, zstat = kernels.mwu_from_components(two_rank_sum, tie_sum, n1, n2)
    out["stu"] = special.clamp_stat(u_min)
    out["pu"] = special.clamp_p(special.mwu_pvalue(zstat))
    m1, m2 = packed[3][sl], packed[5][sl]
    t, df, (va1, va2) = kernels.welch_finalize(
        m1, packed[4][sl], n1, m2, packed[6][sl], n2)
    out["stt"] = special.clamp_stat(t)
    out["pt"] = special.clamp_p(special.welch_pvalue(t, df))
    if want_mstd:
        mstd = np.empty((n_rows, 4), dtype=np.float64)
        mstd[:, 0] = m1
        mstd[:, 2] = m2
        mstd[:, 1] = np.sqrt(va1 * np.maximum(n1f - 1, 1) / np.maximum(n1f, 1))
        mstd[:, 3] = np.sqrt(va2 * np.maximum(n2f - 1, 1) / np.maximum(n2f, 1))
        out["mstd"] = mstd
    d_plain = i32(0).astype(np.float64) / (n1f * n2f)
    if cov > 0:
        need_cap = (n1 > cov) | (n2 > cov)
    else:
        need_cap = np.zeros(n_rows, dtype=bool)
    if cap_sl is not None and need_cap.any():
        ne1 = np.minimum(n1f, cov)
        ne2 = np.minimum(n2f, cov)
        d_cap = cap_sl.astype(np.float64) / (ne1 * ne2)
        d_sel = np.where(need_cap, d_cap, d_plain)
        p_ks = np.where(
            need_cap,
            special.ks_pvalue(d_cap, ne1, ne2),
            special.ks_pvalue(d_plain, n1f, n2f),
        )
    else:
        d_sel = d_plain
        p_ks = special.ks_pvalue(d_plain, n1f, n2f)
    out["stks"] = special.clamp_stat(d_sel)
    out["pks"] = special.clamp_p(p_ks)
    return out


def resolve_backend(backend: str | None = None) -> str:
    """The battery backend: the argument, else NANOMOD_BATTERY_BACKEND,
    else "device".  Anything but "device" or "host" raises ValueError."""
    if backend is None:
        backend = os.environ.get("NANOMOD_BATTERY_BACKEND", "device")
    if backend not in BACKENDS:
        raise ValueError(f"unknown battery backend {backend!r}; "
                         f"use one of {BACKENDS}")
    return backend


def host_components(values1, counts1, values2, counts2, idx1=None,
                    idx2=None):
    """Exact integer battery components from the native host battery
    (sort_core.cpp nm_battery_milli): dict of ks_num, two_rank_sum,
    tie_sum (int32 [P]) and sum1, sumsq1, sum2, sumsq2 (int64 [P],
    milli domain), or None when the native path cannot be used (values
    fail the milli invariant / unsupported dtype / lib unavailable).
    idx1/idx2 gather battery row r from pool row idx*[r] inside the call."""
    import ctypes

    from nanomod_tpu_torch.native import load_native
    lib = load_native("sort_core")
    if lib is None or not hasattr(lib, "nm_battery_milli"):
        return None
    if values1.dtype == np.int16:
        is_i16 = 1
    elif values1.dtype == np.float32:
        is_i16 = 0
    else:
        return None
    if values2.dtype != values1.dtype:
        return None
    v1 = np.ascontiguousarray(values1)
    v2 = np.ascontiguousarray(values2)
    c1 = np.ascontiguousarray(counts1, dtype=np.int32)
    c2 = np.ascontiguousarray(counts2, dtype=np.int32)
    p = len(c1)
    comp = {k: np.empty(p, np.int32)
            for k in ("ks_num", "two_rank_sum", "tie_sum")}
    comp.update({k: np.empty(p, np.int64)
                 for k in ("sum1", "sumsq1", "sum2", "sumsq2")})
    vp = ctypes.c_void_p
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    def idx_arg(idx):
        if idx is None:
            return ctypes.cast(None, i64p)
        return idx.ctypes.data_as(i64p)

    ix1 = None if idx1 is None else np.ascontiguousarray(idx1, np.int64)
    ix2 = None if idx2 is None else np.ascontiguousarray(idx2, np.int64)
    rc = lib.nm_battery_milli(
        vp(v1.ctypes.data), c1.ctypes.data_as(i32p),
        ctypes.c_int64(v1.shape[1]),
        vp(v2.ctypes.data), c2.ctypes.data_as(i32p),
        ctypes.c_int64(v2.shape[1]),
        ctypes.c_int64(p), ctypes.c_int(is_i16),
        idx_arg(ix1), idx_arg(ix2),
        *(comp[k].ctypes.data_as(i32p)
          for k in ("ks_num", "two_rank_sum", "tie_sum")),
        *(comp[k].ctypes.data_as(i64p)
          for k in ("sum1", "sumsq1", "sum2", "sumsq2")),
        ctypes.c_int(_nthreads()))
    return comp if rc == 0 else None


def milli_components(rows: np.ndarray) -> dict:
    """The [9, P] rows of kernels.battery_rows(milli=True) (int32, or f32
    bitcasts) as the dict that host_components returns."""
    r = np.ascontiguousarray(rows).view(np.int32)
    return {"ks_num": r[0], "two_rank_sum": r[1], "tie_sum": r[2],
            "sum1": r[3].astype(np.int64),
            "sumsq1": (r[4].astype(np.int64) << 15) + r[5],
            "sum2": r[6].astype(np.int64),
            "sumsq2": (r[7].astype(np.int64) << 15) + r[8]}


def _nthreads() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def _quantile_idx(cfg: StatConfig) -> int:
    """The selected repeat, int(downsampling * quantile); a quantile of 1
    takes the last, as the reference's clamped index does."""
    return min(int(cfg.downsampling * cfg.downsampling_quantile),
               cfg.downsampling - 1)


def _capped_ks_numerators(values1, counts1, values2, counts2, cov, cfg,
                          row_offset, tile_positions, device,
                          idx1=None, idx2=None) -> np.ndarray | None:
    """Capped-KS numerators for the rows above the per-strand cap,
    scattered into a full-length int32 array (the other rows stay 0 and
    are never read by the finalizer); None when no row is capped.

    Always computed on ``device`` (K6, or its plain version on a CPU
    device): the draws are keyed per absolute row (``row_offset + row``),
    so host- and device-backend runs draw the same subsamples.  Only the
    capped rows are gathered and shipped.
    """
    idx = np.nonzero((counts1 > cov) | (counts2 > cov))[0]
    if len(idx) == 0:
        return None
    device = resolve_device(device)
    out = np.zeros(len(counts1), dtype=np.int32)
    for lo in range(0, len(idx), tile_positions):
        rows = idx[lo: lo + tile_positions]
        p_tile = _round_up(len(rows), 8)
        g1 = values1[rows if idx1 is None else idx1[rows]]
        g2 = values2[rows if idx2 is None else idx2[rows]]
        n1 = np.zeros(p_tile, np.int32)
        n2 = np.zeros(p_tile, np.int32)
        n1[: len(rows)] = counts1[rows]
        n2[: len(rows)] = counts2[rows]
        v1 = np.zeros((p_tile, g1.shape[1]), g1.dtype)
        v2 = np.zeros((p_tile, g2.shape[1]), g2.dtype)
        v1[: len(rows)] = g1
        v2[: len(rows)] = g2
        row_index = np.zeros(p_tile, np.int32)
        row_index[: len(rows)] = row_offset + rows
        v1d, n1d = to_device_tile(v1, np.maximum(n1, 1), device)
        v2d, n2d = to_device_tile(v2, np.maximum(n2, 1), device)
        cap = kernels.capped_ks_d(
            v1d, n1d, v2d, n2d, to_device(row_index, device), cov=cov,
            repeats=cfg.downsampling, quantile_idx=_quantile_idx(cfg),
            seed=cfg.downsampling_seed)
        out[rows] = cap.cpu().numpy()[: len(rows)]
    return out


def _run_battery_host(values1, counts1, values2, counts2, cov, cfg,
                      want_mstd, row_offset, tile_positions, device,
                      idx1=None, idx2=None):
    """Native host battery: bit-identical exact integer components computed
    on the host (host_components), finalized in float64; the capped KS on
    ``device``.  Returns a TestResult, or None when the native path cannot
    be used."""
    comp = host_components(values1, counts1, values2, counts2, idx1, idx2)
    if comp is None:
        return None
    c1 = np.ascontiguousarray(counts1, dtype=np.int32)
    c2 = np.ascontiguousarray(counts2, dtype=np.int32)
    p = len(c1)
    cap_np = None
    if cov > 0:
        cap_np = _capped_ks_numerators(values1, c1, values2, c2, cov, cfg,
                                       row_offset, tile_positions, device,
                                       idx1=idx1, idx2=idx2)
    nthreads = _nthreads()
    ks, trs, ties = comp["ks_num"], comp["two_rank_sum"], comp["tie_sum"]
    s1, sq1, s2, sq2 = (comp["sum1"], comp["sumsq1"], comp["sum2"],
                        comp["sumsq2"])

    out = {k: np.empty(p, np.float64)
           for k in ("stu", "pu", "stt", "pt", "stks", "pks")}
    mstd = np.empty((p, 4), np.float64) if want_mstd else None

    def fin(lo, hi):
        sl = slice(lo, hi)
        cols = finalize_exact_components(
            ks[sl], trs[sl], ties[sl], c1[sl], c2[sl],
            s1[sl], sq1[sl], s2[sl], sq2[sl],
            None if cap_np is None else cap_np[sl], cov, want_mstd)
        for k in out:
            out[k][sl] = cols[k]
        if want_mstd:
            mstd[sl] = cols["mstd"]

    # rows are independent and the f64 p-transforms release the GIL
    if p > 200_000 and nthreads > 1:
        from concurrent.futures import ThreadPoolExecutor
        bounds = np.linspace(0, p, min(nthreads, 8) * 2 + 1, dtype=np.int64)
        with ThreadPoolExecutor(min(nthreads, 8)) as ex:
            list(ex.map(lambda i: fin(int(bounds[i]), int(bounds[i + 1])),
                        range(len(bounds) - 1)))
    else:
        fin(0, p)
    return TestResult(stu=out["stu"], pu=out["pu"], stt=out["stt"],
                      pt=out["pt"], stks=out["stks"], pks=out["pks"],
                      mstd=mstd)


def run_battery(
    values1: np.ndarray,
    counts1: np.ndarray,
    values2: np.ndarray,
    counts2: np.ndarray,
    strand: str = "+",
    cfg: StatConfig = StatConfig(),
    tile_positions: int = 8192,
    want_mstd: bool = False,
    row_offset: int = 0,
    backend: str | None = None,
    idx1: np.ndarray | None = None,
    idx2: np.ndarray | None = None,
    device="cuda",
) -> TestResult:
    """Run the KS + MWU + Welch-t battery for P positions.

    values* are [P, C*] float32 pools with valid prefix lengths counts* [P]
    int32 (padding content is ignored).  ``backend`` "device" computes the
    exact integer components with K3 on ``device`` (the plain version on a
    CPU device); "host" uses the native host battery.  Both give
    bit-identical statistics.  ``strand`` selects the per-strand coverage
    cap; where a position exceeds it, the capped KS runs K6 on ``device``
    for either backend.  ``row_offset`` is added to the capped KS's row
    index: a caller holding rows [off, off + P) of a larger join draws the
    subsamples the whole join draws for them.  ``idx1``/``idx2`` gather
    battery row r from pool row idx*[r].

    The device backend records its stages on the calling thread (a
    profiler's trace sees only that thread): ``battery.gather`` (the rows
    gathered, bytes), and a tile's ``battery.encode_wait`` (waiting for its
    encode, or the encode itself with one tile), ``battery.dispatch`` (the
    launches and the copy back started; the encoded tiles' bytes),
    ``battery.wait`` (the card's result awaited) and ``battery.finalize``
    (the float64 statistics, positions).
    """
    p_total = len(counts1)
    _check_i32_bounds(counts1, counts2)
    backend = resolve_backend(backend)
    cov = int(cfg.coverages[0 if strand == "+" else 1])
    if backend == "host":
        res = _run_battery_host(values1, counts1, values2, counts2, cov,
                                cfg, want_mstd, row_offset, tile_positions,
                                device, idx1=idx1, idx2=idx2)
        if res is None:
            raise RuntimeError(
                "host battery unavailable: native library 'sort_core' "
                "failed to load, or the pools are not int16/float32")
        return res
    device = resolve_device(device)
    if idx1 is not None or idx2 is not None:
        with stage("battery.gather", unit="bytes") as s:
            if idx1 is not None:
                values1 = values1[idx1]
                s.add(values1.nbytes)
            if idx2 is not None:
                values2 = values2[idx2]
                s.add(values2.nbytes)
    out = {
        k: np.empty(p_total, dtype=np.float64)
        for k in ("stu", "pu", "stt", "pt", "stks", "pks")
    }
    mstd = np.empty((p_total, 4), dtype=np.float64) if want_mstd else None
    on_cuda = device.type == "cuda"

    # Pipelined tiles: encode (milli-int16 rounding + pad copy) and push to
    # the device on a small thread pool, launch in order, and finalize in a
    # BOUNDED window so at most `max_inflight` tiles are resident at once.
    ranges = [(lo, min(lo + tile_positions, p_total))
              for lo in range(0, p_total, tile_positions)]

    def encode(rg):
        """Encode one tile and start its host-to-device copy."""
        lo, hi = rg
        n1 = counts1[lo:hi].astype(np.int32)
        n2 = counts2[lo:hi].astype(np.int32)
        c1 = _capacity_bucket(int(n1.max(initial=1)))
        c2 = _capacity_bucket(int(n2.max(initial=1)))
        p_tile = _round_up(hi - lo, 8)
        v1, cn1 = _tile_slice(values1, counts1, lo, hi, c1, p_tile)
        v2, cn2 = _tile_slice(values2, counts2, lo, hi, c2, p_tile)
        v1d, cn1d = to_device_tile(v1, np.maximum(cn1, 1), device)
        v2d, cn2d = to_device_tile(v2, np.maximum(cn2, 1), device)
        return lo, hi, n1, n2, v1d, cn1d, v2d, cn2d

    def dispatch(enc):
        """Launch the battery for one encoded tile and start the
        non-blocking copy of its packed result back to pinned memory."""
        lo, hi, n1, n2, v1d, cn1d, v2d, cn2d = enc
        with stage("battery.dispatch", unit="bytes") as s:
            s.add(sum(t.nbytes for t in (v1d, cn1d, v2d, cn2d)))
            is_milli = v1d.dtype == torch.int16 and v2d.dtype == torch.int16
            if is_milli:
                comp = kernels.battery_components_packed_milli(
                    v1d, cn1d, v2d, cn2d)
            else:
                comp = kernels.battery_components_packed(v1d, cn1d, v2d,
                                                         cn2d)
            cap = None
            if cov > 0 and bool(((n1 > cov) | (n2 > cov)).any()):
                # the row index keys the draws per absolute row, so they do
                # not depend on tile_positions
                row_index = to_device(np.arange(
                    row_offset + lo, row_offset + lo + len(cn1d),
                    dtype=np.int32), device)
                cap = kernels.capped_ks_d(
                    v1d, cn1d, v2d, cn2d, row_index, cov=cov,
                    repeats=cfg.downsampling,
                    quantile_idx=_quantile_idx(cfg),
                    seed=cfg.downsampling_seed)
            event = None
            if on_cuda:
                comp, cap = (None if t is None else _to_pinned(t)
                             for t in (comp, cap))
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
        return lo, hi, n1, n2, comp, cap, event, is_milli

    def finalize(rec):
        """Wait for one tile's result + host float64 finalization."""
        lo, hi, n1, n2, comp, cap, event, is_milli = rec
        with stage("battery.wait", unit="tiles") as s:
            if event is not None:
                event.synchronize()
            s.add(1)
        with stage("battery.finalize", unit="positions") as s:
            cols = finalize_packed(comp.numpy(), hi - lo, n1, n2,
                                   None if cap is None else cap.numpy(), cov,
                                   is_milli, want_mstd)
            for k in ("stu", "pu", "stt", "pt", "stks", "pks"):
                out[k][lo:hi] = cols[k]
            if want_mstd:
                mstd[lo:hi] = cols["mstd"]
            s.add(hi - lo)

    max_inflight = 8
    if len(ranges) > 1:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(min(4, len(ranges)))
        try:
            enc_futs = deque()
            pending = deque()
            it = iter(ranges)
            submitted = 0
            while True:
                while (len(enc_futs) + len(pending) < max_inflight
                       and submitted < len(ranges)):
                    enc_futs.append(pool.submit(encode, next(it)))
                    submitted += 1
                if enc_futs:
                    with stage("battery.encode_wait", unit="tiles") as s:
                        enc = enc_futs.popleft().result()
                        s.add(1)
                    pending.append(dispatch(enc))
                if (len(pending) >= max_inflight
                        or (not enc_futs and pending)):
                    finalize(pending.popleft())
                if not enc_futs and not pending and submitted == len(ranges):
                    break
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
    else:
        for rg in ranges:
            with stage("battery.encode_wait", unit="tiles") as s:
                enc = encode(rg)
                s.add(1)
            finalize(dispatch(enc))
    return TestResult(**out, mstd=mstd)
