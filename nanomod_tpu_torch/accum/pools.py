# Copied from nanomod_tpu/accum/pools.py; only the imports differ.
"""Genome-position signal pools: dense, position-major accumulators.

The reference accumulates per-position Python lists in nested dicts —
``moptions[group]['norm_mean'][(chrom,strand)][pos].append(mean)``
(ref bin/scripts/myDetect.py:122-124) — then filters by coverage
(``mfilter_coverage``, :301-314) and joins the two groups on shared
positions (``mtest2``, :427-436).

Here each (chrom, strand) gets a dense pool built in one vectorized pass:

    positions [P] int64   sorted unique genomic coordinates
    values    [P, C] f32  per-position signal reservoir (C = max coverage)
    counts    [P] int32   valid prefix per row
    base      [P] 'U1'    majority reference base at the position

The dense [P, C] layout is what the TPU statistical kernels consume directly
and what gets sharded by genomic coordinate across a device mesh.

Divergence note: the reference's per-position 'base' is last-writer-wins in
file-listing order (myDetect.py:122, os.listdir order); we use a
deterministic majority vote.  Reads disagreeing on the base produce the same
kind of warning the reference prints (myDetect.py:432-434).
"""

from __future__ import annotations

import os
import zlib
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: uniform uint64 hash, vectorized (overflow
    wraps, which is the intended mod-2^64 arithmetic)."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


_BASE_TO_CODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_TO_CODE[_b] = _i
    _BASE_TO_CODE[_b + 32] = _i  # lowercase
_CODE_TO_BASE = np.array(list("ACGTN"))


@dataclass
class PositionPools:
    """Dense per-(chrom,strand) pool."""

    chrom: str
    strand: str
    positions: np.ndarray  # [P] int64
    values: np.ndarray     # [P, C] float32
    counts: np.ndarray     # [P] int32
    base: np.ndarray       # [P] '<U1'

    @property
    def num_positions(self) -> int:
        return len(self.positions)

    @property
    def capacity(self) -> int:
        return self.values.shape[1]

    def filter_min_coverage(self, min_coverage: int) -> "PositionPools":
        """mfilter_coverage (ref myDetect.py:301-314): drop positions with
        fewer than min_coverage observations."""
        keep = self.counts >= min_coverage
        return PositionPools(
            chrom=self.chrom,
            strand=self.strand,
            positions=self.positions[keep],
            values=self.values[keep],
            counts=self.counts[keep],
            base=self.base[keep],
        )


def read_observations(strand: str, start: int, norm_means: np.ndarray,
                      bases: np.ndarray,
                      pos_filter: Tuple[int, int] | None = None):
    """One read's flat observations: (positions int64, means f32,
    base codes int8), using the genomic-coordinate mapping of
    mReadSignalBase (ref myDetect.py:104-124): '+' strand events
    i -> start + i; '-' strand events i -> start + n - 1 - i.
    Shared by PoolBuilder.add_read and the harness's pre-flattened
    mixing-trial path (harness/simulate.FlatReads)."""
    n = len(norm_means)
    if strand == "+":
        pos = start + np.arange(n, dtype=np.int64)
    else:
        pos = start + n - 1 - np.arange(n, dtype=np.int64)
    means = np.asarray(norm_means, dtype=np.float32)
    bases = np.asarray(bases)
    if bases.dtype.kind in "SU":
        codes = _BASE_TO_CODE[
            np.frombuffer(bases.astype("S1").tobytes(), dtype=np.uint8)
        ]
    else:
        codes = np.asarray(bases, dtype=np.int8)
    if pos_filter is not None:
        lo, hi = pos_filter
        keep = (pos >= lo) & (pos <= hi)
        if not keep.all():
            pos, means, codes = pos[keep], means[keep], codes[keep]
    return pos, means, codes


class PoolBuilder:
    """Streaming accumulator: feed per-read event vectors, finalize to pools.

    ``add_read`` matches the genomic-coordinate mapping of mReadSignalBase
    (ref myDetect.py:104-124): '+' strand events i -> start + i; '-' strand
    events i -> start + n - 1 - i.
    """

    def __init__(self):
        # (chrom, strand) -> list of (positions int64[], means f32[], bases int8[])
        self._chunks: Dict[Tuple[str, str], List] = defaultdict(list)

    def add_read(self, chrom: str, strand: str, start: int,
                 norm_means: np.ndarray, bases: np.ndarray,
                 pos_filter: Tuple[int, int] | None = None):
        """bases: byte/char array (S1/U1) aligned with norm_means."""
        pos, means, codes = read_observations(strand, start, norm_means,
                                              bases, pos_filter)
        if len(pos):
            self._chunks[(chrom, strand)].append((pos, means, codes))

    def finalize(self, max_capacity: int = 0, nthreads: int = 0
                 ) -> Dict[Tuple[str, str], PositionPools]:
        """max_capacity > 0 caps the per-position reservoir: positions
        deeper than the cap keep a deterministic random subsample (the RNG
        is seeded per (chrom, strand) group from a stable CRC32 digest, so
        results are reproducible across processes and PYTHONHASHSEED
        values), bounding the dense [P, C] pool at C = max_capacity
        — one skewed ultra-deep position otherwise inflates every row.
        0 = exact (all observations kept; the reference keeps full Python
        lists, ref myDetect.py:122-124)."""
        out = {}
        for (chrom, strand), chunks in sorted(self._chunks.items()):
            pos = np.concatenate([c[0] for c in chunks])
            val = np.concatenate([c[1] for c in chunks])
            cod = np.concatenate([c[2] for c in chunks])
            out[(chrom, strand)] = pack_observations(
                chrom, strand, pos, val, cod, max_capacity=max_capacity,
                nthreads=nthreads)
        return out


def _radix_sort_u64(key: np.ndarray, nthreads: int,
                    hi_byte: int = 0) -> None:
    """In-place ascending sort of a u64 array: native parallel LSD radix
    (native/sort_core.cpp, skips constant key bytes) with numpy fallback.

    hi_byte > 0: the keys group by bytes >= hi_byte (the pool composite
    key: position in the high bits) — radix only those bytes, then sort
    each equal-high run locally (nm_radix_sort_u64_hi): half the random
    scatter passes, measured ~2x at 100M keys."""
    import ctypes

    from nanomod_tpu_torch.native.build import load_native
    lib = load_native("sort_core")
    if lib is None or len(key) < (1 << 16):
        key.sort()
        return
    scratch = np.empty_like(key)
    p = ctypes.POINTER(ctypes.c_uint64)
    if hi_byte > 0 and hasattr(lib, "nm_radix_sort_u64_hi"):
        lib.nm_radix_sort_u64_hi(
            key.ctypes.data_as(p), ctypes.c_int64(len(key)),
            scratch.ctypes.data_as(p), ctypes.c_int(nthreads),
            ctypes.c_int(hi_byte))
        return
    lib.nm_radix_sort_u64(key.ctypes.data_as(p), ctypes.c_int64(len(key)),
                          scratch.ctypes.data_as(p), ctypes.c_int(nthreads))


def _float32_monotone_u32(val: np.ndarray) -> np.ndarray:
    """Order-preserving float32 -> uint32 bijection (IEEE total order;
    -0.0 sorts before +0.0, which is numerically invisible downstream)."""
    u = np.ascontiguousarray(val, dtype=np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))


def _u32_monotone_float32(m: np.ndarray) -> np.ndarray:
    u = np.where(m & np.uint32(0x80000000),
                 m ^ np.uint32(0x80000000), ~m).astype(np.uint32)
    return u.view(np.float32)


def _canonical_sort(pos: np.ndarray, val: np.ndarray, cod: np.ndarray,
                    nthreads: int = 0):
    """Sort observations by (position, value, base code) — the canonical
    in-position order every downstream consumer relies on.

    Fast path: one composite u64 key (29-bit relative position | 32-bit
    monotone float | 3-bit code) sorted range-bucketed on a thread pool
    (numpy's sort releases the GIL), then decoded — ~6x the 3-key lexsort
    that dominated E. coli-scale pool builds (57 s at 210M observations).
    Positions spanning >= 2^29 fall back to the exact lexsort."""
    n = len(pos)
    if n == 0:
        return pos, np.asarray(val, np.float32), np.asarray(cod, np.int8)
    pmin = int(pos.min())
    prange = int(pos.max()) - pmin
    if prange >= (1 << 29):
        order = np.lexsort((cod, val, pos))
        return pos[order], val[order], cod[order]
    key = (((pos - pmin).astype(np.uint64) << np.uint64(35))
           | (_float32_monotone_u32(val).astype(np.uint64) << np.uint64(3))
           | (cod.astype(np.uint64) & np.uint64(7)))
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    _radix_sort_u64(key, nthreads, hi_byte=4)
    pos_s = (key >> np.uint64(35)).astype(np.int64) + pmin
    val_s = _u32_monotone_float32(
        ((key >> np.uint64(3)) & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    cod_s = (key & np.uint64(7)).astype(np.int8)
    return pos_s, val_s, cod_s


def _pack_native(chrom: str, strand: str, pos: np.ndarray, val, cod,
                 max_capacity: int, nthreads: int):
    """Fused native pool build: C++ key build -> numpy SIMD u64 sort ->
    C++ scan + fill (sort_core.cpp nm_pack_*).  The pure-numpy pipeline
    below spends ~45 s per 105M observations in ~30 single-threaded
    elementwise passes; this path does 4 threaded passes around the sort
    (~6 s).  Byte-identical outputs (same key bijection, same canonical
    order, same first-max majority vote).  Returns None when unavailable
    or when the capping path (max_capacity) is needed."""
    import ctypes

    from nanomod_tpu_torch.native.build import load_native
    n = len(pos)
    lib = load_native("sort_core")
    if (lib is None or not hasattr(lib, "nm_pack_key") or n < (1 << 16)
            or max_capacity > 0):
        return None
    pos = np.ascontiguousarray(pos, np.int64)
    pmin = int(pos.min())
    if int(pos.max()) - pmin >= (1 << 29):
        return None
    val = np.ascontiguousarray(val, np.float32)
    cod = np.ascontiguousarray(cod, np.int8)
    key = np.empty(n, np.uint64)
    P = ctypes.POINTER
    lib.nm_pack_key(pos.ctypes.data_as(P(ctypes.c_int64)),
                    val.ctypes.data_as(P(ctypes.c_float)),
                    cod.ctypes.data_as(P(ctypes.c_int8)),
                    ctypes.c_int64(n), ctypes.c_int64(pmin),
                    key.ctypes.data_as(P(ctypes.c_uint64)),
                    ctypes.c_int(nthreads))
    key.sort()                      # numpy SIMD sort: ~1.4 s at 105M keys
    return _native_scan_fill(chrom, strand, key, pmin, lib, nthreads)


def _native_scan_fill(chrom: str, strand: str, key: np.ndarray, pmin: int,
                      lib, nthreads: int) -> PositionPools:
    """Decode SORTED canonical keys into a PositionPools via the native
    scan + fill passes (sort_core.cpp nm_pack_scan/nm_pack_fill)."""
    import ctypes

    n = len(key)
    P = ctypes.POINTER
    cap_out = ctypes.c_int64(0)
    lib.nm_pack_scan.restype = ctypes.c_int64
    p_total = int(lib.nm_pack_scan(key.ctypes.data_as(P(ctypes.c_uint64)),
                                   ctypes.c_int64(n),
                                   ctypes.byref(cap_out)))
    cap = int(cap_out.value)
    uniq = np.empty(p_total, np.int64)
    counts = np.empty(p_total, np.int32)
    values = np.empty((p_total, cap), np.float32)
    base_code = np.empty(p_total, np.uint8)
    lib.nm_pack_fill(key.ctypes.data_as(P(ctypes.c_uint64)),
                     ctypes.c_int64(n), ctypes.c_int64(pmin),
                     ctypes.c_int64(cap),
                     uniq.ctypes.data_as(P(ctypes.c_int64)),
                     counts.ctypes.data_as(P(ctypes.c_int32)),
                     values.ctypes.data_as(P(ctypes.c_float)),
                     base_code.ctypes.data_as(P(ctypes.c_uint8)),
                     ctypes.c_int(nthreads))
    return PositionPools(chrom=chrom, strand=strand, positions=uniq,
                         values=values, counts=counts,
                         base=_CODE_TO_BASE[base_code])


def build_canonical_keys(pos: np.ndarray, val: np.ndarray, cod: np.ndarray,
                         nthreads: int = 0):
    """UNSORTED u64 canonical pool keys for flat observations:
    (pos - pmin) << 35 | monotone(val) << 3 | cod.  Returns (keys, pmin),
    or None when the position span exceeds the 29-bit key budget.

    Sorting these keys ascending IS the canonical observation order of
    pack_observations, so a caller that sorts once can rebuild pools for
    arbitrary observation SUBSETS without re-sorting (the harness's
    mixing trials: sorted-subset gather + k-way merge + pack_sorted_keys).
    """
    import ctypes

    from nanomod_tpu_torch.native.build import load_native
    n = len(pos)
    pos = np.ascontiguousarray(pos, np.int64)
    pmin = int(pos.min()) if n else 0
    if n and int(pos.max()) - pmin >= (1 << 29):
        return None
    val = np.ascontiguousarray(val, np.float32)
    cod = np.ascontiguousarray(cod, np.int8)
    lib = load_native("sort_core")
    if lib is not None and hasattr(lib, "nm_pack_key") and n >= (1 << 14):
        if nthreads <= 0:
            nthreads = os.cpu_count() or 1
        key = np.empty(n, np.uint64)
        P = ctypes.POINTER
        lib.nm_pack_key(pos.ctypes.data_as(P(ctypes.c_int64)),
                        val.ctypes.data_as(P(ctypes.c_float)),
                        cod.ctypes.data_as(P(ctypes.c_int8)),
                        ctypes.c_int64(n), ctypes.c_int64(pmin),
                        key.ctypes.data_as(P(ctypes.c_uint64)),
                        ctypes.c_int(nthreads))
        return key, pmin
    key = (((pos - pmin).astype(np.uint64) << np.uint64(35))
           | (_float32_monotone_u32(val).astype(np.uint64) << np.uint64(3))
           | (cod.astype(np.uint64) & np.uint64(7)))
    return key, pmin


def decode_canonical_keys(key: np.ndarray, pmin: int):
    """Inverse of build_canonical_keys: (pos int64, val f32, cod int8)."""
    pos = (key >> np.uint64(35)).astype(np.int64) + pmin
    val = _u32_monotone_float32(
        ((key >> np.uint64(3)) & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    cod = (key & np.uint64(7)).astype(np.int8)
    return pos, val, cod


def pack_sorted_keys(chrom: str, strand: str, key: np.ndarray, pmin: int,
                     nthreads: int = 0) -> PositionPools:
    """PositionPools from already-SORTED canonical keys — the tail of the
    fused pack with the sort skipped.  Byte-identical to
    pack_observations of the decoded observations."""
    from nanomod_tpu_torch.native.build import load_native
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    lib = load_native("sort_core")
    if lib is not None and hasattr(lib, "nm_pack_scan") and len(key):
        return _native_scan_fill(chrom, strand,
                                 np.ascontiguousarray(key, np.uint64),
                                 pmin, lib, nthreads)
    pos_s, val_s, cod_s = decode_canonical_keys(
        np.asarray(key, np.uint64), pmin)
    return _fill_from_sorted(chrom, strand, pos_s, val_s, cod_s, 0)


def pack_observations(chrom: str, strand: str, pos: np.ndarray,
                      val: np.ndarray, cod: np.ndarray,
                      max_capacity: int = 0,
                      nthreads: int = 0) -> PositionPools:
    """Pack flat (position, value, base-code) observations into one dense
    PositionPools — one vectorized pass: group by position via a sort, slot
    each observation at its rank within its position group.  Shared by
    PoolBuilder.finalize and the multi-host pool merge (parallel/dist.py).

    Within each position, observations are stored in CANONICAL order
    (sorted by value, then base code): the pool for a given observation
    multiset is then identical no matter how reads were sharded across
    hosts or ordered on disk, so every order-sensitive downstream consumer
    — the capped repeated-subsample KS's index draws (stats/kernels.py) and
    the max_capacity subsample below — produces byte-identical results on
    1 host or N.  (The reference's file-listing order is OS-dependent to
    begin with, ref myDetect.py:122; see DIVERGENCES.md.)"""
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    cod = np.asarray(cod)
    if len(cod) and (cod.min() < 0 or cod.max() > 4):
        # codes outside the A/C/G/T/N range would silently diverge between
        # the native majority vote (clamps into the N bucket) and the numpy
        # bincount scatter (ADVICE r4); _BASE_TO_CODE never produces them,
        # so malformed input is an error, not a vote.
        raise ValueError("base codes must be in [0, 4] (A,C,G,T,N)")
    fast = _pack_native(chrom, strand, pos, val, cod, max_capacity, nthreads)
    if fast is not None:
        return fast
    pos_s, val_s, cod_s = _canonical_sort(pos, np.asarray(val, np.float32),
                                          np.asarray(cod, np.int8),
                                          nthreads=nthreads)
    return _fill_from_sorted(chrom, strand, pos_s, val_s, cod_s,
                             max_capacity)


def _fill_from_sorted(chrom: str, strand: str, pos_s, val_s, cod_s,
                      max_capacity: int) -> PositionPools:
    """Dense pool fill from canonically-SORTED flat observations (the
    numpy tail of pack_observations)."""
    # pos_s is sorted: run boundaries come from one diff pass (np.unique
    # would sort AGAIN — at 100M+ observations that second radix sort is
    # tens of seconds)
    if len(pos_s):
        first_idx = np.concatenate(
            [[0], np.flatnonzero(np.diff(pos_s)) + 1])
        uniq = pos_s[first_idx]
        counts = np.diff(np.append(first_idx, len(pos_s)))
    else:
        first_idx = np.empty(0, np.int64)
        uniq = pos_s
        counts = np.empty(0, np.int64)
    p_total = len(uniq)
    cap = int(counts.max(initial=1))
    row = np.repeat(np.arange(p_total), counts)
    slot = np.arange(len(pos_s)) - np.repeat(first_idx, counts)

    if max_capacity > 0 and cap > max_capacity:
        # deterministic per-observation priority, keyed LOCALLY by
        # (chrom:strand, position, canonical slot) via a splitmix64 hash —
        # NOT by array index — so the kept subsample at a position depends
        # only on that position's observation multiset: capping a pool
        # restricted to a position range (the multi-host sharded merge,
        # parallel/shardmerge.py) keeps exactly the same observations the
        # single-host full-key pack keeps.  Keep the max_capacity smallest
        # priorities per position.  (slot occupies 20 bits: per-position
        # depth beyond 2^20 is rejected upstream by the i32 battery bound.)
        seed = np.uint64(zlib.crc32(f"{chrom}:{strand}".encode()))
        prio = _mix64(_mix64(seed ^ pos_s.astype(np.uint64))
                      ^ slot.astype(np.uint64))
        # rank within each position group by priority
        by_prio = np.lexsort((prio, row))
        rank = np.empty(len(pos_s), np.int64)
        rank[by_prio] = (np.arange(len(pos_s))
                         - np.repeat(first_idx, counts))
        keep = rank < max_capacity
        row, val_s, cod_s = row[keep], val_s[keep], cod_s[keep]
        slot = rank[keep]
        counts = np.minimum(counts, max_capacity)
        cap = max_capacity

    values = np.zeros((p_total, cap), dtype=np.float32)
    values[row, slot] = val_s
    # majority base per position (bincount; np.add.at is ~10x slower)
    base_votes = np.bincount(row * 5 + cod_s.astype(np.int64),
                             minlength=p_total * 5).reshape(p_total, 5)
    base = _CODE_TO_BASE[np.argmax(base_votes, axis=1)]

    return PositionPools(
        chrom=chrom,
        strand=strand,
        positions=uniq,
        values=values,
        counts=counts.astype(np.int32),
        base=base,
    )


def join_pools(pools1: Dict, pools2: Dict):
    """Intersect the two groups on shared (chrom, strand, position).

    Yields per (chrom, strand): (positions, idx1, idx2) index arrays into
    each group's pool rows, sorted by (chrom, strand, pos) — the reference's
    iteration order over its sorted dict keys (ref myDetect.py:427-431).
    """
    for key in sorted(set(pools1) & set(pools2)):
        g1, g2 = pools1[key], pools2[key]
        common, i1, i2 = np.intersect1d(
            g1.positions, g2.positions, assume_unique=True, return_indices=True
        )
        if len(common):
            yield key, common, i1, i2


def load_native_available() -> bool:
    """True when the fused native pool build (sort_core nm_pack_*) is up."""
    from nanomod_tpu_torch.native.build import load_native
    lib = load_native("sort_core")
    return lib is not None and hasattr(lib, "nm_pack_key")
