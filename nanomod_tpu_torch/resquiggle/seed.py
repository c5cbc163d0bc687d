# Copied from nanomod_tpu/resquiggle/seed.py; only the imports differ.
"""K-mer seeding: find the (chrom, strand, diagonal) band for each read.

Replaces the seeding/chaining role of bwa/minimap2 (ref
myRefBaseSignalAnnotation.py:406-417).  The reference genome is known and
indexed once (sorted k-mer codes); each read votes for diagonals via exact
k-mer hits, and the densest diagonal window wins.  The banded DP
(resquiggle/banded.py) then refines within ±band/2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from nanomod_tpu_torch.io.fasta import revcomp

_CODE = np.full(256, 4, dtype=np.int64)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b + 32] = _i


def encode(seq: str) -> np.ndarray:
    """ACGT -> 0..3, other -> 4."""
    return _CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]


def _kmer_codes(codes: np.ndarray, k: int,
                stride: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """K-mer integer codes at read offsets 0, stride, 2*stride, ...;
    k-mers containing non-ACGT get -1.  Returns (codes, offsets)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    offs = np.arange(0, n, stride, dtype=np.int64)
    out = np.zeros(len(offs), dtype=np.int64)
    bad = np.zeros(len(offs), dtype=bool)
    for j in range(k):
        c = codes[offs + j] if stride > 1 else codes[j: j + n]
        out = out * 4 + np.where(c > 3, 0, c)
        bad |= c > 3
    return np.where(bad, -1, out), offs


@dataclass
class SeedHit:
    chrom: str
    strand: str           # '+' | '-'
    diag: int             # ref_pos - fwd_read_pos (band center offset)
    votes: int


class SeedIndex:
    """Sorted k-mer index over all chromosomes of a FASTA."""

    def __init__(self, seqs: Dict[str, str], k: int = 12,
                 max_hits_per_kmer: int = 64):
        self.k = k
        self.max_hits = max_hits_per_kmer
        self.chrom_names = list(seqs)
        self.chrom_offsets = {}
        codes_all = []
        pos_all = []
        offset = 0
        self._bounds = []     # (start_offset, end_offset, name)
        for name in self.chrom_names:
            seq = seqs[name]
            kc, _ = _kmer_codes(encode(seq), k)
            valid = kc >= 0
            codes_all.append(kc[valid])
            pos_all.append(np.flatnonzero(valid) + offset)
            self.chrom_offsets[name] = offset
            self._bounds.append((offset, offset + len(seq), name))
            offset += len(seq) + k  # k-gap prevents cross-chrom kmers
        codes = np.concatenate(codes_all) if codes_all else np.empty(0, np.int64)
        pos = np.concatenate(pos_all) if pos_all else np.empty(0, np.int64)
        order = np.argsort(codes, kind="stable")
        self.sorted_codes = codes[order]
        self.sorted_pos = pos[order]

    def _chrom_of(self, gpos: int):
        for lo, hi, name in self._bounds:
            if lo <= gpos < hi:
                return name, lo
        return None, 0

    # sampled k-mers per strand: with a vote threshold of 3 and ~70% k-mer
    # survival at 3% error, ~256 samples are two orders of magnitude more
    # than needed to call the band — and searchsorted over every k-mer of a
    # 2 kb read was the dominant prepare cost (measured 1.2 ms/read)
    TARGET_SAMPLES = 256

    def _diag_votes(self, read_codes_str: str):
        codes = encode(read_codes_str)
        n_kmers = len(codes) - self.k + 1
        stride = max(1, n_kmers // self.TARGET_SAMPLES)
        kc, offs = _kmer_codes(codes, self.k, stride=stride)
        sel_valid = kc >= 0
        valid = offs[sel_valid]
        if len(valid) == 0 or len(self.sorted_codes) == 0:
            return None
        q = kc[sel_valid]
        lo = np.searchsorted(self.sorted_codes, q, side="left")
        hi = np.searchsorted(self.sorted_codes, q, side="right")
        counts = hi - lo
        keep = (counts > 0) & (counts <= self.max_hits)
        if not keep.any():
            return None
        # vectorized flat gather of all seed hits
        sel = np.flatnonzero(keep)
        cnt = counts[sel]
        offs = np.concatenate([[0], np.cumsum(cnt)])
        flat = (np.arange(offs[-1]) - np.repeat(offs[:-1], cnt)
                + np.repeat(lo[sel], cnt))
        refs = self.sorted_pos[flat]
        return refs - np.repeat(valid[sel], cnt)

    def best_bands_native(self, seqs, band_slack: int = 48,
                          nthreads: int = 4):
        """Batch best_band on the C++ thread pool (native/seed_core.cpp);
        returns [SeedHit|None] per sequence, or None when the native lib is
        unavailable (callers fall back to per-read best_band)."""
        import ctypes

        from nanomod_tpu_torch.native import load_native
        lib = load_native("seed_core")
        if lib is None or not seqs:
            return None
        n = len(seqs)
        cat = "".join(seqs).encode()
        offs = np.zeros(n + 1, np.int64)
        np.cumsum([len(s) for s in seqs], out=offs[1:])
        strand = np.empty(n, "S1")
        center = np.empty(n, np.int64)
        votes = np.empty(n, np.int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.nm_seed_batch(
            ctypes.c_char_p(cat), offs.ctypes.data_as(i64p),
            ctypes.c_int64(n),
            self.sorted_codes.ctypes.data_as(i64p),
            self.sorted_pos.ctypes.data_as(i64p),
            ctypes.c_int64(len(self.sorted_codes)),
            ctypes.c_int(self.k), ctypes.c_int(self.max_hits),
            ctypes.c_int(self.TARGET_SAMPLES), ctypes.c_int(band_slack),
            ctypes.c_int(nthreads),
            strand.ctypes.data_as(ctypes.c_char_p),
            center.ctypes.data_as(i64p),
            votes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        out = []
        for i in range(n):
            if strand[i] == b"?":
                out.append(None)
                continue
            chrom, off = self._chrom_of(max(int(center[i]), 0))
            if chrom is None:
                out.append(None)
                continue
            out.append(SeedHit(chrom=chrom, strand=strand[i].decode(),
                               diag=int(center[i]) - off,
                               votes=int(votes[i])))
        return out

    def best_band(self, read_seq: str, band_slack: int = 48) -> Optional[SeedHit]:
        """Best (chrom, strand, diagonal) by clustered seed votes.

        Diagonals within ±band_slack are pooled so indel drift still counts
        toward the same band.
        """
        best = None
        for strand, seq in (("+", read_seq), ("-", revcomp(read_seq))):
            diags = self._diag_votes(seq)
            if diags is None or len(diags) == 0:
                continue
            diags.sort()
            # densest window of width 2*band_slack, vectorized: for each
            # right endpoint i the left edge is searchsorted(d_i - 2*slack)
            j_arr = np.searchsorted(diags, diags - 2 * band_slack, side="left")
            win = np.arange(len(diags)) - j_arr + 1
            i_best = int(np.argmax(win))
            best_cnt = int(win[i_best])
            best_center = int(np.median(diags[j_arr[i_best]: i_best + 1]))
            if best is None or best_cnt > best.votes:
                chrom, off = self._chrom_of(max(best_center, 0))
                if chrom is None:
                    continue
                best = SeedHit(chrom=chrom, strand=strand,
                               diag=best_center - off, votes=best_cnt)
        return best
