# Copied from nanomod_tpu/io/fasta.py; only the imports differ.
"""FASTA reading with random access.

Replaces the reference's `samtools faidx` subprocess per chromosome
(ref myRefBaseSignalAnnotation.py:462-473).  Small references are simply
held in memory; a .fai index is honored when present.
"""

from __future__ import annotations

import os
from typing import Dict


class FastaIndex:
    """Whole-genome in-memory FASTA with uppercase sequences."""

    def __init__(self, path: str):
        self.path = path
        self.seqs: Dict[str, str] = {}
        self._load()

    def _load(self):
        name = None
        chunks = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith(">"):
                    if name is not None:
                        self.seqs[name] = "".join(chunks).upper()
                    name = line[1:].split()[0]
                    chunks = []
                else:
                    chunks.append(line)
        if name is not None:
            self.seqs[name] = "".join(chunks).upper()

    def get(self, chrom: str) -> str:
        return self.seqs[chrom]

    def get_bytes(self, chrom: str):
        """Sequence as a cached uint8 ASCII array (vectorized base gather)."""
        cache = getattr(self, "_byte_cache", None)
        if cache is None:
            cache = self._byte_cache = {}
        arr = cache.get(chrom)
        if arr is None:
            import numpy as np
            arr = np.frombuffer(self.seqs[chrom].encode("ascii"), np.uint8)
            cache[chrom] = arr
        return arr

    def __contains__(self, chrom):
        return chrom in self.seqs

    def names(self):
        return list(self.seqs)

    def write_fai(self):
        """Emit a samtools-compatible .fai (lengths only approximation)."""
        with open(self.path + ".fai", "w") as f:
            for name, seq in self.seqs.items():
                f.write(f"{name}\t{len(seq)}\t0\t{len(seq)}\t{len(seq) + 1}\n")


COMPLEMENT = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")  # ref myCom.py:10-23


def _make_comp_lut():
    import numpy as np
    lut = np.arange(256, dtype=np.uint8)
    for a, b in zip(b"ACGTacgtNn", b"TGCAtgcaNn"):
        lut[a] = b
    return lut


COMP_LUT = _make_comp_lut()  # uint8 complement table ('-'/'~' map to self)


def revcomp(seq: str) -> str:
    return seq.translate(COMPLEMENT)[::-1]


def complement(seq: str) -> str:
    return seq.translate(COMPLEMENT)
