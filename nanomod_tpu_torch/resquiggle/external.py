# Copied from nanomod_tpu/resquiggle/external.py; only the imports differ.
"""External-aligner path: bwa / minimap2 subprocess alignment.

The built-in banded DP (resquiggle/banded.py) is the default and the TPU
path; `--alignStr bwa|minimap2` reproduces the reference's subprocess flow
(ref bin/scripts/myRefBaseSignalAnnotation.py:393-448) for users who want
the exact external-aligner behavior on divergent or repeat-heavy reads:

  * batch FASTA of per-read basecalls -> `bwa mem -x ont2d` or
    `minimap2 -ax map-ont` (ref :397-417)
  * SAM record filters: drop mapq 255, pos 0, rname '*', secondary/
    supplementary flags (0x900); keep the best-mapq record per read
    (handle_line, ref :1395-1409)
  * CIGAR -> the same (ops_type, ops_a, ops_b) op triple the banded DP
    produces, feeding the identical indel-correction core downstream.

The aligner binary must be on PATH; a missing binary is a hard error (the
flag must never be silently ignored).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from nanomod_tpu_torch.config import AnnotateConfig

_CIGAR_REF = set("MDN=X")
_CIGAR_READ = set("MIS=X")


def aligner_command(align: str, ref_fasta: str, reads_fasta: str) -> List[str]:
    """The reference's exact aligner invocations (ref :407-411)."""
    if align == "bwa":
        return ["bwa", "mem", "-x", "ont2d", ref_fasta, reads_fasta]
    if align == "minimap2":
        return ["minimap2", "-ax", "map-ont", ref_fasta, reads_fasta]
    raise ValueError(f"unknown aligner {align!r}")


def ensure_bwa_index(ref_fasta: str):
    """bwa requires a prebuilt index (the reference assumes one exists);
    build it once next to the FASTA when missing."""
    if not os.path.isfile(ref_fasta + ".bwt"):
        subprocess.run(["bwa", "index", ref_fasta], check=True,
                       capture_output=True)


def cigar_to_ops(cigar: str, pos0: int, read_len: int
                 ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Expand a SAM CIGAR into the banded-DP op triple.

    pos0: 0-based reference position of the first aligned base.  Ops use
    ABSOLUTE genome coordinates (the caller passes win_start=0).  Returns
    (ops_type, ops_a, ops_b) int32: type 0=M (a=read idx, b=genome pos),
    1=I (a=read idx), 2=D (a=genome pos); or None for an unusable CIGAR.
    """
    ot, oa, ob = [], [], []
    i = 0          # read index in genome-forward orientation
    g = pos0
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
            continue
        if num == 0 and ch != "*":
            return None
        if ch in ("M", "=", "X"):
            ot.extend([0] * num)
            oa.extend(range(i, i + num))
            ob.extend(range(g, g + num))
            i += num
            g += num
        elif ch == "I":
            ot.extend([1] * num)
            oa.extend(range(i, i + num))
            ob.extend([-1] * num)
            i += num
        elif ch in ("D", "N"):
            ot.extend([2] * num)
            oa.extend([g + x for x in range(num)])
            ob.extend([-1] * num)
            g += num
        elif ch in ("S", "H"):
            i += num           # clipped read bases (H: absent from SEQ but
                               # present in our full basecall)
        else:                  # P or invalid
            return None
        num = 0
    if i > read_len or not ot:
        return None
    return (np.asarray(ot, np.int32), np.asarray(oa, np.int32),
            np.asarray(ob, np.int32))


def parse_sam(lines, n_reads: int):
    """Best-mapq primary record per read (handle_line semantics,
    ref myRefBaseSignalAnnotation.py:1395-1409).

    Read names are batch indices.  Returns {idx: (flag, rname, pos0,
    mapq, cigar)}.
    """
    best = {}
    for line in lines:
        if not line or line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        if len(f) < 11:
            continue
        try:
            idx = int(f[0])
            flag = int(f[1])
            pos = int(f[3])
            mapq = int(f[4])
        except ValueError:
            continue
        rname, cigar = f[2], f[5]
        # drop: unusable mapq, unmapped pos, no target, secondary (0x100)
        # or supplementary (0x800) records (ref :1398-1402)
        if mapq == 255 or pos == 0 or rname == "*" or cigar == "*" \
                or (flag & 0x900):
            continue
        if idx < 0 or idx >= n_reads:
            continue
        if idx not in best or mapq > best[idx][3]:
            best[idx] = (flag, rname, pos - 1, mapq, cigar)
    return best


def align_external(prepared: List, cfg: AnnotateConfig):
    """Align a prepared batch with the external aligner.

    Returns per-read (ops | None, win_start=0), parallel to `prepared`.
    Reads are UPDATED in place with the SAM-derived chrom/strand and the
    matching genome-forward sequence (the seed-derived orientation is
    advisory only in this mode).
    """
    from nanomod_tpu_torch.io.fasta import revcomp

    exe = shutil.which(cfg.align)
    if exe is None:
        raise RuntimeError(
            f"--alignStr {cfg.align}: '{cfg.align}' not found on PATH. "
            "Install it or use the built-in DP aligner (--alignStr dp).")
    if cfg.align == "bwa":
        ensure_bwa_index(cfg.ref_fasta)

    with tempfile.TemporaryDirectory(prefix="nanomod_aln_") as td:
        fa = os.path.join(td, "reads.fa")
        with open(fa, "w") as f:
            for i, r in enumerate(prepared):
                basecall = (r.fwd_seq if r.strand == "+"
                            else revcomp(r.fwd_seq))
                f.write(f">{i}\n{basecall}\n")
        proc = subprocess.run(
            aligner_command(cfg.align, cfg.ref_fasta, fa),
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cfg.align} failed (exit {proc.returncode}): "
                f"{proc.stderr[-500:]}")
        best = parse_sam(proc.stdout.splitlines(), len(prepared))

    out = []
    for i, r in enumerate(prepared):
        hit = best.get(i)
        if hit is None:
            out.append((None, 0))
            continue
        flag, rname, pos0, mapq, cigar = hit
        strand = "-" if flag & 0x10 else "+"
        basecall = r.fwd_seq if r.strand == "+" else revcomp(r.fwd_seq)
        r.chrom = rname
        r.strand = strand
        r.fwd_seq = revcomp(basecall) if strand == "-" else basecall
        ops = cigar_to_ops(cigar, pos0, len(r.fwd_seq))
        out.append((ops, 0) if ops is not None else (None, 0))
    return out
