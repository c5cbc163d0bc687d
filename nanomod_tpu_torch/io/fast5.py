# Copied from nanomod_tpu/io/fast5.py; only the imports differ.
"""FAST5 (HDF5) container I/O.

Layout compatibility with the reference so that files annotated by either
implementation are interchangeable:

  /Analyses/NanomoCorrected_000/BaseCalled_template/Events
      dtype [('norm_mean','<f8'),('norm_stdev','<f8'),('start','<u4'),
             ('length','<u4'),('base','S1')]
      (ref myRefBaseSignalAnnotation.py:702, myCom.py:48-59)
  /Analyses/NanomoCorrected_000/BaseCalled_template/Alignment
      attrs mapped_chrom / mapped_start / mapped_strand, clip/match counts
      datasets read_alignment, genome_alignment
      (ref myRefBaseSignalAnnotation.py:715-742)

Raw-read side (for Annotate):
  /UniqueGlobalKey/channel_id     digitisation/offset/range/sampling_rate
  /Raw/Reads/Read_*/Signal        raw DAC signal
  /Analyses/Basecall_1D_000/BaseCalled_template/{Events,Fastq,Move}
      (ref myFast5.py:15-52, myRefBaseSignalAnnotation.py:23-29)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None

ANALYSES = "Analyses"
CORRECTED_GROUP = "NanomoCorrected_000"   # ref myCom.py:48
BASECALLED_TEMPLATE = "BaseCalled_template"
EVENTS = "Events"
ALIGNMENT = "Alignment"
READ_ALIGNMENT = "read_alignment"
GENOME_ALIGNMENT = "genome_alignment"
MAP_CHROM = "mapped_chrom"
MAP_START = "mapped_start"
MAP_STRAND = "mapped_strand"

CORRECTED_EVENTS_DTYPE = np.dtype(
    [("norm_mean", "<f8"), ("norm_stdev", "<f8"), ("start", "<u4"),
     ("length", "<u4"), ("base", "S1")]
)

_corr_base = f"/{ANALYSES}/{CORRECTED_GROUP}/{BASECALLED_TEMPLATE}"
CORRECTED_EVENTS_PATH = f"{_corr_base}/{EVENTS}"
CORRECTED_ALIGNMENT_PATH = f"{_corr_base}/{ALIGNMENT}"


@dataclass
class CorrectedRead:
    """One read's corrected (resquiggled) annotation."""

    chrom: str
    start: int          # 0-based mapped start
    strand: str         # '+' | '-'
    norm_mean: np.ndarray    # [L] f8
    norm_stdev: np.ndarray   # [L] f8
    ev_start: np.ndarray     # [L] u4 raw-signal offsets
    ev_length: np.ndarray    # [L] u4
    base: np.ndarray         # [L] S1 reference bases (read direction)
    filename: str = ""


def _decode(x):
    return x.decode() if isinstance(x, bytes) else x


def read_corrected_events(path: str) -> Optional[CorrectedRead]:
    """Load the NanomoCorrected_000 annotation from one FAST5, or None.

    Mirrors myFast5.ReadNanoraw_events + ReadMapInfoInRef
    (ref myFast5.py:94-126) with the reference's tolerance for corrupt files
    (ref myDetect.py:41-45: unreadable files are skipped, not fatal).
    """
    try:
        with h5py.File(path, "r") as f:
            if CORRECTED_ALIGNMENT_PATH not in f:
                return None
            al = f[CORRECTED_ALIGNMENT_PATH]
            ev = f[CORRECTED_EVENTS_PATH][()]
            return CorrectedRead(
                chrom=_decode(al.attrs[MAP_CHROM]),
                start=int(al.attrs[MAP_START]),
                strand=_decode(al.attrs[MAP_STRAND]),
                norm_mean=ev["norm_mean"],
                norm_stdev=ev["norm_stdev"],
                ev_start=ev["start"],
                ev_length=ev["length"],
                base=ev["base"],
                filename=path,
            )
    except OSError:
        return None


def has_corrected_group(path: str) -> bool:
    """Cheap check whether a FAST5 already carries the corrected annotation
    (used by Annotate --resume to skip finished files)."""
    try:
        with h5py.File(path, "r") as f:
            return f"{ANALYSES}/{CORRECTED_GROUP}" in f
    except OSError:
        return False


def compress_corrected_arrays(events: np.ndarray,
                              read_alignment: np.ndarray,
                              genome_alignment: np.ndarray,
                              level: int = 1):
    """zlib-compress the three corrected datasets for write_corrected_events.

    HDF5's gzip filter is raw zlib, so the deflate can run OUTSIDE the h5py
    global lock (zlib releases the GIL): pipeline worker threads compress
    while the single writer thread only performs the cheap metadata +
    pre-compressed-chunk writes.  Returns the ``precompressed`` argument for
    write_corrected_events: {name: (contiguous array, zlib blob)}."""
    import zlib

    out = {}
    for name, arr in ((READ_ALIGNMENT, read_alignment),
                      (GENOME_ALIGNMENT, genome_alignment),
                      (EVENTS, events.astype(CORRECTED_EVENTS_DTYPE,
                                             copy=False))):
        a = np.ascontiguousarray(arr)
        out[name] = (a, zlib.compress(a.tobytes(), level) if a.size else b"")
    return out


def _write_dataset(parent, name, arr, blob, compression):
    """One corrected dataset: pre-compressed direct-chunk write when a blob
    is available, plain (uncompressed) storage otherwise."""
    if blob and compression == "gzip":
        ds = parent.create_dataset(name, shape=arr.shape, dtype=arr.dtype,
                                   chunks=arr.shape, compression="gzip",
                                   compression_opts=1)
        ds.id.write_direct_chunk((0,), blob, filter_mask=0)
    else:
        parent.create_dataset(name, data=arr)


def write_corrected_events(
    path: str,
    chrom: str,
    start: int,
    strand: str,
    events: np.ndarray,            # CORRECTED_EVENTS_DTYPE, genome order
    read_alignment: np.ndarray,    # S1, genome-forward orientation
    genome_alignment: np.ndarray,  # S1
    clipped_start: int = 0,
    clipped_end: int = 0,
    num_insertions: int = 0,
    num_deletions: int = 0,
    num_matches: int = 0,
    num_mismatches: int = 0,
    basecall_group: str = "Basecall_1D_000",
    compression: str = "gzip",     # 'gzip' (ref parity) | 'none'
    precompressed: Optional[dict] = None,
):
    """Write (replacing any stale copy) the corrected annotation into a FAST5.

    Idempotent-replace semantics and attr set mirror save_annotation
    (ref myRefBaseSignalAnnotation.py:689-742).  The datasets are gzip'd
    like the reference's (exception: a ZERO-length dataset is stored
    uncompressed — the reference gzips those too, but a 0-row gzip chunk
    is unrepresentable in the direct-chunk path and readers cannot tell
    the difference); pass ``precompressed`` (from
    compress_corrected_arrays, typically built on a worker thread) to keep
    the deflate out of the serialized h5py section — the HDF5 library is
    single-threaded behind a global lock, so whatever runs under it bounds
    whole-process write throughput."""
    if precompressed is None:
        precompressed = (compress_corrected_arrays(
            events, read_alignment, genome_alignment)
            if compression == "gzip" else
            {READ_ALIGNMENT: (np.ascontiguousarray(read_alignment), b""),
             GENOME_ALIGNMENT: (np.ascontiguousarray(genome_alignment), b""),
             EVENTS: (np.ascontiguousarray(
                 events.astype(CORRECTED_EVENTS_DTYPE, copy=False)), b"")})
    with h5py.File(path, "r+") as f:
        base_group = f.require_group(ANALYSES)
        if CORRECTED_GROUP in base_group:
            del base_group[CORRECTED_GROUP]
        grp = base_group.create_group(CORRECTED_GROUP)
        bc = grp.create_group(BASECALLED_TEMPLATE)
        al = bc.create_group(ALIGNMENT)
        # fixed-length byte strings: what the reference's h5py 2.9 wrote
        # (ref myRefBaseSignalAnnotation.py:719-721) and what the native
        # writer (native/fast5_write.cpp) emits — h5py 3.x would otherwise
        # store Python str as vlen UTF-8
        al.attrs[MAP_START] = start
        al.attrs[MAP_STRAND] = np.bytes_(strand)
        al.attrs[MAP_CHROM] = np.bytes_(chrom)
        al.attrs["clipped_bases_start"] = clipped_start
        al.attrs["clipped_bases_end"] = clipped_end
        al.attrs["num_insertions"] = num_insertions
        al.attrs["num_deletions"] = num_deletions
        al.attrs["num_matches"] = num_matches
        al.attrs["num_mismatches"] = num_mismatches
        al.attrs["Bcinfo"] = np.bytes_(basecall_group)
        _write_dataset(al, READ_ALIGNMENT, *precompressed[READ_ALIGNMENT],
                       compression)
        _write_dataset(al, GENOME_ALIGNMENT, *precompressed[GENOME_ALIGNMENT],
                       compression)
        _write_dataset(bc, EVENTS, *precompressed[EVENTS], compression)


def iter_fast5_files(base: str, recursive: bool = True,
                     suffix: str = ".fast5") -> Iterator[str]:
    """Recursive FAST5 discovery, skipping 'mall' dirs like the reference's
    readsubfolder (ref myDetect.py:627-629)."""
    if not recursive:
        for name in sorted(os.listdir(base)):
            if name.endswith(suffix):
                yield os.path.join(base, name)
        return
    for root, dirs, files in os.walk(base):
        dirs[:] = sorted(d for d in dirs if d != "mall")
        for name in sorted(files):
            if name.endswith(suffix):
                yield os.path.join(root, name)


# ---------------------------------------------------------------------------
# Raw/basecall side (Annotate inputs)
# ---------------------------------------------------------------------------

CHANNEL_ID_PATH = "UniqueGlobalKey/channel_id"
RAW_READS_PATH = "Raw/Reads"


@dataclass
class RawRead:
    """Raw signal + basecall info needed to resquiggle one read."""

    read_id: str
    raw_signal: np.ndarray          # int16/float DAC samples
    channel: dict                   # digitisation/offset/range/sampling_rate
    events: Optional[np.ndarray]    # basecall event table (or None)
    move: Optional[np.ndarray]      # move table (Guppy-style)
    fastq_seq: Optional[str]
    raw_start_time: int
    basecaller: str                 # 'albacore1' | 'albacore2' | 'guppy'
    first_sample_template: int = 0
    filename: str = ""


def read_raw_basecall(path: str, basecall_1d: str = "Basecall_1D_000",
                      basecall_2strand: str = "BaseCalled_template"):
    """Load everything getFast5Info gathers (ref
    myRefBaseSignalAnnotation.py:340-358): channel info, raw signal, the
    basecall event/move table and fastq.  Returns (RawRead|None, err)."""
    try:
        f = h5py.File(path, "r")
    except OSError:
        return None, "Cannot open fast5"
    with f:
        try:
            ch = dict(f[CHANNEL_ID_PATH].attrs)
        except KeyError:
            return None, "No Channel Info"
        try:
            rgrp = f[RAW_READS_PATH]
            rkey = sorted(rgrp.keys())[0]
            raw = rgrp[rkey]["Signal"][()]
            raw_attrs = dict(rgrp[rkey].attrs)
        except (KeyError, IndexError):
            return None, "No Raw_reads/Signal"

        bc_base = f"{ANALYSES}/{basecall_1d}/{basecall_2strand}"
        try:
            fq = f[f"{bc_base}/Fastq"][()]
            fq = _decode(fq).split("\n")
            read_id = (fq[0][1:] if fq[0].startswith("@") else fq[0])
            read_id = read_id.replace(" ", ":::").replace("\t", "|||")
            fq_seq = fq[1]
        except KeyError:
            return None, "No Fastq data"

        bc_attrs = dict(f[f"{ANALYSES}/{basecall_1d}"].attrs) \
            if f"{ANALYSES}/{basecall_1d}" in f else {}
        name = _decode(bc_attrs.get("name", ""))
        version = _decode(bc_attrs.get("version", "0.0"))
        events = move = None
        first_sample = 0
        if "Guppy" in name:
            basecaller = "guppy"
            try:
                move = f[f"{bc_base}/Move"][()]
                seg = "Segmentation_" + basecall_1d.split("_")[-1]
                seg_attrs = f[f"{ANALYSES}/{seg}/Summary/segmentation"].attrs
                first_sample = int(seg_attrs["first_sample_template"])
            except KeyError:
                return None, "No events/move data"
        else:
            # Albacore version sniffing (ref :50-63)
            major = version.split(".")[0] if version else "0"
            basecaller = "albacore2" if major.isdigit() and int(major) >= 2 else "albacore1"
            try:
                events = f[f"{bc_base}/Events"][()]
            except KeyError:
                return None, "No events/move data"

        return RawRead(
            read_id=read_id,
            raw_signal=raw.astype(np.float64),
            channel={k: (_decode(v) if isinstance(v, bytes) else v)
                     for k, v in ch.items()},
            events=events,
            move=move,
            fastq_seq=fq_seq,
            raw_start_time=int(raw_attrs.get("start_time", 0)),
            basecaller=basecaller,
            first_sample_template=first_sample,
            filename=path,
        ), ""
