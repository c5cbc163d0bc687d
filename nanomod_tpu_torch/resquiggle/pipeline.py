"""The Annotate pipeline: raw FAST5 -> indel-corrected per-base annotation.

Port of nanomod_tpu/resquiggle/pipeline.py.  Reads are k-mer seeded
(resquiggle/seed.py), aligned by the banded affine DP on the device (kernel
K1), their tracebacks walked on the device (kernel K2) so that only 2-bit
op codes come back, then corrected and assembled by the native core
(annotate_core.cpp) and written back into each FAST5 by the native writer
(fast5_write.cpp).  The FAST5 parsers and writers are the
repo's own C++ (no libhdf5); h5py, where installed, only serves files the
native code declines, and where it is missing such a file raises.

Differences from the reference: host-to-device copies go from pinned memory
with ``non_blocking=True``; the packed result comes back by a non-blocking
copy into pinned memory behind a ``torch.cuda.Event`` that
``fetch_outputs`` waits on; the device-walk path (``use_device_walk``:
the walk's codes packed four a byte, mode "codes2", when the step count
2M + W is a multiple of 4, else one a byte, mode "codes") is the only
DP path.  ``align="bwa"|"minimap2"`` runs the reference's external
aligner instead of the DP (resquiggle/external.py): one subprocess round
over every prepared read, then the per-read native correction
(``annotate_one``) on a thread pool; a missing binary raises.
``n_devices > 1`` deals the DP sub-batches round-robin over the first
min(n_devices, device_count) CUDA devices; under several processes (torch.distributed,
parallel/dist.py) each rank annotates its round-robin file shard and every
rank prints the merged statistics.
"""

from __future__ import annotations

import itertools
import os
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nanomod_tpu_torch.config import AnnotateConfig
from nanomod_tpu_torch.io import fast5 as fast5_io
from nanomod_tpu_torch.io.fast5 import (compress_corrected_arrays,
                                        iter_fast5_files, read_raw_basecall,
                                        write_corrected_events)
from nanomod_tpu_torch.io.fasta import FastaIndex
from nanomod_tpu_torch.signal.events import EventError, extract_events
from nanomod_tpu_torch.signal.normalize import (kmer_shift_scale, load_kmer_model,
                                                mad_normalize)
from nanomod_tpu_torch.device import resolve_device, to_device
from nanomod_tpu_torch.resquiggle import banded
from nanomod_tpu_torch.resquiggle.seed import SeedIndex, encode


@dataclass
class PreparedRead:
    path: str
    read_id: str
    fwd_seq: str            # genome-forward-oriented basecall
    chrom: str
    strand: str
    diag: int               # approximate genome start of the fwd read
    events_start: np.ndarray   # read-order raw starts (samples)
    events_length: np.ndarray
    norm_signal: np.ndarray    # normalized raw signal


def _host_workers(cfg: AnnotateConfig, cap: int = 16) -> int:
    """Host-side thread count: cfg.threads clamped to the machine."""
    return max(1, min(cfg.threads, os.cpu_count() or 1, cap))


def _min_score(cfg: AnnotateConfig, read_len: int) -> int:
    """Alignment acceptance threshold."""
    return max(20, int(0.3 * cfg.match_score * read_len))


def _length_bucket(m: int, buckets=(256, 512, 1024, 2048, 4096, 8192, 16384)) -> int:
    for b in buckets:
        if m <= b:
            return b
    return ((m + 16383) // 16384) * 16384


# Bytes of traceback a DP sub-batch may hold on the device: [B, M,
# tb_pitch(W)] u8, two sub-batches in flight.  The reference's
# dp_batch_size (256) stays within it up to W = 4096 at M = 4096; a wider
# band or a longer bucket halves the sub-batch until it fits (M 8192, W
# 8192: 64 reads, not 256).  A read's result does not depend on its
# batch.
TB_BUDGET = 4 << 30


def _fit_batch(sub: int, m: int, w: int) -> int:
    """``sub`` halved until a sub-batch's traceback fits TB_BUDGET."""
    from nanomod_tpu_torch.resquiggle.banded_kernel import tb_pitch
    while sub > 1 and sub * m * tb_pitch(w) > TB_BUDGET:
        sub //= 2
    return sub


ALIGNERS = ("dp", "bwa", "minimap2")


def _check_supported(cfg: AnnotateConfig, device):
    """Raise for the options this port does not run: a band width above
    MAX_W (32,768) on the card (K1 holds at most 32 warps of 32 band lanes
    a thread), an aligner the reference does not have and the non-native
    paths."""
    from nanomod_tpu_torch.resquiggle.banded_kernel import MAX_W
    w = cfg.band_width
    if torch.device(device).type == "cuda" and w > MAX_W:
        raise NotImplementedError(
            f"band_width={w}: the CUDA kernels take at most {MAX_W}")
    if cfg.align not in ALIGNERS:
        raise NotImplementedError(
            f"align={cfg.align!r}: use one of {ALIGNERS}")
    if not (cfg.use_native and cfg.use_device_walk):
        raise NotImplementedError(
            "only the native, device-walk Annotate path is ported "
            "(use_native=True, use_device_walk=True)")


def _h5py_required(paths, what: str):
    """Raise when ``paths`` need the h5py path and h5py is missing."""
    if paths and fast5_io.h5py is None:
        raise RuntimeError(
            f"{what} needs h5py, which is not installed: "
            + ", ".join(paths[:5]) + (" ..." if len(paths) > 5 else ""))


def prepare_read(path: str, cfg: AnnotateConfig, seed_index: SeedIndex,
                 kmer_model) -> Tuple[Optional[PreparedRead], str]:
    """Load + extract events + normalize + seed one read (h5py path, for
    files the native reader declines)."""
    raw, err = read_raw_basecall(path, cfg.basecall_1d, cfg.basecall_2strand)
    if raw is None:
        return None, err
    try:
        ev = extract_events(raw)
    except EventError as e:
        return None, e.key

    shift_scale = None
    if kmer_model is not None and raw.events is not None:
        try:
            shift_scale = kmer_shift_scale(
                raw.events["mean"], raw.events["model_state"], kmer_model
            )
        except (KeyError, np.linalg.LinAlgError):
            return None, "Cannot nanopore correction"

    span = (int(ev.start[0]), int(ev.start[-1] + ev.length[-1]))
    if span[1] > len(raw.raw_signal):
        return None, "No Raw_reads/Signal"
    norm = mad_normalize(raw.raw_signal, span, shift_scale)
    return _wrap_with_hit(path, raw.read_id, ev.seq, ev.start, ev.length,
                          norm, seed_index.best_band(ev.seq),
                          require_seed=(cfg.align == "dp"))


def _wrap_with_hit(path, read_id, seq, ev_start, ev_length, norm_signal,
                   hit, require_seed: bool = True):
    """Build the PreparedRead for a seeded (or unseeded) read.

    require_seed=False (external-aligner mode): an unseeded read is kept
    with '+' orientation and no chrom; the SAM record decides chrom and
    strand later (resquiggle/external.py updates the PreparedRead in
    place)."""
    if hit is None or hit.votes < 3:
        if require_seed:
            return None, "Not in alignment sam"
        return PreparedRead(
            path=path, read_id=read_id, fwd_seq=seq, chrom="", strand="+",
            diag=0, events_start=ev_start, events_length=ev_length,
            norm_signal=norm_signal,
        ), ""
    from nanomod_tpu_torch.io.fasta import revcomp
    fwd_seq = seq if hit.strand == "+" else revcomp(seq)
    return PreparedRead(
        path=path, read_id=read_id, fwd_seq=fwd_seq, chrom=hit.chrom,
        strand=hit.strand, diag=hit.diag, events_start=ev_start,
        events_length=ev_length, norm_signal=norm_signal,
    ), ""


def prepare_batch(paths: List[str], cfg: AnnotateConfig,
                  seed_index: SeedIndex, kmer_model):
    """Load + extract + normalize + seed a batch of FAST5s.

    The native raw-FAST5 reader (fast5_ingest.cpp f5_prepare_*) parses,
    extracts events and MAD-normalizes in threaded C++; seeding runs on the
    native seed pool.  Files the native reader cannot classify go through
    the h5py path, which raises when h5py is missing.

    Returns (prepared reads, errors {key: [paths]}).
    """
    from concurrent.futures import ThreadPoolExecutor

    from nanomod_tpu_torch.native.prepare_bind import (model_tables,
                                                       native_prepare_batch)
    from nanomod_tpu_torch.utils.observe import stage
    from nanomod_tpu_torch.native import require

    require("fast5_ingest")
    errors = defaultdict(list)
    prepared = []
    workers = _host_workers(cfg)

    with stage("prepare", unit="reads") as s:
        tables = model_tables(kmer_model)
        if kmer_model is not None and tables is None:
            raise RuntimeError("the k-mer model does not cover every ACGT "
                               "5-mer; the native prepare needs it")
        nt = max(1, min(cfg.threads, 2 * (os.cpu_count() or 1)))
        native_res = native_prepare_batch(
            paths, cfg.basecall_1d, cfg.basecall_2strand,
            nthreads=nt, kmer_tables=tables)
        if native_res is None:
            raise RuntimeError("native library 'fast5_ingest' failed to "
                               "build or load (needs g++ and zlib headers)")
        fallback = []
        good = []
        for p, r in zip(paths, native_res):
            if r is None:                     # unclassified: h5py path
                fallback.append(p)
            elif isinstance(r, str):
                errors[r].append(p)
            else:
                good.append((p, r))
        hits = seed_index.best_bands_native([r.seq for _, r in good],
                                            nthreads=workers)
        if hits is None:
            raise RuntimeError("native library 'seed_core' failed to build "
                               "or load (needs g++)")
        for i, (p, r) in enumerate(good):
            rd, err = _wrap_with_hit(p, r.read_id, r.seq, r.ev_start,
                                     r.ev_length, r.norm_signal, hits[i],
                                     require_seed=(cfg.align == "dp"))
            if rd is None:
                errors[err].append(p)
            else:
                prepared.append(rd)
        _h5py_required(fallback, "raw FAST5 the native reader declined")
        if fallback:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                for p, (rd, err) in zip(fallback, ex.map(
                        lambda q: prepare_read(q, cfg, seed_index, kmer_model),
                        fallback)):
                    if rd is None:
                        errors[err].append(p)
                    else:
                        prepared.append(rd)
        s.add(len(prepared))
    return prepared, errors


@dataclass
class DPBatch:
    """An in-flight banded-DP batch whose packed outputs are on their way
    to ``host`` (pinned memory on CUDA) behind ``event``."""

    reads: List[PreparedRead]
    host: torch.Tensor          # [B, 12 + .] uint8 (banded.walk_outputs)
    event: Optional[object]     # torch.cuda.Event, None on the CPU
    tail_shape: tuple           # per-read code shape
    lens: np.ndarray
    win_starts: np.ndarray
    packed: bool                # codes four a byte (mode "codes2")


def dispatch_dp(reads: List[PreparedRead], fasta: FastaIndex,
                cfg: AnnotateConfig, device, pad_bsz: int = 0
                ) -> Optional[DPBatch]:
    """Build and launch the banded DP + device walk for a length-bucketed
    batch on ``device``; returns without waiting for the device.

    pad_bsz pads the batch to a fixed size so sub-batches share shapes."""
    if not reads:
        return None
    device = torch.device(device)
    w = cfg.band_width
    m = _length_bucket(max(len(r.fwd_seq) for r in reads))
    bsz = max(len(reads), pad_bsz)
    # the three inputs in one buffer (lengths first, 4-byte aligned), so
    # that they cross to the card in one copy
    buf = np.empty(4 * bsz + bsz * m + bsz * (m + w), np.uint8)
    lens = buf[:4 * bsz].view(np.int32)
    read_codes = buf[4 * bsz:4 * bsz + bsz * m].reshape(bsz, m)
    ref_codes = buf[4 * bsz + bsz * m:].reshape(bsz, m + w)
    lens[:] = 0
    read_codes[:] = 4
    ref_codes[:] = 5
    win_starts = np.zeros(bsz, np.int64)
    for i, r in enumerate(reads):
        seq = r.fwd_seq
        lens[i] = len(seq)
        read_codes[i, : len(seq)] = encode(seq).astype(np.uint8)
        genome = fasta.get(r.chrom)
        ws = r.diag - w // 2
        win_starts[i] = ws
        lo = max(ws, 0)
        hi = min(ws + m + w, len(genome))
        if hi > lo:
            ref_codes[i, lo - ws: hi - ws] = encode(genome[lo:hi]).astype(np.uint8)

    dbuf = to_device(buf, device)
    tb, best, bi, bk = banded.banded_sw(
        dbuf[4 * bsz:4 * bsz + bsz * m].view(bsz, m),
        dbuf[4 * bsz + bsz * m:].view(bsz, m + w),
        dbuf[:4 * bsz].view(torch.int32),
        match=cfg.match_score, mismatch=cfg.mismatch_score,
        go=cfg.gap_open, ge=cfg.gap_extend,
    )
    # K2 writes the rows the host fetches: the 12-byte header, the codes
    rows, packed_codes = banded.walk_outputs(tb, best, bi, bk)
    event = None
    host = rows
    if device.type == "cuda":
        host = torch.empty(rows.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return DPBatch(reads, host, event, (rows.shape[1] - 12,), lens.copy(),
                   win_starts, packed_codes)


def fetch_outputs(batch: DPBatch):
    """Wait for a dispatched batch and return (codes, best, best_i,
    best_k) as numpy views of its packed outputs."""
    if batch.event is not None:
        batch.event.synchronize()
    return banded.unpack_outputs(batch.host.numpy(), batch.tail_shape)


def finish_alignment(batch: DPBatch, cfg: AnnotateConfig):
    """Fetch the DP outputs and decode the walk codes of a dispatched batch.

    Returns [((ops_type, ops_a, ops_b) int32 triple | None, win_start)] per
    read, 5'->3' op order (None for reads below the score gate).
    """
    codes, best, bi, bk = fetch_outputs(batch)
    n = len(batch.reads)
    ops_all = banded.decode_walk_native(
        codes[:n], bi[:n], bk[:n], nthreads=_host_workers(cfg, cap=8),
        packed=batch.packed)
    out = []
    for i in range(n):
        if best[i] < _min_score(cfg, int(batch.lens[i])):
            out.append((None, int(batch.win_starts[i])))
        else:
            out.append((ops_all[i], int(batch.win_starts[i])))
    return out


def annotate_one(read: PreparedRead, ops, win_start: int, fasta: FastaIndex,
                 cfg: AnnotateConfig) -> Tuple[Optional[dict], str]:
    """Run the native indel-correction core (annotate_core.cpp) for one
    aligned read; returns the payload for the corrected writer.

    ``ops`` is the (ops_type, ops_a, ops_b) int32 array triple of the
    external aligner (external.cigar_to_ops, win_start 0).  Raises when
    the native library is missing: the port has no Python correction
    core."""
    from nanomod_tpu_torch.io.fast5 import CORRECTED_EVENTS_DTYPE
    from nanomod_tpu_torch.io.fasta import COMP_LUT
    from nanomod_tpu_torch.native.annotate_bind import native_annotate_bytes
    ot, oa, ob = ops
    if len(ot) == 0:
        return None, "Incorrect Alignment"
    genome_b = fasta.get_bytes(read.chrom)
    m_total = len(read.fwd_seq)
    read_b = np.frombuffer(read.fwd_seq.encode("ascii"), np.uint8)
    is_m = ot == 0
    is_i = ot == 1
    is_d = ot == 2

    # aligned read span in fwd coordinates
    ridx = oa[~is_d]
    if ridx.size == 0:
        return None, "Incorrect Alignment"
    r0 = int(ridx.min())
    r1 = int(ridx.max())
    leftclip = r0
    rightclip = m_total - 1 - r1

    m_idx = np.flatnonzero(is_m)
    if m_idx.size == 0:
        return None, "Incorrect Alignment"
    first_match_pos = win_start + int(ob[m_idx[0]])

    # aligned columns in genome-forward order
    g = np.where(is_m, ob, oa).astype(np.int64) + win_start
    g_real = g[~is_i]
    if g_real.size and (g_real.min() < 0 or g_real.max() >= len(genome_b)):
        return None, "Incorrect Alignment"
    refb = genome_b[np.where(is_i, 0, g)]
    refb = np.where(is_i, np.uint8(ord("-")), refb)
    readb = read_b[np.where(is_d, 0, oa)]
    readb = np.where(is_d, np.uint8(ord("-")), readb)
    readb = np.ascontiguousarray(readb, np.uint8)   # native core mutates
    refb = np.ascontiguousarray(refb, np.uint8)
    nummismatch = int(np.count_nonzero(is_m & (refb != readb)))
    numins = int(np.count_nonzero(is_i))
    numdel = int(np.count_nonzero(is_d))
    nmatch = len(ot) - nummismatch - numins - numdel

    # genome-forward event arrays for the aligned region
    n_aligned = r1 - r0 + 1
    if read.strand == "+":
        orig = r0 + np.arange(n_aligned)
    else:
        orig = m_total - 1 - r0 - np.arange(n_aligned)
    ev_start = read.events_start[orig].astype(np.int64)
    ev_length = read.events_length[orig].astype(np.int64)

    res = native_annotate_bytes(
        refb, readb, ev_start, ev_length, read.strand, read.norm_signal,
        cfg.min_num_signal, cfg.resegment_signal_wind, cfg.more_signal_perc)
    if res is None:
        raise RuntimeError("native library 'annotate_core' failed to build "
                           "or load (needs g++)")
    out_mean, out_std, out_start, out_len, out_valid, hist = res
    valid = np.flatnonzero(out_valid)
    if valid.size == 0:
        return None, "Incorrect Alignment"
    order = valid if read.strand == "+" else valid[::-1]
    ev_out = np.empty(order.size, CORRECTED_EVENTS_DTYPE)
    ev_out["norm_mean"] = out_mean[order]
    ev_out["norm_stdev"] = out_std[order]
    ev_out["start"] = out_start[order]
    ev_out["length"] = out_len[order]
    bb = refb[order]
    if read.strand == "-":
        bb = COMP_LUT[bb]
    ev_out["base"] = bb.view("S1")
    if read.strand == "+":
        read_al = readb.view("S1")
        genome_al = refb.view("S1")
        clip_s, clip_e = leftclip, rightclip
    else:
        read_al = COMP_LUT[readb[::-1]].view("S1")
        genome_al = COMP_LUT[refb[::-1]].view("S1")
        clip_s, clip_e = rightclip, leftclip
    return {
        "chrom": read.chrom,
        "start": int(first_match_pos),
        "strand": read.strand,
        "events": ev_out,
        "read_alignment": read_al,
        "genome_alignment": genome_al,
        "clipped_start": clip_s,
        "clipped_end": clip_e,
        "num_insertions": numins,
        "num_deletions": numdel,
        "num_matches": nmatch,
        "num_mismatches": nummismatch,
        "signal_hist": {i: int(hist[i]) for i in np.flatnonzero(hist)},
    }, ""


def _fan_out_devices(cfg: AnnotateConfig, device) -> List[torch.device]:
    """The devices the DP sub-batches are dealt to, round-robin: with
    ``n_devices > 1`` on CUDA, the first min(n_devices, device_count) CUDA
    devices (the reference clamps the same way), else ``device`` alone.
    Results do not depend on it: the DP is deterministic and batches are
    finished in dispatch order."""
    device = torch.device(device)
    if device.type == "cuda" and cfg.n_devices and cfg.n_devices > 1:
        n = min(cfg.n_devices, torch.cuda.device_count())
        if n > 1:
            return [torch.device("cuda", i) for i in range(n)]
    return [device]


def process_prepared(prepared, cfg: AnnotateConfig, fasta: FastaIndex,
                     device, sub_hint: int = 0):
    """Align + correct + write back prepared reads on ``device``.

    ``prepared`` is a list OR an iterator of lists (streamed chunks from
    the prepare prefetcher).  Each chunk's length buckets are split into
    sub-batches and a bounded window of two DP sub-batches stays in flight
    across chunk boundaries: the device computes sub-batch k+1 while the
    host corrects k; the FAST5 write-back runs on a background thread.
    With an external aligner (``cfg.align`` bwa or minimap2) every chunk
    is collected first and aligned in one subprocess round (stage
    ``align_ext``), then each read is corrected on a thread pool
    (``annotate_one``); no kernel runs.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from nanomod_tpu_torch.native.annotate_bind import annotate_codes_batch_native
    from nanomod_tpu_torch.utils.observe import stage
    from nanomod_tpu_torch.native import require

    _check_supported(cfg, device)
    use_native_write = cfg.fast5_compression == "gzip"
    require("annotate_core", "traceback",
            *(("fast5_write",) if use_native_write else ()))
    errors = defaultdict(list)
    chunk_iter = iter([prepared]) if isinstance(prepared, list) \
        else iter(prepared)
    n_seen = 0
    sub = 0

    def dp_parts_gen():
        """(reads, pad) sub-batch specs, streamed across chunks; the
        sub-batch size is fixed from the first chunk (power of two)."""
        nonlocal n_seen, sub
        for chunk in chunk_iter:
            n_seen += len(chunk)
            if not chunk:
                continue
            if sub == 0:
                sub = sub_hint or max(8, min(cfg.dp_batch_size,
                                             -(-len(chunk) // 2)))
                sub = 1 << (sub - 1).bit_length()
            buckets: Dict[int, List[PreparedRead]] = defaultdict(list)
            for r in chunk:
                buckets[_length_bucket(len(r.fwd_seq))].append(r)
            for m, bucket_reads in buckets.items():
                step = _fit_batch(sub, m, cfg.band_width)
                for lo in range(0, len(bucket_reads), step):
                    yield (bucket_reads[lo: lo + step],
                           step if len(bucket_reads) > step else 0)

    dp_parts = dp_parts_gen()
    devices = itertools.cycle(_fan_out_devices(cfg, device))

    def dispatch_next():
        """Next in-flight DPBatch, or None at the end of the stream."""
        for part, pad in dp_parts:
            with stage("align_dp", unit="reads") as s:
                dpb = dispatch_dp(part, fasta, cfg, next(devices),
                                  pad_bsz=pad)
                s.add(len(part))
            if dpb is not None:
                return dpb
        return None

    n_ok = 0
    write_errors: List[str] = []
    signal_hist: Dict[int, int] = defaultdict(int)
    workers = _host_workers(cfg)

    def _write_h5py(r, payload):
        pre = None
        if cfg.fast5_compression == "gzip":
            pre = compress_corrected_arrays(
                payload["events"], payload["read_alignment"],
                payload["genome_alignment"])
        try:
            write_corrected_events(r.path, **payload,
                                   basecall_group=cfg.basecall_1d,
                                   compression=cfg.fast5_compression,
                                   precompressed=pre)
            return True
        except OSError:
            write_errors.append(r.path)
            return False

    def write_many(annotated):
        ok = 0
        good = []
        for r, payload, err in annotated:
            if payload is None:
                errors[err].append(r.path)
                continue
            for wnd, cnt in payload.pop("signal_hist", {}).items():
                signal_hist[wnd] += cnt
            good.append((r, payload))
        if use_native_write and good:
            from nanomod_tpu_torch.native.fast5_write_bind import (
                write_corrected_batch_native)
            mask = write_corrected_batch_native(
                [r.path for r, _ in good], [p for _, p in good],
                basecall_group=cfg.basecall_1d, nthreads=workers)
            if mask is None:
                raise RuntimeError("native library 'fast5_write' failed to "
                                   "load")
            ok += int(mask.sum())
            good = [gp for gp, m in zip(good, mask) if not m]
        _h5py_required([r.path for r, _ in good],
                       "corrected write-back of FAST5 the native writer "
                       "declined")
        for r, payload in good:
            ok += _write_h5py(r, payload)
        return ok

    def annotate_batch(dpb):
        """Batched native correction of a fetched DPBatch: returns
        [(read, payload | None, err)]."""
        with stage("traceback", unit="reads") as s:
            codes, best, bi, bk = fetch_outputs(dpb)
            s.add(len(dpb.reads))
        n = len(dpb.reads)
        accept = np.array([best[i] >= _min_score(cfg, int(dpb.lens[i]))
                           for i in range(n)], np.uint8)
        with stage("annotate", unit="reads") as s:
            res = annotate_codes_batch_native(
                codes[:n], bi[:n], bk[:n], accept, dpb.win_starts[:n],
                dpb.reads, fasta, cfg.min_num_signal,
                cfg.resegment_signal_wind, cfg.more_signal_perc,
                nthreads=workers, packed=dpb.packed)
            s.add(n)
        out = []
        for r, (payload, err) in zip(dpb.reads, res):
            if payload is None:
                out.append((r, None,
                            "Not in alignment sam" if err == "skip" else err))
            else:
                out.append((r, payload, ""))
        return out

    def annotate_dp():
        """The bounded window of two DP sub-batches in flight: yields each
        sub-batch's [(read, payload | None, err)] in dispatch order."""
        window = deque()
        for _ in range(2):
            dpb = dispatch_next()
            if dpb is None:
                break
            window.append(dpb)
        while window:
            dpb = window.popleft()
            nxt = dispatch_next()
            if nxt is not None:
                window.append(nxt)
            yield annotate_batch(dpb)

    def annotate_external():
        """One external-aligner round over every prepared read, then the
        per-read correction on a thread pool: yields (read, payload |
        None, err) in read order."""
        nonlocal n_seen
        from nanomod_tpu_torch.resquiggle.external import align_external
        all_prepared = [r for chunk in chunk_iter for r in chunk]
        n_seen += len(all_prepared)
        with stage("align_ext", unit="reads") as s:
            results = align_external(all_prepared, cfg)
            s.add(len(all_prepared))

        def one(args):
            r, (ops, ws) = args
            if ops is None:
                return r, None, "Not in alignment sam"
            payload, err = annotate_one(r, ops, ws, fasta, cfg)
            return r, payload, err
        with ThreadPoolExecutor(max_workers=workers) as ex, \
                stage("annotate", unit="reads") as s:
            yield from ex.map(one, zip(all_prepared, results))
            s.add(len(all_prepared))

    with ThreadPoolExecutor(max_workers=1) as writer:
        pending = []

        def submit(results):
            """Hand the results to the writer in groups of 16."""
            group = []
            for res in results:
                group.append(res)
                if len(group) == 16:
                    pending.append(writer.submit(write_many, group))
                    group = []
            if group:
                pending.append(writer.submit(write_many, group))

        batches = (annotate_dp() if cfg.align == "dp"
                   else [annotate_external()])
        for results in batches:
            submit(results)
        with stage("write", unit="reads") as s:
            for fut in pending:
                n_ok += fut.result()
            s.add(n_seen)
    for p in write_errors:
        errors["Cannot save data"].append(p)
    return n_ok, dict(errors), dict(signal_hist)


def _chunked(paths: List[str], cfg: AnnotateConfig) -> List[List[str]]:
    """Split the file list for the prepare-prefetch pipeline (see the
    reference): chunks of up to files_per_thread, >= 3 chunks, a floor of
    64 files per chunk, and a 32-file ramp-up chunk for runs of >= 192."""
    if not paths:
        return []
    ramp: List[List[str]] = []
    if len(paths) >= 192:
        ramp = [paths[:32]]
        paths = paths[32:]
    chunk_sz = max(64, min(cfg.files_per_thread, -(-len(paths) // 3)))
    return ramp + [paths[lo: lo + chunk_sz]
                   for lo in range(0, len(paths), chunk_sz)]


def _run_chunks(chunks: List[List[str]], cfg: AnnotateConfig,
                fasta: FastaIndex, seed_index: SeedIndex, kmer_model,
                device, progress=None):
    """Drive the chunked pipeline: chunk k+1's prepare runs on a background
    thread while chunk k streams through process_prepared.  Returns
    (n_ok, errors, signal_hist)."""
    from concurrent.futures import ThreadPoolExecutor

    all_errors: Dict[str, List[str]] = defaultdict(list)
    if not chunks:
        return 0, {}, {}
    with ThreadPoolExecutor(max_workers=1) as prefetcher:
        fut = prefetcher.submit(prepare_batch, chunks[0], cfg, seed_index,
                                kmer_model)

        def prepared_iter():
            nonlocal fut
            for ci in range(len(chunks)):
                prepared, errors = fut.result()
                fut = (prefetcher.submit(prepare_batch, chunks[ci + 1], cfg,
                                         seed_index, kmer_model)
                       if ci + 1 < len(chunks) else None)
                for k, v in errors.items():
                    all_errors[k].extend(v)
                if progress is not None:
                    progress(len(chunks[ci]))
                yield prepared

        big = max(len(c) for c in chunks)
        hint = max(8, min(cfg.dp_batch_size, -(-big // 2)))
        n_ok, perrors, chist = process_prepared(prepared_iter(), cfg, fasta,
                                                device, sub_hint=hint)
    for k, v in perrors.items():
        all_errors[k].extend(v)
    return n_ok, dict(all_errors), chist


def _load_inputs(cfg: AnnotateConfig):
    fasta = FastaIndex(cfg.ref_fasta)
    seed_index = SeedIndex(fasta.seqs, k=cfg.seed_k)
    kmer_model = (load_kmer_model(cfg.kmer_model_file)
                  if cfg.kmer_model_file and os.path.isfile(cfg.kmer_model_file)
                  else None)
    return fasta, seed_index, kmer_model


def already_corrected(paths: List[str], cfg: AnnotateConfig) -> List[bool]:
    """Which files already hold the corrected group (Annotate --resume),
    the reference's io/fast5.has_corrected_group: asked of the native
    probe (native/fast5_probe.cpp), and of h5py for the files whose HDF5
    the probe cannot parse (raises where h5py is missing)."""
    from nanomod_tpu_torch.native.probe_bind import has_object_batch
    flags = has_object_batch(
        paths, f"{fast5_io.ANALYSES}/{fast5_io.CORRECTED_GROUP}",
        nthreads=_host_workers(cfg))
    undecided = [p for p, f in zip(paths, flags) if f < 0]
    _h5py_required(undecided, "--resume on FAST5 the native probe declined")
    return [bool(f > 0) or (f < 0 and fast5_io.has_corrected_group(p))
            for p, f in zip(paths, flags)]


def annotate_files(paths: List[str], cfg: AnnotateConfig, device="cuda"):
    """Annotate a batch of FAST5s in place on ``device``.

    Returns (n_ok, errors {key: [paths]}, signalnum histogram).
    """
    import nanomod_tpu_torch
    device = resolve_device(device)
    nanomod_tpu_torch.tune_malloc()
    fasta, seed_index, kmer_model = _load_inputs(cfg)
    return _run_chunks(_chunked(paths, cfg), cfg, fasta, seed_index,
                       kmer_model, device)


def annotate_folder(cfg: AnnotateConfig, device="cuda"):
    """Discover the FAST5s under cfg.wrk_base1 and annotate them on
    ``device``, reporting throughput, the error histogram and the kernels'
    launch counts (in cfg.metrics_file when set; one file a rank under
    several processes, metrics_path).

    Under several processes (torch.distributed) each rank annotates its
    round-robin shard of the file list in place, the analog of the
    reference's SGE fan-out (ref myRefBaseSignalAnnotation.py:1452-1483),
    and the error / histogram report is merged so every rank prints the
    global totals."""
    import time

    import nanomod_tpu_torch
    from nanomod_tpu_torch.utils.observe import observer, report
    from nanomod_tpu_torch.metrics import metrics_path, write_metrics
    from nanomod_tpu_torch.parallel import dist

    device = resolve_device(device)
    nanomod_tpu_torch.tune_malloc()
    observer().reset()
    start = time.time()
    paths = list(iter_fast5_files(cfg.wrk_base1, recursive=cfg.recursive))
    rank, world = dist.process_info()
    if world > 1:
        n_global = len(paths)
        paths = dist.shard_list(paths)
        print(f"Total f5={n_global} (rank {rank}/{world}: {len(paths)})")
    else:
        print(f"Total f5={len(paths)}")
    if cfg.resume:
        n_before = len(paths)
        done_mask = already_corrected(paths, cfg)
        paths = [p for p, d in zip(paths, done_mask) if not d]
        print(f"Resume: {n_before - len(paths)} already annotated, "
              f"{len(paths)} to do")
    fasta, seed_index, kmer_model = _load_inputs(cfg)
    chunks = _chunked(paths, cfg)
    done = 0

    def progress(n: int):
        nonlocal done
        done += n
        dt = time.time() - start
        if cfg.out_level <= 1 and done < len(paths):
            print(f"{done}/{len(paths)} files prepared, "
                  f"{done / max(dt, 1e-9):.1f} files/s")

    total_ok, all_errors, all_hist = _run_chunks(
        chunks, cfg, fasta, seed_index, kmer_model, device,
        progress=progress)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - start
    if world > 1:
        total_ok, all_errors, all_hist = dist.merge_annotate_stats(
            total_ok, all_errors, all_hist)
    if all_hist:
        print("Resegmentation information:")
        for wnd in sorted(all_hist):
            print(f"\t{wnd} {all_hist[wnd]}")
    print("Error information for different fast5 files:")
    for k, v in all_errors.items():
        print(f"\t{k} {len(v)}")
    print(f"Total consuming time {dt:.0f} ({total_ok / max(dt, 1e-9):.1f} reads/s)")
    report(cfg.out_level)
    if cfg.metrics_file:
        write_metrics(metrics_path(cfg.metrics_file, rank, world), device,
                      reads_ok=total_ok, seconds=dt, rank=rank,
                      world_size=world)
    return total_ok, dict(all_errors)

