"""The Annotate pipeline: raw FAST5 -> indel-corrected per-base annotation.

Port of nanomod_tpu/resquiggle/pipeline.py for one device in one process.
Reads are k-mer seeded (resquiggle/seed.py), aligned by the banded affine
DP on the device (kernel K1), their tracebacks walked on the device (kernel
K2) so that only 2-bit op codes come back, then corrected and assembled by
the native core (annotate_core.cpp) and written back into each FAST5 by the
native writer (fast5_write.cpp).  The FAST5 parsers and writers are the
repo's own C++ (no libhdf5); h5py, where installed, only serves files the
native code declines, and where it is missing such a file raises.

Differences from the reference: host-to-device copies go from pinned memory
with ``non_blocking=True``; the packed result comes back by a non-blocking
copy into pinned memory behind a ``torch.cuda.Event`` that
``fetch_outputs`` waits on; the device-walk path (``use_device_walk``,
the walk's codes packed four a byte, mode "codes2") is the only alignment
path; ``n_devices > 1``, multi-host runs and the external aligners raise
NotImplementedError.
"""

from __future__ import annotations

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


def _check_supported(cfg: AnnotateConfig, device):
    """Raise for the reference options this port does not run.  The band
    width: the walk packs its 2M + W codes four a byte (the buckets make
    2M a multiple of 4), and K1 and K2 take W lanes 32 to a warp."""
    w = cfg.band_width
    if torch.device(device).type == "cuda":
        if w % 32 or not 32 <= w <= 1024:
            raise NotImplementedError(
                f"band_width={w}: the CUDA kernels take a multiple of 32 "
                f"in [32, 1024]")
    elif w % 4 or w < 4:
        raise NotImplementedError(
            f"band_width={w}: the packed walk takes a multiple of 4")
    if cfg.align != "dp":
        raise NotImplementedError(
            f"align={cfg.align!r}: external aligners are not ported")
    if not (cfg.use_native and cfg.use_device_walk):
        raise NotImplementedError(
            "only the native, device-walk Annotate path is ported "
            "(use_native=True, use_device_walk=True)")
    if cfg.n_devices and cfg.n_devices > 1:
        raise NotImplementedError(
            "n_devices > 1: multi-GPU Annotate fan-out is not ported")


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
                          norm, seed_index.best_band(ev.seq))


def _wrap_with_hit(path, read_id, seq, ev_start, ev_length, norm_signal,
                   hit):
    """Build the PreparedRead for a seeded read."""
    if hit is None or hit.votes < 3:
        return None, "Not in alignment sam"
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
                                     r.ev_length, r.norm_signal, hits[i])
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
    host: torch.Tensor          # [B, 12 + .] uint8 (banded.pack_outputs)
    event: Optional[object]     # torch.cuda.Event, None on the CPU
    tail_shape: tuple           # per-read packed code shape
    lens: np.ndarray
    win_starts: np.ndarray


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
    read_codes = np.full((bsz, m), 4, np.uint8)
    ref_codes = np.full((bsz, m + w), 5, np.uint8)
    lens = np.zeros(bsz, np.int32)
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

    tb, best, bi, bk = banded.banded_sw(
        to_device(read_codes, device), to_device(ref_codes, device),
        to_device(lens, device),
        match=cfg.match_score, mismatch=cfg.mismatch_score,
        go=cfg.gap_open, ge=cfg.gap_extend,
    )
    codes = banded.walk_packed(tb, bi, bk)    # the buckets give 4 | 2M+W
    packed = banded.pack_outputs(codes, best, bi, bk)
    event = None
    host = packed
    if device.type == "cuda":
        host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return DPBatch(reads, host, event, tuple(codes.shape[1:]), lens,
                   win_starts)


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
        packed=True)
    out = []
    for i in range(n):
        if best[i] < _min_score(cfg, int(batch.lens[i])):
            out.append((None, int(batch.win_starts[i])))
        else:
            out.append((ops_all[i], int(batch.win_starts[i])))
    return out


def process_prepared(prepared, cfg: AnnotateConfig, fasta: FastaIndex,
                     device, sub_hint: int = 0):
    """Align + correct + write back prepared reads on ``device``.

    ``prepared`` is a list OR an iterator of lists (streamed chunks from
    the prepare prefetcher).  Each chunk's length buckets are split into
    sub-batches and a bounded window of two DP sub-batches stays in flight
    across chunk boundaries: the device computes sub-batch k+1 while the
    host corrects k; the FAST5 write-back runs on a background thread.
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
            for bucket_reads in buckets.values():
                for lo in range(0, len(bucket_reads), sub):
                    yield (bucket_reads[lo: lo + sub],
                           sub if len(bucket_reads) > sub else 0)

    dp_parts = dp_parts_gen()

    def dispatch_next():
        """Next in-flight DPBatch, or None at the end of the stream."""
        for part, pad in dp_parts:
            with stage("align_dp", unit="reads") as s:
                dpb = dispatch_dp(part, fasta, cfg, device, pad_bsz=pad)
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
                nthreads=workers, packed=True)
            s.add(n)
        out = []
        for r, (payload, err) in zip(dpb.reads, res):
            if payload is None:
                out.append((r, None,
                            "Not in alignment sam" if err == "skip" else err))
            else:
                out.append((r, payload, ""))
        return out

    with ThreadPoolExecutor(max_workers=1) as writer:
        pending = []
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
            results = annotate_batch(dpb)
            for lo in range(0, len(results), 16):
                pending.append(writer.submit(write_many, results[lo:lo + 16]))
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
    launch counts (in cfg.metrics_file when set)."""
    import time

    import nanomod_tpu_torch
    from nanomod_tpu_torch.utils.observe import observer, report
    from nanomod_tpu_torch.metrics import write_metrics

    device = resolve_device(device)
    nanomod_tpu_torch.tune_malloc()
    observer().reset()
    start = time.time()
    paths = list(iter_fast5_files(cfg.wrk_base1, recursive=cfg.recursive))
    print(f"Total f5={len(paths)}")
    if cfg.resume:
        _h5py_required(paths, "--resume")
        from nanomod_tpu_torch.io.fast5 import has_corrected_group
        n_before = len(paths)
        paths = [p for p in paths if not has_corrected_group(p)]
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
        write_metrics(cfg.metrics_file, device, reads_ok=total_ok,
                      seconds=dt)
    return total_ok, dict(all_errors)

