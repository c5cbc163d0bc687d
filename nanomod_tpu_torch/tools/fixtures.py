"""Synthetic nanopore datasets for the port's bench, without h5py.

The generators of the reference's tests/fixtures.py, draw for draw (the
same ``default_rng`` seeds, the same calls in the same order), so that a
seed gives the reference's reads.  The files are written by the port's
native writers instead of h5py, which the card's machine does not have:

  * corrected FAST5s (NanomoCorrected_000): an HDF5 file holding only its
    root group (native/fast5_rawwrite.cpp ``rw_write_empty``), filled by
    the corrected writer (native/fast5_write.cpp), as the reference
    creates an empty file with h5py and writes into it;
  * raw + basecalled FAST5s (albacore-2 Events, Fastq, the channel's
    calibration and number, the read's start time and id): the raw writer
    (native/fast5_rawwrite.cpp).

Read back with h5py, the files hold the reference's datasets and
attributes (tests/test_torch_bench.py).

Signal model: each (position, strand) has a deterministic "clean" normalized
level; reads observe it with Gaussian noise; modified reads shift the level
at the target site (and half as much at its two neighbors).
"""

from __future__ import annotations

import functools
import hashlib
import os

import numpy as np

from nanomod_tpu_torch.io.fast5 import CORRECTED_EVENTS_DTYPE
from nanomod_tpu_torch.io.fasta import revcomp
from nanomod_tpu_torch.native.fast5_rawwrite_bind import (
    ALBACORE2_EVENT_DTYPE, write_empty, write_raw_batch)
from nanomod_tpu_torch.native.fast5_write_bind import (
    write_corrected_batch_native)

BASES = np.array(list("ACGT"))

# channel calibration used by all raw fixtures
DIGITISATION = 8192.0
RANGE = 1400.0
OFFSET = 10.0
SAMPLING_RATE = 4000.0


def make_genome(length=400, seed=7, name="spel"):
    rng = np.random.default_rng(seed)
    return name, "".join(rng.choice(BASES, size=length))


def clean_level(chrom: str, pos: int, strand: str) -> float:
    """Deterministic pseudo-random normalized level in [-2, 2]."""
    h = hashlib.md5(f"{chrom}:{pos}:{strand}".encode()).digest()
    return (int.from_bytes(h[:4], "little") / 2 ** 32) * 4.0 - 2.0


def simulate_corrected_read(chrom, genome, strand, start, length, rng,
                            mod_pos=None, mod_delta=0.0, noise=0.3):
    """Per-base normalized means for a read covering [start, start+length).

    Returns events in STORED order (genome-descending for '-' strand, as
    the corrected writer stores them).
    """
    gpos = np.arange(start, start + length)
    means = np.array([clean_level(chrom, p, strand) for p in gpos])
    means = means + rng.normal(0.0, noise, size=length)
    if mod_pos is not None:
        for off, scale in ((-1, 0.5), (0, 1.0), (1, 0.5)):
            tp = mod_pos + off
            if start <= tp < start + length:
                means[tp - start] += mod_delta * scale
    seq = genome[start:start + length]
    if strand == "-":
        # stored order: genome-descending; base column = '-' strand base
        means = means[::-1]
        bases = np.array(list(revcomp(seq)), dtype="S1")
    else:
        bases = np.array(list(seq), dtype="S1")
    ev = np.zeros(length, dtype=CORRECTED_EVENTS_DTYPE)
    ev["norm_mean"] = np.round(means, 3)
    ev["norm_stdev"] = 0.1
    ev["start"] = np.arange(length, dtype=np.uint32) * 8
    ev["length"] = 8
    ev["base"] = bases
    return ev


def make_corrected_dataset(folder, chrom, genome, n_reads, seed,
                           mod_pos=None, mod_delta=0.0, read_len=None,
                           noise=0.3, n_subfolders=1, strands="+-"):
    """A group folder of corrected FAST5s, reads tiling the genome."""
    rng = np.random.default_rng(seed)
    glen = len(genome)
    read_len = read_len or glen
    os.makedirs(folder, exist_ok=True)
    paths, payloads = [], []
    for i in range(n_reads):
        sub = os.path.join(folder, str(i % n_subfolders))
        os.makedirs(sub, exist_ok=True)
        strand = strands[i % len(strands)]
        start = 0 if read_len >= glen else int(rng.integers(0, glen - read_len + 1))
        length = min(read_len, glen - start)
        ev = simulate_corrected_read(chrom, genome, strand, start, length,
                                     rng, mod_pos=mod_pos,
                                     mod_delta=mod_delta, noise=noise)
        paths.append(os.path.join(sub, f"read_{i:04d}.fast5"))
        payloads.append(dict(
            chrom=chrom, start=start, strand=strand, events=ev,
            read_alignment=ev["base"], genome_alignment=ev["base"],
            clipped_start=0, clipped_end=0, num_insertions=0,
            num_deletions=0, num_matches=length, num_mismatches=0))
    # each file first holds only its root group, as h5py.File(path, "w")
    # leaves it; the native corrected writer then adds the corrected group
    for p in paths:
        write_empty(p)
    ok = write_corrected_batch_native(paths, payloads, nthreads=8)
    if ok is None or not ok.all():
        raise RuntimeError("the native corrected writer declined a fixture "
                           "file")
    return paths


# ---------------------------------------------------------------------------
# Raw + basecalled fixtures (Annotate inputs)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def kmer_level_pa(kmer: str) -> float:
    """Deterministic 5-mer pore level in pA (~ N(100, 15)); a pure
    function of the k-mer, so its values are kept."""
    h = hashlib.md5(kmer.encode()).digest()
    u = int.from_bytes(h[:4], "little") / 2 ** 32
    v = int.from_bytes(h[4:8], "little") / 2 ** 32
    # Box-Muller for a stable pseudo-normal
    z = np.sqrt(-2 * np.log(max(u, 1e-12))) * np.cos(2 * np.pi * v)
    return 100.0 + 15.0 * float(np.clip(z, -3, 3))


def model_state_for(seq: str, i: int) -> str:
    lo = i - 2
    hi = i + 3
    pad_l = max(0, -lo)
    pad_r = max(0, hi - len(seq))
    return "N" * pad_l + seq[max(lo, 0):min(hi, len(seq))] + "N" * pad_r


def simulate_raw_read(seq: str, rng, mod_offsets=None, mod_delta_pa=0.0,
                      dwell_mean=9, noise_pa=1.5, error_rate=0.0):
    """Raw DAC signal + albacore2-style event table for basecall `bc_seq`.

    With error_rate > 0 the basecalled sequence differs from `seq` by random
    substitutions/insertions/deletions — exercising the indel-correction
    path of the resquiggle engine.
    Returns (dac int16 array, events structured array, bc_seq).
    """
    # basecall errors relative to the true sequence
    bc = []
    true_pos = []           # index into seq emitting each called base
    i = 0
    while i < len(seq):
        r = rng.random()
        if r < error_rate / 3:                       # deletion
            i += 1
            continue
        if r < 2 * error_rate / 3:                   # insertion
            bc.append(str(rng.choice(BASES)))
            true_pos.append(i)
        if rng.random() < error_rate / 3:            # substitution
            bc.append(str(rng.choice(BASES)))
        else:
            bc.append(seq[i])
        true_pos.append(i)
        i += 1
    # keep bc/true_pos aligned 1:1 (insertion above appended an extra)
    bc_seq = "".join(bc)
    if len(true_pos) != len(bc_seq):
        true_pos = true_pos[: len(bc_seq)]

    # raw signal: per called base, dwell samples at the 5-mer level
    dwells = np.maximum(rng.poisson(dwell_mean, size=len(bc_seq)), 4)
    sig = []
    starts = np.zeros(len(bc_seq), dtype=np.uint64)
    pos = 0
    for j, b in enumerate(bc_seq):
        kmer = model_state_for(bc_seq, j)
        level = kmer_level_pa(kmer)
        if mod_offsets and true_pos[j] in mod_offsets:
            level += mod_delta_pa * mod_offsets[true_pos[j]]
        starts[j] = pos
        sig.append(rng.normal(level, noise_pa, size=dwells[j]))
        pos += int(dwells[j])
    signal_pa = np.concatenate(sig)

    events = np.zeros(len(bc_seq), dtype=ALBACORE2_EVENT_DTYPE)
    events["start"] = starts
    events["length"] = dwells
    events["move"] = 1
    events["move"][0] = 0          # first row conventionally move 0 or 1
    for j in range(len(bc_seq)):
        s = int(starts[j]); e = s + int(dwells[j])
        events["mean"][j] = signal_pa[s:e].mean()
        events["stdv"][j] = signal_pa[s:e].std()
        events["model_state"][j] = model_state_for(bc_seq, j).encode()

    dac = np.round(signal_pa * DIGITISATION / RANGE - OFFSET).astype(np.int16)
    return dac, events, bc_seq


def raw_fixture_read(path, seq, rng, read_number=0, **kw):
    """The content of one raw FAST5 (channel info, Raw signal, albacore2
    basecalls), as the reference's write_raw_fixture writes it: the
    raw writer's read dict."""
    dac, events, bc_seq = simulate_raw_read(seq, rng, **kw)
    fq = f"@read-{read_number:06d}\n{bc_seq}\n+\n{'!' * len(bc_seq)}\n"
    return dict(read_number=read_number,
                read_id=f"read-{read_number:06d}-{os.path.basename(path)}",
                signal=dac, events=events, fastq=fq.encode(),
                channel=(DIGITISATION, OFFSET, RANGE, SAMPLING_RATE),
                channel_number=b"1", start_time=0)


def make_raw_dataset(folder, chrom, genome, n_reads, seed, mod_pos=None,
                     mod_delta_pa=0.0, read_len=None, error_rate=0.02,
                     strands="+-"):
    """Raw FAST5 group; reads are subsequences of the genome (either strand),
    with optional level shift at mod_pos (genome coordinate)."""
    rng = np.random.default_rng(seed)
    glen = len(genome)
    read_len = read_len or glen
    os.makedirs(folder, exist_ok=True)
    paths, reads = [], []
    for i in range(n_reads):
        strand = strands[i % len(strands)]
        start = 0 if read_len >= glen else int(rng.integers(0, glen - read_len + 1))
        length = min(read_len, glen - start)
        seq = genome[start:start + length]
        mod_offsets = None
        if mod_pos is not None and start <= mod_pos < start + length:
            center = mod_pos - start
            if strand == "-":
                center = length - 1 - center
            mod_offsets = {center - 1: 0.5, center: 1.0, center + 1: 0.5}
        if strand == "-":
            seq = revcomp(seq)
        p = os.path.join(folder, f"raw_{i:04d}.fast5")
        reads.append(raw_fixture_read(p, seq, rng, read_number=i,
                                      mod_offsets=mod_offsets,
                                      mod_delta_pa=mod_delta_pa,
                                      error_rate=error_rate))
        paths.append(p)
    write_raw_batch(paths, reads)
    return paths
