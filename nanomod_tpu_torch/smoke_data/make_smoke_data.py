"""Write the raw FAST5 set that chip_smoke.py annotates and tests.

The machine with the card has no h5py, so the inputs are made here once and
committed: a 1,000-bp synthetic genome (``ref.fa``), a control group and a
case group of 16 raw reads each (read length 900, 2 % basecall errors), the
case shifted by 6 pA at MOD_POS and by half that at its two neighbours.
Datasets are gzip-compressed, which the native reader
(nanomod_tpu_torch/native/fast5_ingest.cpp) inflates.  Signal, events and layout
come from tests/fixtures.py (simulate_raw_read, the albacore-2 layout).

    python nanomod_tpu_torch/smoke_data/make_smoke_data.py
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

GENOME_LEN = 1000
GENOME_SEED = 11
MOD_POS = 500            # 0-based genome coordinate of the planted shift
N_READS = 16
READ_LEN = 900
ERROR_RATE = 0.02
MOD_DELTA_PA = 6.0


def _write_read(path, seq, rng, read_number, **kw):
    """tests/fixtures.write_raw_fixture with gzip-compressed datasets."""
    import h5py

    import fixtures as fx
    dac, events, bc_seq = fx.simulate_raw_read(seq, rng, **kw)
    gz = dict(compression="gzip", compression_opts=6)
    with h5py.File(path, "w") as f:
        ch = f.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["digitisation"] = fx.DIGITISATION
        ch.attrs["offset"] = fx.OFFSET
        ch.attrs["range"] = fx.RANGE
        ch.attrs["sampling_rate"] = fx.SAMPLING_RATE
        ch.attrs["channel_number"] = b"1"
        rg = f.create_group(f"Raw/Reads/Read_{read_number}")
        rg.attrs["start_time"] = 0
        rg.attrs["read_id"] = f"read-{read_number:06d}-{os.path.basename(path)}"
        rg.create_dataset("Signal", data=dac, **gz)
        bc = f.create_group("Analyses/Basecall_1D_000")
        bc.attrs["name"] = b"ONT Albacore Sequencing Software"
        bc.attrs["version"] = b"2.3.1"
        bt = bc.create_group("BaseCalled_template")
        bt.create_dataset("Events", data=events, **gz)
        fq = f"@read-{read_number:06d}\n{bc_seq}\n+\n{'!' * len(bc_seq)}\n"
        bt.create_dataset("Fastq", data=fq.encode())


def _group(folder, chrom, genome, seed, mod_pos=None, mod_delta_pa=0.0):
    """tests/fixtures.make_raw_dataset's read layout, gzip datasets."""
    from nanomod_tpu_torch.io.fasta import revcomp
    rng = np.random.default_rng(seed)
    os.makedirs(folder)
    for i in range(N_READS):
        strand = "+-"[i % 2]
        start = int(rng.integers(0, len(genome) - READ_LEN + 1))
        seq = genome[start:start + READ_LEN]
        mod_offsets = None
        if mod_pos is not None and start <= mod_pos < start + READ_LEN:
            center = mod_pos - start
            if strand == "-":
                center = READ_LEN - 1 - center
            mod_offsets = {center - 1: 0.5, center: 1.0, center + 1: 0.5}
        if strand == "-":
            seq = revcomp(seq)
        _write_read(os.path.join(folder, f"raw_{i:04d}.fast5"), seq, rng, i,
                    mod_offsets=mod_offsets, mod_delta_pa=mod_delta_pa,
                    error_rate=ERROR_RATE)


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import fixtures as fx
    chrom, genome = fx.make_genome(length=GENOME_LEN, seed=GENOME_SEED)
    for sub in ("ctrl", "case"):
        shutil.rmtree(os.path.join(HERE, sub), ignore_errors=True)
    with open(os.path.join(HERE, "ref.fa"), "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    _group(os.path.join(HERE, "ctrl"), chrom, genome, seed=10)
    _group(os.path.join(HERE, "case"), chrom, genome, seed=20,
           mod_pos=MOD_POS, mod_delta_pa=MOD_DELTA_PA)


if __name__ == "__main__":
    main()
