# Copied from nanomod_tpu_torch/tools/fixtures.py (make_corrected_dataset, simulate_corrected_read); levels drawn as tools/scale_run.py draws them, and each read's strand fixed by the configuration.
"""The SPEL oligo simulation's two groups of corrected FAST5 reads.

Every read covers the whole reference (the simulation's unit), so every
position of a strand has as many observations as the group has reads on
that strand.  Which reads lie on '-' is fixed by the configuration
(``minus_reads`` of ``reads_per_group``, spread evenly over the file
order); the reference's bases, the two strands' level tracks and each
read's level noise are drawn from the seed.  The case group carries a
level shift at the known site (``target_pos`` on ``target_strand``, half
as much at its two neighbours).
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.gen.ecoli_corrected import BASES, payload, rng

GROUPS = ("case", "ctrl")          # DownSampling's wrk_base1, wrk_base2


def strands(cfg: dict) -> np.ndarray:
    """'+' or '-' of each read of a group, in file order."""
    n, m = cfg["reads_per_group"], cfg["minus_reads"]
    i = np.arange(n)
    minus = (i + 1) * m // n > i * m // n
    return np.where(minus, "-", "+")


def genome(cfg: dict, seed: int):
    r = rng(seed, 0)
    glen = cfg["genome_len"]
    return r.choice(BASES, glen), r.normal(0.0, 1.0, (2, glen))


def group_reads(cfg: dict, traffic: dict, seed: int, group: int,
                world=None):
    """Yield the reads of one group in file order: (strand, 0, the
    per-base means in genome order, float64, rounded to 3 decimals)."""
    bases, levels = world or genome(cfg, seed)
    glen = cfg["genome_len"]
    tpos, tstrand = cfg["target_pos"], cfg["target_strand"]
    r = rng(seed, 1 + group)
    for strand in strands(cfg):
        means = levels["+-".index(strand)] + r.normal(0.0, traffic["noise"],
                                                       glen)
        if GROUPS[group] == "case" and strand == tstrand:
            for off, scale in ((-1, 0.5), (0, 1.0), (1, 0.5)):
                means[tpos + off] += traffic["mod_delta"] * scale
        yield str(strand), 0, np.round(means, 3)


def write(cfg: dict, traffic: dict, seed: int, out: str, nthreads: int):
    """Write both groups under ``out``; returns {group: folder}."""
    from benchmark.gen.corrected_files import write_corrected
    world = genome(cfg, seed)
    folders = {}
    for g, name in enumerate(GROUPS):
        folder = os.path.join(out, name)
        batch = []
        for i, (strand, start, means) in enumerate(
                group_reads(cfg, traffic, seed, g, world)):
            batch.append((os.path.join(folder, f"r{i:05d}.fast5"),
                          payload(cfg, strand, start, means, world[0])))
            if len(batch) == 256:
                write_corrected(batch, nthreads)
                batch = []
        if batch:
            write_corrected(batch, nthreads)
        folders[name] = folder
    return folders
