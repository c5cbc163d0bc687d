# Copied from nanomod_tpu_torch/tools/scale_run.py (genome, gen_group); the read starts lie on a layout that the configuration fixes, with bounded jitter from the seed.
"""Two groups of corrected FAST5 reads over a synthetic genome slice.

The genome's bases, the two strands' level tracks, the planted sites, each
read's jitter and its level noise are drawn from the seed.  The volume of
work is not: every strand of every group holds the same reads, at
``k * read_step`` plus a jitter in ``[0, jitter)`` (none for the
``fixed_edge_reads`` at either end, so that the coverage ramps at the ends
of the slice, and with them the positions that pass detect's coverage
filter, do not move), each ``read_len`` bases long.  Inside the slice a
position is covered by 10 to 13 reads a strand and group, so every tile's
deepest position rounds to the same power of two at every seed.

Files are written as the port's corrected writer writes them
(``tools/fixtures.py``): a file holding only its root group, then the
corrected group.  They are named so that their sorted order is the read
order.
"""

from __future__ import annotations

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = np.frombuffer(b"TGCA", np.uint8)
GROUPS = ("ctrl", "case")          # detect's wrk_base1, wrk_base2
WRITE_BATCH = 256


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), stream])


def layout(cfg: dict, traffic: dict):
    """(the read starts of one strand before jitter, which reads take
    jitter): the same for every strand, group and seed."""
    glen, rl, step = cfg["genome_len"], cfg["read_len"], cfg["read_step"]
    jit, edge = traffic["jitter"], traffic["fixed_edge_reads"]
    n = (glen - rl - jit) // step + 1
    base = np.arange(n, dtype=np.int64) * step
    moves = np.ones(n, bool)
    moves[:edge] = False
    moves[-edge:] = False
    return base, moves


def genome(cfg: dict, traffic: dict, seed: int):
    """(bases u8, level tracks [2, G] for '+' and '-', planted sites)."""
    glen, rl = cfg["genome_len"], cfg["read_len"]
    r = rng(seed, 0)
    bases = r.choice(BASES, glen)
    levels = r.normal(0.0, 1.0, (2, glen))
    planted = np.sort(r.choice(np.arange(rl, glen - rl),
                               traffic["planted_sites"], replace=False))
    return bases, levels, planted


def read_starts(cfg: dict, traffic: dict, r: np.random.Generator):
    """Each strand's read starts of one group: the layout and its jitter,
    the first draws of the group's generator."""
    base, moves = layout(cfg, traffic)
    return [base + r.integers(0, traffic["jitter"], len(base)) * moves
            for _ in "+-"]


def group_reads(cfg: dict, traffic: dict, seed: int, group: int,
                world=None):
    """Yield the reads of one group in file order: (strand, start, the
    per-base means in genome order, float64, rounded to 3 decimals)."""
    bases, levels, planted = world or genome(cfg, traffic, seed)
    rl = cfg["read_len"]
    r = rng(seed, 1 + group)
    starts = read_starts(cfg, traffic, r)
    for si, strand in enumerate("+-"):
        for start in starts[si]:
            start = int(start)
            means = levels[si, start:start + rl] + r.normal(
                0.0, traffic["noise"], rl)
            if group == 1:
                # full shift at a planted site, half at +-1
                lo, hi = np.searchsorted(planted, [start - 1, start + rl + 1])
                for tp in planted[lo:hi]:
                    for off, scale in ((-1, 0.5), (0, 1.0), (1, 0.5)):
                        if start <= tp + off < start + rl:
                            means[tp + off - start] += \
                                traffic["mod_delta"] * scale
            yield strand, start, np.round(means, 3)


def read_count(cfg: dict, traffic: dict) -> int:
    """Reads of one group."""
    return 2 * len(layout(cfg, traffic)[0])


def file_path(folder: str, i: int) -> str:
    return os.path.join(folder, f"d{i // 4000:03d}", f"r{i:06d}.fast5")


def payload(cfg: dict, strand: str, start: int, means, bases):
    """The corrected writer's payload of one read (stored order:
    genome-descending on '-', as the writer stores it)."""
    from nanomod_tpu_torch.io.fast5 import CORRECTED_EVENTS_DTYPE
    rl = len(means)
    gpos = np.arange(start, start + rl)
    ev = np.zeros(rl, CORRECTED_EVENTS_DTYPE)
    if strand == "-":
        ev["norm_mean"] = means[::-1]
        ev["base"] = COMP[np.searchsorted(BASES, bases[gpos[::-1]])].view(
            "S1")
    else:
        ev["norm_mean"] = means
        ev["base"] = bases[gpos].view("S1")
    ev["norm_stdev"] = 0.1
    ev["start"] = np.arange(rl, dtype=np.uint32) * 8
    ev["length"] = 8
    return dict(chrom=cfg["chrom"], start=start, strand=strand, events=ev,
                read_alignment=ev["base"], genome_alignment=ev["base"],
                clipped_start=0, clipped_end=0, num_insertions=0,
                num_deletions=0, num_matches=rl, num_mismatches=0)


def write(cfg: dict, traffic: dict, seed: int, out: str, nthreads: int):
    """Write both groups under ``out``; returns {group: folder}."""
    from benchmark.gen.corrected_files import write_corrected
    world = genome(cfg, traffic, seed)
    folders = {}
    for g, name in enumerate(GROUPS):
        folder = os.path.join(out, name)
        batch = []
        for i, (strand, start, means) in enumerate(
                group_reads(cfg, traffic, seed, g, world)):
            batch.append((file_path(folder, i),
                          payload(cfg, strand, start, means, world[0])))
            if len(batch) == WRITE_BATCH:
                write_corrected(batch, nthreads)
                batch = []
        if batch:
            write_corrected(batch, nthreads)
        folders[name] = folder
    return folders
