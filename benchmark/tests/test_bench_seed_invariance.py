"""The seed changes values, never the volume of work: at seeds 0-11 the
cells' inputs hold the same reads, lengths and positions, every tile's
deepest position rounds to the same power of two, and every DownSampling
call makes the same number of attempts."""

from __future__ import annotations

import json
import os

import numpy as np

from benchmark.core import manifest
from benchmark.core.roofline import capacity_bucket
from benchmark.entries.downsampling import call_seed
from benchmark.gen import ecoli_corrected, spel_corrected

SEEDS = range(12)


# the cells' files, whether or not BENCHMARK.json lists the cell yet
FILES = {"ecoli_detect": ("ecoli", "detect_3kb_11x"),
         "spel_downsampling": ("spel_oligo", "downsampling_case1000")}


def _load(workload):
    config, traffic = FILES[workload]
    with open(os.path.join(manifest.BENCH_DIR, "configs",
                           f"{config}.json")) as f:
        return json.load(f), manifest.traffic(traffic)


def _coverage(starts, read_len, glen):
    depth = np.zeros(glen + 1, np.int64)
    np.add.at(depth, starts, 1)
    np.add.at(depth, starts + read_len, -1)
    return np.cumsum(depth)[:-1]


def _ecoli_work(cfg, traffic, seed):
    """(reads a group, per strand: the joined positions and each tile's
    two capacity buckets)."""
    glen, rl = cfg["genome_len"], cfg["read_len"]
    cov = []
    for g in range(2):
        starts = ecoli_corrected.read_starts(
            cfg, traffic, ecoli_corrected.rng(seed, 1 + g))
        cov.append([_coverage(s, rl, glen) for s in starts])
        assert all(len(s) * 2 == ecoli_corrected.read_count(cfg, traffic)
                   for s in starts)
    out = []
    mc = traffic["stats"]["min_coverage"]
    tile = traffic["tile_positions"]
    for si in range(2):
        c1, c2 = cov[0][si], cov[1][si]
        pos = np.flatnonzero((c1 >= mc) & (c2 >= mc))
        buckets = [(capacity_bucket(c1[pos[lo:lo + tile]].max()),
                    capacity_bucket(c2[pos[lo:lo + tile]].max()))
                   for lo in range(0, len(pos), tile)]
        out.append((pos, buckets))
    return out


def test_ecoli_detect_work_is_the_same_at_every_seed():
    cfg, traffic = _load("ecoli_detect")
    first = _ecoli_work(cfg, traffic, 0)
    for pos, buckets in first:
        assert len(pos) > 0.99 * cfg["genome_len"]
        assert set(buckets) == {(16, 16)}
    for seed in SEEDS:
        work = _ecoli_work(cfg, traffic, seed)
        for (p0, b0), (p, b) in zip(first, work):
            assert np.array_equal(p0, p) and b0 == b


def test_ecoli_reads_have_the_configured_lengths():
    cfg, traffic = _load("ecoli_detect")
    small = dict(cfg, genome_len=40000)
    for seed in (0, 11):
        reads = list(ecoli_corrected.group_reads(small, traffic, seed, 1))
        assert len(reads) == ecoli_corrected.read_count(small, traffic)
        assert {len(m) for _, _, m in reads} == {cfg["read_len"]}


def _downsampling_attempts(cfg, traffic, seed, calls=5):
    """Per call, (attempts, [(buckets of the '-' and '+' counts of each
    group)] of each trial): run_downsampling's draws, replayed on the
    reads' strands (every read covers the target)."""
    minus = spel_corrected.strands(cfg) == cfg["target_strand"]
    n, size = len(minus), traffic["case_size"]
    out = []
    for i in range(calls):
        rs = np.random.RandomState(call_seed(seed, i))
        attempts, trials = 0, []
        while len(trials) < traffic["random_times"]:
            attempts += 1
            picks = [rs.choice(n, size, replace=False) for _ in range(2)]
            deep = [int(minus[p].sum()) for p in picks]
            if min(deep) < 0.95 * size / 5:
                continue
            assert max(deep) <= 645 and size - min(deep) <= 645
            trials.append(tuple((capacity_bucket(d), capacity_bucket(size - d))
                                for d in deep))
        out.append((attempts, set(trials)))
    return out


def test_downsampling_work_is_the_same_at_every_seed():
    cfg, traffic = _load("spel_downsampling")
    for seed in SEEDS:
        for attempts, buckets in _downsampling_attempts(cfg, traffic, seed):
            assert attempts == traffic["random_times"]
            assert buckets == {((1024, 512), (1024, 512))}


def test_spel_reads_cover_the_whole_reference():
    cfg, traffic = _load("spel_downsampling")
    for seed in (0, 11):
        reads = list(spel_corrected.group_reads(cfg, traffic, seed, 0))
        assert len(reads) == cfg["reads_per_group"]
        assert sum(s == "-" for s, _, _ in reads) == cfg["minus_reads"]
        assert all(st == 0 and len(m) == cfg["genome_len"]
                   for _, st, m in reads)
