"""The port's position-sharded multi-process merge (parallel/shardmerge.py)
against the JAX package on the CPU.

Thread-fake collectives (a barrier gather and a barrier all-to-all) run
every rank's code path in one process.  The concatenated per-range output
shards of the port must be byte-equal to the JAX package's single-process
run, with the capped KS (row offsets) and the pool capacity cap active, and
every rank must report the JAX package's global top sites; likewise with
--mstd and with the region ranking (RegionRankbyST=1).
"""

import os
import threading

import numpy as np
import pytest

from fixtures import make_corrected_dataset, make_genome
from test_torch_refnative import DETECT_LIBS, require_reference_native
from nanomod_tpu import config as jcfg
from nanomod_tpu.detect import run_detect as jax_run_detect
from nanomod_tpu_torch import config as tcfg
from nanomod_tpu_torch.parallel import shardmerge


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    """The JAX package's native libraries loaded, so that its paths
    here never take their Python fallback (test_torch_refnative.py)."""
    require_reference_native(*DETECT_LIBS)


def _thread_gather(n):
    barrier = threading.Barrier(n)
    slots = [None] * n

    def for_rank(rank):
        def g(x):
            slots[rank] = np.asarray(x)
            barrier.wait()
            out = np.concatenate([slots[i] for i in range(n)])
            barrier.wait()
            return out
        return g
    return for_rank


def _thread_alltoall(n):
    """Rank r deposits [pc, chunk, W] (row d for rank d) and receives
    [pc, chunk, W] (row s from rank s)."""
    barrier = threading.Barrier(n)
    slots = [None] * n

    def for_rank(rank):
        def a2a(send, send_counts=None):
            slots[rank] = np.asarray(send)
            barrier.wait()
            out = np.stack([slots[s][rank] for s in range(n)])
            barrier.wait()
            return out
        return a2a
    return for_rank


def _run_ranks(n, fn):
    gather_for = _thread_gather(n)
    a2a_for = _thread_alltoall(n)
    results, errors = [None] * n, []

    def worker(rank):
        try:
            results[rank] = fn(rank, gather_for(rank), a2a_for(rank))
        except BaseException as e:
            errors.append(e)
            raise

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]
    return results


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_shardmerge"))
    chrom, genome = make_genome(length=400, seed=7)
    make_corrected_dataset(os.path.join(root, "control"), chrom, genome,
                           n_reads=24, seed=1)
    make_corrected_dataset(os.path.join(root, "case"), chrom, genome,
                           n_reads=24, seed=2, mod_pos=173, mod_delta=1.0)
    return root


def _cfg(mod, root, out, **kw):
    rank = kw.pop("rank", mod.RankConfig(window=4))
    return mod.DetectConfig(
        wrk_base1=os.path.join(root, "control"),
        wrk_base2=os.path.join(root, "case"),
        out_folder=out, file_id="sm", min_lr=0,
        # the order- and offset-sensitive paths: capped KS + pool cap
        stats=mod.StatConfig(coverages=(12, 12), downsampling=10,
                             downsampling_quantile=0.25),
        pool_capacity=16, rank=rank, **kw)


def _sites(sites):
    return [(s.chrom, s.strand, s.pos, s.base) for s in sites]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _sharded(dataset, out, n_hosts, **kw):
    return _run_ranks(n_hosts, lambda rank, g, a:
                      shardmerge.distributed_detect_sharded(
                          _cfg(tcfg, dataset, out, **kw), gather=g,
                          alltoall=a, process_count=n_hosts,
                          process_index=rank, device="cpu"))


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_sharded_detect_equals_jax_single_host(dataset, tmp_path, n_hosts):
    single = str(tmp_path / "jax")
    table, _, want_sites = jax_run_detect(_cfg(jcfg, dataset, single))
    want = _read(os.path.join(single, "sm_sign_test.txt"))
    assert len(want) > 1000

    out = str(tmp_path / f"torch{n_hosts}")
    res = _sharded(dataset, out, n_hosts)
    assert _read(os.path.join(out, "sm_sign_test.txt")) == want
    assert not [f for f in os.listdir(out) if "@shard" in f]
    assert sum(len(t) for t, _, _ in res) == len(table)
    for _, _, sites in res:
        assert _sites(sites) == _sites(want_sites)


def test_sharded_detect_mstd_equals_jax(dataset, tmp_path):
    single = str(tmp_path / "jax")
    jax_run_detect(_cfg(jcfg, dataset, single, mstd=True))
    out = str(tmp_path / "torch")
    _sharded(dataset, out, 2, mstd=True)
    for name in ("sm_sign_test.txt", "sm_meanstd.cvs"):
        want = _read(os.path.join(single, name))
        assert len(want) > 100
        assert _read(os.path.join(out, name)) == want


@pytest.mark.parametrize("wind_ovlp", [0, 1])
def test_sharded_region_rank_equals_jax(dataset, tmp_path, wind_ovlp):
    kw = dict(window=4, region_rank_by_st=1, wind_ovlp=wind_ovlp)
    single = str(tmp_path / "jax")
    _, _, want_sites = jax_run_detect(
        _cfg(jcfg, dataset, single, rank=jcfg.RankConfig(**kw)))
    assert len(want_sites) > 2
    out = str(tmp_path / "torch")
    res = _sharded(dataset, out, 3, rank=tcfg.RankConfig(**kw))
    for _, _, sites in res:
        assert _sites(sites) == _sites(want_sites)
    assert _read(os.path.join(out, "sm_sign_test.txt")) == \
        _read(os.path.join(single, "sm_sign_test.txt"))


def _pdf_pages(path):
    """Pages of a PDF (a copy of tests/test_shardmerge.py's)."""
    with open(path, "rb") as f:
        data = f.read()
    return data.count(b"/Type /Page") - data.count(b"/Type /Pages")


def test_sharded_detect_plots_match_jax_pages(dataset, tmp_path):
    """make_plots under the sharded merge: the owners of the top sites
    gather their window data to rank 0, which draws one
    rplot_<FileID>.pdf with as many pages as the JAX package's
    single-host run."""
    single = str(tmp_path / "jax")
    jax_run_detect(_cfg(jcfg, dataset, single, make_plots=True))
    want = _pdf_pages(os.path.join(single, "rplot_sm.pdf"))
    assert want > 0
    out = str(tmp_path / "torch")
    _sharded(dataset, out, 2, make_plots=True)
    assert _pdf_pages(os.path.join(out, "rplot_sm.pdf")) == want


def test_plan_refuses_a_small_coordinate_space():
    from nanomod_tpu_torch.accum.pools import PoolBuilder
    b = PoolBuilder()
    b.add_read("c", "+", 0, np.zeros(20, np.float32),
               np.array([b"A"] * 20, "S1"))
    with pytest.raises(ValueError, match="too small"):
        shardmerge.plan_position_shards([b.finalize()], halo=2,
                                        gather=lambda x: np.asarray(x),
                                        process_count=2, process_index=0)


def test_records_round_trip():
    rng = np.random.default_rng(0)
    kid = rng.integers(0, 5, 50).astype(np.int32)
    pos = rng.integers(0, 2 ** 31 - 1, 50).astype(np.int64)
    val = rng.normal(0, 1, 50).astype(np.float32)
    cod = rng.integers(-1, 5, 50).astype(np.int8)
    rec = shardmerge._pack_records(kid, pos, val, cod)
    assert rec.shape == (50, 13)
    for a, b in zip(shardmerge._unpack_records(rec), (kid, pos, val, cod)):
        np.testing.assert_array_equal(a, b)
