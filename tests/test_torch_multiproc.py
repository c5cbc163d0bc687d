"""The port's multi-process paths over real torch.distributed (gloo) on the
CPU: two ``nanomod_tpu_torch.cli`` processes, each given the environment
torchrun sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT on
127.0.0.1), run

  * detect, union merge: every rank's ``_sign_test.txt`` byte-equal to the
    JAX package's single-process run, rank 0's plots with the JAX
    package's page count, one ``--profileDir`` trace a rank;
  * detect, position-sharded merge with the capped KS and the pool cap:
    the concatenated file byte-equal to the JAX package's single-process
    run, the same global rank 1 on both ranks, the plots gathered to rank
    0 with the JAX package's page count;
  * Annotate: each rank corrects its file shard in place; every corrected
    FAST5 byte-equal to the JAX package's single-process Annotate, and
    both ranks report the merged ok count.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import pytest

from fixtures import make_corrected_dataset, make_genome, make_raw_dataset
from test_torch_refnative import ALL_LIBS, require_reference_native
from nanomod_tpu import config as jcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    """The JAX package's native libraries loaded, so that its paths
    here never take their Python fallback (test_torch_refnative.py)."""
    require_reference_native(*ALL_LIBS)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_ranks(args, nproc=NPROC, timeout=120):
    """Run the CLI as ``nproc`` ranks of one gloo group; returns their
    stdouts, asserting each exits 0."""
    port = str(_free_port())
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(nproc), LOCAL_WORLD_SIZE=str(nproc),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nanomod_tpu_torch.cli", *args,
             "--device", "cpu"], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return outs


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_multiproc"))
    chrom, genome = make_genome(length=400, seed=7)
    make_corrected_dataset(os.path.join(root, "control"), chrom, genome,
                           n_reads=24, seed=1)
    make_corrected_dataset(os.path.join(root, "case"), chrom, genome,
                           n_reads=24, seed=2, mod_pos=173, mod_delta=1.0)
    return root


def _jax_detect(root, out, **kw):
    from nanomod_tpu.detect import run_detect
    cfg = jcfg.DetectConfig(
        wrk_base1=os.path.join(root, "control"),
        wrk_base2=os.path.join(root, "case"), out_folder=out,
        file_id="mp", min_lr=0, rank=jcfg.RankConfig(window=4), **kw)
    return run_detect(cfg)


def _pdf_pages(path):
    """Pages of a PDF (a copy of tests/test_shardmerge.py's)."""
    with open(path, "rb") as f:
        data = f.read()
    return data.count(b"/Type /Page") - data.count(b"/Type /Pages")


def _detect_args(root, out, *extra):
    return ["detect", "--wrkBase1", os.path.join(root, "control"),
            "--wrkBase2", os.path.join(root, "case"), "--outFolder", out,
            "--FileID", "mp", "--min_lr", "0", "--window", "9", *extra]


def test_two_process_union_detect_equals_jax(dataset):
    single = os.path.join(dataset, "jax_union")
    _jax_detect(dataset, single, make_plots=True)
    want = _read(os.path.join(single, "mp_sign_test.txt"))
    assert len(want) > 1000
    out = os.path.join(dataset, "torch_union")
    metrics = os.path.join(dataset, "union.json")
    trace = os.path.join(dataset, "union_trace")
    _cli_ranks(_detect_args(dataset, out, "--metricsFile", metrics,
                            "--profileDir", trace))
    assert _read(os.path.join(out, "mp_sign_test.txt")) == want
    pages = _pdf_pages(os.path.join(single, "rplot_mp.pdf"))
    assert pages > 0
    assert _pdf_pages(os.path.join(out, "rplot_mp.pdf")) == pages
    assert sorted(os.listdir(trace)) == [f"trace.rank{r}.json"
                                         for r in range(NPROC)]
    for rank in range(NPROC):
        with open(os.path.join(dataset, f"union.rank{rank}.json")) as f:
            m = json.load(f)
        assert (m["rank"], m["world_size"]) == (rank, NPROC)
        assert m["positions"] == len(want.splitlines())


def test_two_process_sharded_detect_equals_jax(dataset):
    single = os.path.join(dataset, "jax_sharded")
    _, _, sites = _jax_detect(
        dataset, single, stats=jcfg.StatConfig(coverages=(12, 12),
                                               downsampling=10),
        pool_capacity=16, make_plots=True)
    want = _read(os.path.join(single, "mp_sign_test.txt"))
    assert len(want) > 1000
    out = os.path.join(dataset, "torch_sharded")
    outs = _cli_ranks(_detect_args(
        dataset, out, "--merge_mode", "sharded", "--coverages", "12-12",
        "--downsampling", "10", "--pool_capacity", "16"))
    assert _read(os.path.join(out, "mp_sign_test.txt")) == want
    assert not [f for f in os.listdir(out) if "@shard" in f]
    pages = _pdf_pages(os.path.join(single, "rplot_mp.pdf"))
    assert pages > 0
    assert _pdf_pages(os.path.join(out, "rplot_mp.pdf")) == pages
    top = f"Rank 1: {sites[0].chrom} {sites[0].strand} {sites[0].pos + 1}"
    for rank, text in enumerate(outs):
        assert top in text, f"rank {rank}: global rank 1 differs:\n{text}"


def test_two_process_annotate_equals_jax(tmp_path):
    from nanomod_tpu.resquiggle import annotate_folder as jax_annotate

    root = str(tmp_path)
    chrom, genome = make_genome(length=500, seed=11)
    fasta = os.path.join(root, "ref.fa")
    with open(fasta, "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    jax_dir = os.path.join(root, "reads_jax")
    make_raw_dataset(jax_dir, chrom, genome, n_reads=8, seed=3,
                     read_len=400, error_rate=0.03)
    torch_dir = os.path.join(root, "reads_torch")
    shutil.copytree(jax_dir, torch_dir)

    n_ok, _ = jax_annotate(jcfg.AnnotateConfig(wrk_base1=jax_dir,
                                               ref_fasta=fasta))
    assert n_ok >= 6
    metrics = os.path.join(root, "annotate.json")
    outs = _cli_ranks(["Annotate", "--wrkBase1", torch_dir, "--Ref", fasta,
                       "--metricsFile", metrics])
    for rank, text in enumerate(outs):
        assert f"Total f5=8 (rank {rank}/{NPROC}: 4)" in text, text
        with open(os.path.join(root, f"annotate.rank{rank}.json")) as f:
            assert json.load(f)["reads_ok"] == n_ok
    names = sorted(os.listdir(jax_dir))
    assert len(names) == 8
    for name in names:
        assert _read(os.path.join(torch_dir, name)) == \
            _read(os.path.join(jax_dir, name)), name
