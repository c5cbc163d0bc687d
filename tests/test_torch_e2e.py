"""The port's entry points against the JAX package, end to end on the CPU.

Annotate on raw FAST5 fixtures through ``nanomod_tpu_torch.cli Annotate
--device cpu`` must write corrected FAST5s byte-identical to
nanomod_tpu's Annotate on copies of the same files; ``cli detect --device
cpu`` must then write a ``_sign_test.txt`` byte-identical to
``nanomod_tpu.detect.run_detect``'s, with the planted site ranked first.
"""

import json
import os
import shutil

import numpy as np
import pytest

from fixtures import make_genome, make_raw_dataset
from nanomod_tpu import config as jcfg
from nanomod_tpu.detect import run_detect as jax_run_detect
from nanomod_tpu.resquiggle.pipeline import annotate_folder as jax_annotate
from nanomod_tpu_torch import cli as torch_cli
from nanomod_tpu_torch import config as tcfg

MOD_POS = 201


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_e2e"))
    chrom, genome = make_genome(length=420, seed=3)
    fasta = os.path.join(root, "ref.fa")
    with open(fasta, "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    raw = {}
    raw["ctrl"] = os.path.join(root, "raw_ctrl")
    raw["case"] = os.path.join(root, "raw_case")
    make_raw_dataset(raw["ctrl"], chrom, genome, n_reads=12, seed=10,
                     error_rate=0.02)
    make_raw_dataset(raw["case"], chrom, genome, n_reads=12, seed=20,
                     mod_pos=MOD_POS, mod_delta_pa=12.0, error_rate=0.02)
    dirs = {}
    for impl in ("jax", "torch"):
        for group in ("ctrl", "case"):
            d = os.path.join(root, f"{impl}_{group}")
            shutil.copytree(raw[group], d)
            dirs[impl, group] = d
    for group in ("ctrl", "case"):
        n_ok, errors = jax_annotate(jcfg.AnnotateConfig(
            wrk_base1=dirs["jax", group], ref_fasta=fasta))
        assert n_ok >= 10, errors
        torch_cli.main(["Annotate", "--wrkBase1", dirs["torch", group],
                        "--Ref", fasta, "--device", "cpu",
                        "--metricsFile",
                        os.path.join(root, f"annotate_{group}.json")])
    return root, chrom, dirs


def test_annotate_fast5_byte_identical(chain):
    root, _, dirs = chain
    for group in ("ctrl", "case"):
        names = sorted(os.listdir(dirs["jax", group]))
        assert len(names) == 12
        for name in names:
            with open(os.path.join(dirs["jax", group], name), "rb") as f:
                want = f.read()
            with open(os.path.join(dirs["torch", group], name), "rb") as f:
                got = f.read()
            assert got == want, f"{group}/{name} differs"
        with open(os.path.join(root, f"annotate_{group}.json")) as f:
            metrics = json.load(f)
        # on the CPU the wrappers run the plain versions: no kernel launch
        assert metrics["kernel_launches"] == {
            "banded_sw": 0, "walk": 0, "battery": 0, "capped_ks": 0,
            "stencil": 0, "accumulate": 0}
        assert metrics["reads_ok"] >= 10


def test_detect_sign_test_byte_identical(chain, capsys):
    root, chrom, dirs = chain
    jax_out = os.path.join(root, "jax_out")
    torch_out = os.path.join(root, "torch_out")
    jax_run_detect(jcfg.DetectConfig(
        wrk_base1=dirs["jax", "ctrl"], wrk_base2=dirs["jax", "case"],
        out_folder=jax_out, min_lr=0, min_coverage=5,
        rank=jcfg.RankConfig(window=3)))
    capsys.readouterr()
    torch_cli.main(["detect", "--wrkBase1", dirs["torch", "ctrl"],
                    "--wrkBase2", dirs["torch", "case"],
                    "--outFolder", torch_out, "--min_lr", "0",
                    "--MinCoverage", "5", "--window", "7",
                    "--device", "cpu"])
    text = capsys.readouterr().out
    with open(os.path.join(jax_out, "mod_sign_test.txt"), "rb") as f:
        want = f.read()
    with open(os.path.join(torch_out, "mod_sign_test.txt"), "rb") as f:
        got = f.read()
    assert len(want) > 1000
    assert got == want
    first = text.split("Rank 1:")[1].split("\n")[0].split()
    assert first[0] == chrom
    assert int(first[2]) - 1 == MOD_POS, f"planted site not first: {first}"


def test_prepare_and_alignment_match_jax(chain):
    """prepare_batch, dispatch_dp and finish_alignment of the port give the
    reference's prepared reads and alignment ops on the same raw files."""
    from nanomod_tpu.io.fasta import FastaIndex
    from nanomod_tpu_torch.io.fasta import FastaIndex as TorchFastaIndex
    from nanomod_tpu.resquiggle import pipeline as jp
    from nanomod_tpu.resquiggle.seed import SeedIndex as JaxSeedIndex
    from nanomod_tpu_torch.resquiggle import pipeline as tp
    from nanomod_tpu_torch.resquiggle.seed import SeedIndex

    root = chain[0]
    folder = os.path.join(root, "raw_case")
    paths = sorted(os.path.join(folder, n) for n in os.listdir(folder))
    kw = dict(wrk_base1=folder, ref_fasta=os.path.join(root, "ref.fa"))
    cfg = jcfg.AnnotateConfig(**kw)
    tcf = tcfg.AnnotateConfig(**kw)
    fasta = FastaIndex(cfg.ref_fasta)
    want, werr = jp.prepare_batch(paths, cfg, JaxSeedIndex(fasta.seqs), None)
    got, gerr = tp.prepare_batch(paths, tcf, SeedIndex(fasta.seqs), None)
    assert dict(werr) == dict(gerr)
    assert [r.path for r in got] == [r.path for r in want]
    for a, b in zip(got, want):
        assert (a.fwd_seq, a.chrom, a.strand, a.diag) == \
            (b.fwd_seq, b.chrom, b.strand, b.diag)
        np.testing.assert_array_equal(a.norm_signal, b.norm_signal)
    ops_t = tp.finish_alignment(
        tp.dispatch_dp(got, TorchFastaIndex(cfg.ref_fasta), tcf, "cpu"), tcf)
    ops_j = jp.finish_alignment(jp.dispatch_dp(want, fasta, cfg), cfg)
    assert len(ops_t) == len(ops_j) == len(got)
    for (ot, wt), (oj, wj) in zip(ops_t, ops_j):
        assert wt == wj
        assert (ot is None) == (oj is None)
        if ot is not None:
            for x, y in zip(ot, oj):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [dict(align="bwa"), dict(band_width=130),
                                dict(use_native=False),
                                dict(use_device_walk=False)])
def test_annotate_unported_options_raise(chain, kw):
    from nanomod_tpu_torch.resquiggle.pipeline import process_prepared
    cfg = tcfg.AnnotateConfig(ref_fasta=os.path.join(chain[0], "ref.fa"), **kw)
    with pytest.raises(NotImplementedError):
        process_prepared([], cfg, None, "cpu")


@pytest.mark.parametrize("width,device,ok", [
    (130, "cpu", False), (132, "cpu", True), (132, "cuda", False),
    (96, "cuda", True), (2048, "cuda", False)])
def test_annotate_band_width_checked(width, device, ok):
    """The reference runs any band width; the port's packed walk takes a
    multiple of 4, its CUDA kernels a multiple of 32 up to 1024.  The check
    comes before any device work, so the CUDA cases run without a card."""
    from nanomod_tpu_torch.resquiggle.pipeline import _check_supported
    cfg = tcfg.AnnotateConfig(band_width=width)
    if ok:
        _check_supported(cfg, device)
    else:
        with pytest.raises(NotImplementedError, match="band_width"):
            _check_supported(cfg, device)


@pytest.mark.parametrize("kw", [dict(native_ingest=False),
                                dict(make_plots=True, merge_mode="sharded"),
                                dict(make_plots=True),
                                dict(profile_dir="trace")])
def test_detect_unported_options_raise(kw):
    from nanomod_tpu_torch.detect import run_detect
    with pytest.raises(NotImplementedError):
        run_detect(tcfg.DetectConfig(**kw), device="cpu")


_NO_H5PY = r"""
import sys
sys.modules["h5py"] = None           # the card's machine has no h5py
from nanomod_tpu_torch.cli import main
main(sys.argv[1:])
assert sys.modules["h5py"] is None and "jax" not in sys.modules
"""


def test_cli_chain_runs_without_h5py(tmp_path):
    """The committed smoke inputs go through Annotate and detect with h5py
    unimportable, as on the card's machine."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = os.path.join(root, "nanomod_tpu_torch", "smoke_data")
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    groups = {}
    for group in ("ctrl", "case"):
        dst = tmp_path / group
        dst.mkdir()
        for name in sorted(os.listdir(os.path.join(data, group)))[:6]:
            shutil.copyfile(os.path.join(data, group, name), dst / name)
        groups[group] = str(dst)

    def cli(*args):
        return subprocess.run([sys.executable, "-c", _NO_H5PY, *args],
                              cwd=root, env=env, capture_output=True,
                              text=True, timeout=300, check=True).stdout

    for folder in groups.values():
        cli("Annotate", "--wrkBase1", folder, "--Ref",
            os.path.join(data, "ref.fa"), "--device", "cpu")
    out = cli("detect", "--wrkBase1", groups["ctrl"], "--wrkBase2",
              groups["case"], "--outFolder", str(tmp_path / "out"),
              "--min_lr", "0", "--MinCoverage", "2", "--device", "cpu")
    assert "Rank 1:" in out
    with open(tmp_path / "out" / "mod_sign_test.txt") as f:
        assert len(f.read().splitlines()) > 500
