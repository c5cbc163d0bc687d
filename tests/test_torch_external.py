"""The external-aligner path of the port (``--alignStr bwa|minimap2``)
against the JAX package, on the CPU.

bwa and minimap2 are not installed here: the fake ``minimap2`` of
test_external_align.py (exact substring anchoring, SAM to stdout) stands
in, so the subprocess round, the SAM filters, the CIGAR expansion, the
orientation bookkeeping and the per-read native correction are all real.
The port's corrected FAST5s must be byte-equal to the JAX package's on
copies of the same raw files, through the library and through the CLI.
"""

import os
import shutil
import stat
import subprocess
import sys

import numpy as np
import pytest

from fixtures import make_genome, make_raw_dataset
from test_torch_refnative import ALL_LIBS, require_reference_native
from test_external_align import FAKE_MINIMAP2
from nanomod_tpu import config as jcfg
from nanomod_tpu.io.fasta import FastaIndex as JaxFastaIndex
from nanomod_tpu.resquiggle import annotate_files as jax_annotate_files
from nanomod_tpu.resquiggle import external as jext
from nanomod_tpu.resquiggle.pipeline import annotate_folder as jax_annotate
from nanomod_tpu.resquiggle.seed import SeedIndex as JaxSeedIndex
from nanomod_tpu_torch import cli as torch_cli
from nanomod_tpu_torch import config as tcfg
from nanomod_tpu_torch.io.fast5 import read_corrected_events
from nanomod_tpu_torch.resquiggle import external as text
from nanomod_tpu_torch.resquiggle.pipeline import annotate_files

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    """The JAX package's native libraries loaded, so that its paths
    here never take their Python fallback (test_torch_refnative.py)."""
    require_reference_native(*ALL_LIBS)


@pytest.fixture()
def fake_aligner(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "minimap2"
    exe.write_text(FAKE_MINIMAP2)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    return str(exe)


@pytest.fixture()
def raw_dataset(tmp_path):
    """test_external_align.py's data: 6 clean reads of 400 bases, either
    strand, on a 900-base genome; one copy for each implementation."""
    chrom, genome = make_genome(length=900, seed=5)
    fasta_p = str(tmp_path / "ref.fa")
    with open(fasta_p, "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    reads_dir = str(tmp_path / "reads")
    make_raw_dataset(reads_dir, chrom, genome, n_reads=6, seed=6,
                     read_len=400, error_rate=0.0)
    copies = {}
    for impl in ("jax", "torch", "torch_dp"):
        copies[impl] = str(tmp_path / impl)
        shutil.copytree(reads_dir, copies[impl])
    return fasta_p, copies


def _paths(folder):
    return sorted(os.path.join(folder, n) for n in os.listdir(folder))


def _assert_same_files(want_dir, got_dir):
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir))
    for name in names:
        with open(os.path.join(want_dir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(got_dir, name), "rb") as f:
            assert f.read() == want, f"{name} differs"


CIGARS = [("3S4M2D1I3M2H", 100, 13), ("*", 0, 10), ("900M", 0, 10),
          ("5M", 0, 5), ("2S10M3N4=1X2I5M", 7, 30), ("0M", 0, 5),
          ("4M1P3M", 0, 10), ("12H8M", 50, 20), ("", 0, 3)]


@pytest.mark.parametrize("cigar,pos0,read_len", CIGARS)
def test_cigar_to_ops_matches_jax(cigar, pos0, read_len):
    want = jext.cigar_to_ops(cigar, pos0, read_len)
    got = text.cigar_to_ops(cigar, pos0, read_len)
    assert (got is None) == (want is None)
    if want is not None:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_parse_sam_matches_jax():
    """The reference's record filters (mapq 255, pos 0, rname '*', cigar
    '*', flags 0x900, names outside the batch, short or malformed lines)
    and the best mapq a read, on the JAX test's lines and more."""
    lines = [
        "@HD\tVN:1.6",
        "0\t0\tchr\t10\t60\t5M\t*\t0\t0\tACGTA\t*",
        "0\t256\tchr\t11\t60\t5M\t*\t0\t0\tACGTA\t*",
        "1\t0\t*\t0\t0\t*\t*\t0\t0\tACGTA\t*",
        "2\t0\tchr\t5\t255\t5M\t*\t0\t0\tACGTA\t*",
        "3\t16\tchr\t7\t30\t5M\t*\t0\t0\tACGTA\t*",
        "3\t16\tchr\t9\t50\t5M\t*\t0\t0\tACGTA\t*",
        "3\t16\tchr\t3\t50\t5M\t*\t0\t0\tACGTA\t*",
        "4\t2048\tchr\t9\t50\t5M\t*\t0\t0\tACGTA\t*",
        "5\t0\tchr\t9\t50\t5M\t*\t0\t0\tACGTA\t*",
        "x\t0\tchr\t9\t50\t5M\t*\t0\t0\tACGTA\t*",
        "1\t0\tchr\t9\t50",
        "",
        "1\t0\tchr2\t4\t12\t3M\t*\t0\t0\tACG\t*\n",
    ]
    want = jext.parse_sam(lines, 5)
    assert text.parse_sam(lines, 5) == want
    assert set(want) == {0, 1, 3}


def test_aligner_command_matches_jax():
    for align in ("bwa", "minimap2"):
        assert text.aligner_command(align, "r.fa", "q.fa") == \
            jext.aligner_command(align, "r.fa", "q.fa")
    with pytest.raises(ValueError):
        text.aligner_command("blast", "r.fa", "q.fa")


def test_external_aligner_matches_jax_and_dp(raw_dataset, fake_aligner):
    """Library route: the port's annotate_files with minimap2 writes the
    JAX package's corrected FAST5s byte for byte, and the same events
    (base equal, norm_mean within rtol 1e-6) as its own DP path."""
    fasta_p, copies = raw_dataset
    jcf = jcfg.AnnotateConfig(ref_fasta=fasta_p, align="minimap2")
    jfasta = JaxFastaIndex(fasta_p)
    n_j, err_j, hist_j = jax_annotate_files(
        _paths(copies["jax"]), jcf, jfasta,
        JaxSeedIndex(jfasta.seqs, k=jcf.seed_k))
    assert n_j == 6, err_j
    n_t, err_t, hist = annotate_files(
        _paths(copies["torch"]),
        tcfg.AnnotateConfig(ref_fasta=fasta_p, align="minimap2"),
        device="cpu")
    assert n_t == 6 and not err_t, err_t
    assert hist == hist_j
    _assert_same_files(copies["jax"], copies["torch"])

    n_dp, err_dp, _ = annotate_files(_paths(copies["torch_dp"]),
                                     tcfg.AnnotateConfig(ref_fasta=fasta_p),
                                     device="cpu")
    assert n_dp == 6, err_dp
    for name in os.listdir(copies["torch"]):
        got = read_corrected_events(os.path.join(copies["torch"], name))
        want = read_corrected_events(os.path.join(copies["torch_dp"], name))
        assert (got.chrom, got.strand, got.start) == \
            (want.chrom, want.strand, want.start)
        np.testing.assert_allclose(got.norm_mean, want.norm_mean,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got.base, want.base)


def test_external_aligner_cli_matches_jax(raw_dataset, fake_aligner,
                                          tmp_path, capsys):
    """CLI route: ``cli Annotate --alignStr minimap2 --device cpu`` against
    the JAX package's annotate_folder with align="minimap2"; the metrics
    file records the align_ext stage and no kernel launch."""
    import json
    fasta_p, copies = raw_dataset
    n_ok, errors = jax_annotate(jcfg.AnnotateConfig(
        wrk_base1=copies["jax"], ref_fasta=fasta_p, align="minimap2"))
    assert n_ok == 6, errors
    mfile = str(tmp_path / "m.json")
    torch_cli.main(["Annotate", "--wrkBase1", copies["torch"], "--Ref",
                    fasta_p, "--alignStr", "minimap2", "--device", "cpu",
                    "--metricsFile", mfile])
    assert "Total consuming time" in capsys.readouterr().out
    _assert_same_files(copies["jax"], copies["torch"])
    with open(mfile) as f:
        metrics = json.load(f)
    assert metrics["reads_ok"] == 6
    assert "align_ext" in metrics["stages"]
    assert "align_dp" not in metrics["stages"]
    assert not any(metrics["kernel_launches"].values())


def test_external_aligner_missing_binary(raw_dataset, monkeypatch, tmp_path):
    """No bwa on PATH: the library raises RuntimeError and the CLI exits
    non-zero, both saying "not found on PATH"; no silent fall back to the
    DP and no file touched."""
    fasta_p, copies = raw_dataset
    empty = tmp_path / "emptybin"
    empty.mkdir()
    monkeypatch.setenv("PATH", f"{empty}:/usr/bin:/bin")
    before = {p: os.path.getsize(p) for p in _paths(copies["torch"])}
    with pytest.raises(RuntimeError, match="not found on PATH"):
        annotate_files(_paths(copies["torch"]),
                       tcfg.AnnotateConfig(ref_fasta=fasta_p, align="bwa"),
                       device="cpu")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "nanomod_tpu_torch.cli", "Annotate",
         "--wrkBase1", copies["torch"], "--Ref", fasta_p, "--alignStr",
         "bwa", "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "not found on PATH" in proc.stderr
    assert before == {p: os.path.getsize(p) for p in _paths(copies["torch"])}


@pytest.mark.parametrize("align", ["dp", "minimap2"])
@pytest.mark.parametrize("gname", ["normal", "repeat"])
def test_unrelated_reads_rejected(tmp_path, fake_aligner, align, gname):
    """Reads basecalled from another genome are rejected, by the seed and
    score gate (dp) or by the aligner (an unmapped SAM record), with the
    reference's error key, on a normal and a repeat-heavy target, as the
    JAX package rejects them."""
    rng = np.random.default_rng(11)
    other = "".join(rng.choice(list("ACGT"), 2000))
    target = (make_genome(length=900, seed=5)[1] if gname == "normal"
              else "ACGTACGGTTCA" * 75)
    fasta_p = str(tmp_path / f"{gname}.fa")
    with open(fasta_p, "w") as f:
        f.write(f">{gname}\n{target}\n")
    reads_dir = str(tmp_path / "reads")
    make_raw_dataset(reads_dir, "other", other, n_reads=4, seed=7,
                     read_len=400, error_rate=0.0)
    paths = _paths(reads_dir)
    n_ok, errors, _ = annotate_files(
        paths, tcfg.AnnotateConfig(ref_fasta=fasta_p, align=align),
        device="cpu")
    jcf = jcfg.AnnotateConfig(ref_fasta=fasta_p, align=align)
    jfasta = JaxFastaIndex(fasta_p)
    n_j, err_j, _ = jax_annotate_files(paths, jcf, jfasta,
                                       JaxSeedIndex(jfasta.seqs, k=jcf.seed_k))
    assert n_ok == n_j == 0, gname
    assert sorted(errors["Not in alignment sam"]) == \
        sorted(err_j["Not in alignment sam"]) == paths


def test_chip_smoke_fake_aligner_is_the_tests():
    """chip_smoke.py carries the same fake minimap2 as a string (it
    imports nothing from the tests)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_probe", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.FAKE_MINIMAP2 == FAKE_MINIMAP2


@pytest.mark.parametrize("group,mapped", [("ctrl", 11), ("case", 12)])
def test_smoke_data_external_matches_jax(group, mapped, fake_aligner,
                                         tmp_path, capsys):
    """chip_smoke.py phase 8's input: the committed raw smoke reads
    through the fake minimap2, the port's CLI on the CPU against the JAX
    package, byte for byte; 11 and 12 of the 16 reads a group map (the
    fake anchors an exact 24-mer, which basecall errors can break)."""
    data = os.path.join(ROOT, "nanomod_tpu_torch", "smoke_data")
    ref = str(tmp_path / "ref.fa")
    shutil.copyfile(os.path.join(data, "ref.fa"), ref)
    dirs = {impl: str(tmp_path / impl) for impl in ("jax", "torch")}
    for d in dirs.values():
        shutil.copytree(os.path.join(data, group), d)
    n_ok, errors = jax_annotate(jcfg.AnnotateConfig(
        wrk_base1=dirs["jax"], ref_fasta=ref, align="minimap2"))
    mfile = str(tmp_path / "m.json")
    torch_cli.main(["Annotate", "--wrkBase1", dirs["torch"], "--Ref", ref,
                    "--alignStr", "minimap2", "--device", "cpu",
                    "--metricsFile", mfile])
    capsys.readouterr()
    import json
    with open(mfile) as f:
        assert json.load(f)["reads_ok"] == n_ok == mapped, errors
    _assert_same_files(dirs["jax"], dirs["torch"])
