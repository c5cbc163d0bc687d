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
import sys

import numpy as np
import pytest

from fixtures import make_genome, make_raw_dataset
from test_torch_refnative import ALL_LIBS, require_reference_native
from nanomod_tpu import config as jcfg
from nanomod_tpu.detect import run_detect as jax_run_detect
from nanomod_tpu.resquiggle.pipeline import annotate_folder as jax_annotate
from nanomod_tpu_torch import cli as torch_cli
from nanomod_tpu_torch import config as tcfg

MOD_POS = 201


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    """The JAX package's native libraries loaded, so that its paths
    here never take their Python fallback (test_torch_refnative.py)."""
    require_reference_native(*ALL_LIBS)


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
            "banded_sw": 0, "walk": 0, "battery": 0, "battery_pooled": 0,
            "capped_ks": 0, "stencil": 0, "accumulate": 0}
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


@pytest.mark.parametrize("kw", [dict(align="blast"),
                                dict(band_width=32769, device="cuda"),
                                dict(use_native=False),
                                dict(use_device_walk=False)])
def test_annotate_unported_options_raise(chain, kw):
    """What the port still refuses, before any device work (so the CUDA
    case runs without a card): an aligner the reference does not have
    (it runs dp, bwa and minimap2), the non-native paths, and a band
    width above 32,768 on the card."""
    from nanomod_tpu_torch.resquiggle.pipeline import process_prepared
    kw = dict(kw)
    device = kw.pop("device", "cpu")
    cfg = tcfg.AnnotateConfig(ref_fasta=os.path.join(chain[0], "ref.fa"), **kw)
    with pytest.raises(NotImplementedError):
        process_prepared([], cfg, None, device)


@pytest.mark.parametrize("width,device,ok", [
    (130, "cpu", True), (132, "cpu", True), (132, "cuda", True),
    (96, "cuda", True), (2048, "cuda", True), (1, "cuda", True),
    (1024, "cuda", True), (1025, "cuda", True), (2048, "cpu", True),
    (32768, "cuda", True), (32769, "cuda", False)])
def test_annotate_band_width_checked(width, device, ok):
    """The reference runs any band width; so does the port, but for a
    width above 32,768 on the card (K1 holds at most 32 warps of 32 band
    lanes a thread).  The check comes before any device work, so the CUDA
    cases run without a card."""
    from nanomod_tpu_torch.resquiggle.pipeline import _check_supported
    cfg = tcfg.AnnotateConfig(band_width=width)
    if ok:
        _check_supported(cfg, device)
    else:
        with pytest.raises(NotImplementedError, match="band_width"):
            _check_supported(cfg, device)


def _pdf_pages(path):
    """Pages of a PDF (a copy of tests/test_shardmerge.py's)."""
    with open(path, "rb") as f:
        data = f.read()
    return data.count(b"/Type /Page") - data.count(b"/Type /Pages")


def _detect_kw(dirs, impl, out, **kw):
    return dict(wrk_base1=dirs[impl, "ctrl"], wrk_base2=dirs[impl, "case"],
                out_folder=out, min_lr=0, min_coverage=5, **kw)


@pytest.mark.parametrize("kw", [dict(native_ingest=False),
                                dict(make_plots=True, merge_mode="sharded"),
                                dict(make_plots=True),
                                dict(profile_dir="trace")])
def test_detect_unported_options_raise(chain, kw, tmp_path):
    """The detect options that the port once refused now run, as the
    reference's do: the sign-test table equals the one the port writes
    without them, the plots (rplot_<FileID>.pdf) have as many pages as
    the JAX package's, and the trace directory gets a Chrome trace that
    holds the run's host events."""
    from nanomod_tpu_torch.detect import run_detect
    _, _, dirs = chain
    rank = dict(rank=tcfg.RankConfig(window=3))
    plain = str(tmp_path / "plain")
    run_detect(tcfg.DetectConfig(**_detect_kw(dirs, "torch", plain, **rank)),
               device="cpu")
    if "profile_dir" in kw:
        kw = dict(profile_dir=str(tmp_path / "trace"))
    out = str(tmp_path / "out")
    run_detect(tcfg.DetectConfig(**_detect_kw(dirs, "torch", out, **rank,
                                              **kw)), device="cpu")
    with open(os.path.join(plain, "mod_sign_test.txt"), "rb") as f:
        want = f.read()
    with open(os.path.join(out, "mod_sign_test.txt"), "rb") as f:
        assert f.read() == want
    assert len(want) > 1000
    if kw.get("make_plots"):
        jax_out = str(tmp_path / "jax")
        jax_run_detect(jcfg.DetectConfig(**_detect_kw(
            dirs, "jax", jax_out, make_plots=True,
            rank=jcfg.RankConfig(window=3))))
        pages = _pdf_pages(os.path.join(jax_out, "rplot_mod.pdf"))
        assert pages > 0
        assert _pdf_pages(os.path.join(out, "rplot_mod.pdf")) == pages
    else:
        assert not os.path.exists(os.path.join(out, "rplot_mod.pdf"))
    if "profile_dir" in kw:
        with open(os.path.join(kw["profile_dir"], "trace.rank0.json")) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("ph") == "X" for e in events)


def test_detect_plots_need_matplotlib(chain, tmp_path, monkeypatch):
    """Where matplotlib is missing, a library call with make_plots raises
    ImportError (the CLI checks first and prints a line instead)."""
    from nanomod_tpu_torch.detect import run_detect
    _, _, dirs = chain
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        run_detect(tcfg.DetectConfig(**_detect_kw(
            dirs, "torch", str(tmp_path), make_plots=True,
            rank=tcfg.RankConfig(window=3))), device="cpu")


def test_collect_site_window_matches_jax(chain):
    """The plot pages' data, site by site: the port's collect_site_window
    dicts equal the reference's on the same corrected files."""
    from nanomod_tpu.detect import detect_from_pools as jax_from_pools
    from nanomod_tpu.detect import ingest_group as jax_ingest
    from nanomod_tpu.harness.plots import collect_site_window as jax_collect
    from nanomod_tpu.rank.ranking import top_sites as jax_top_sites
    from nanomod_tpu_torch.detect import detect_from_pools, ingest_group
    from nanomod_tpu_torch.harness.plots import collect_site_window
    from nanomod_tpu_torch.rank.ranking import top_sites
    _, _, dirs = chain
    jc = jcfg.DetectConfig(**_detect_kw(dirs, "jax", "unused",
                                        rank=jcfg.RankConfig(window=3)))
    tc = tcfg.DetectConfig(**_detect_kw(dirs, "torch", "unused",
                                        rank=tcfg.RankConfig(window=3)))
    jp = [jax_ingest(d, jc) for d in (jc.wrk_base1, jc.wrk_base2)]
    tp = [ingest_group(d, tc) for d in (tc.wrk_base1, tc.wrk_base2)]
    jt, jo = jax_from_pools(*jp, jc)
    tt, to = detect_from_pools(*tp, tc, device="cpu")
    js = jax_top_sites(jt, jo, jc.stats, jc.rank, top_n=jc.rank.top_n)
    ts = top_sites(tt, to, tc.stats, tc.rank, top_n=tc.rank.top_n)
    assert len(ts) == len(js) > 0
    for a, b in zip(ts, js):
        got = collect_site_window(tt, a, *tp, tc)
        want = jax_collect(jt, b, *jp, jc)
        assert got.keys() == want.keys()
        for key in ("rank", "chrom", "strand", "pos", "labels", "pvals"):
            assert got[key] == want[key], key
        for key in ("data1", "data2"):
            assert len(got[key]) == len(want[key]) == 7
            for x, y in zip(got[key], want[key]):
                np.testing.assert_array_equal(x, y)


def _drop_events(path):
    """A corrected FAST5 without its Events dataset: the group is there,
    the data the native reader needs is not."""
    import h5py
    with h5py.File(path, "r+") as f:
        del f["Analyses/NanomoCorrected_000/BaseCalled_template/Events"]


@pytest.mark.parametrize("kind", ["corrected", "raw", "group_no_events"])
def test_resume_probe_matches_h5py(chain, kind, tmp_path):
    """Annotate --resume's native probe gives has_corrected_group's (h5py)
    answer on a file with the corrected group, one without it, and one
    with the group but no Events dataset (where the native reader of
    corrected events finds nothing to read)."""
    from nanomod_tpu_torch.io.fast5 import has_corrected_group
    from nanomod_tpu_torch.native.fast5_bind import read_corrected_batch
    from nanomod_tpu_torch.resquiggle.pipeline import already_corrected
    root, _, dirs = chain
    src = dirs["torch", "case"] if kind != "raw" \
        else os.path.join(root, "raw_case")
    names = sorted(os.listdir(src))[:4]
    paths = []
    for name in names:
        paths.append(str(tmp_path / name))
        shutil.copyfile(os.path.join(src, name), paths[-1])
        if kind == "group_no_events":
            _drop_events(paths[-1])
    want = [has_corrected_group(p) for p in paths]
    assert want == [kind != "raw"] * len(paths)
    assert already_corrected(paths, tcfg.AnnotateConfig()) == want
    readable = [r is not None for r in read_corrected_batch(paths)]
    assert readable == [kind == "corrected"] * len(paths)


def test_cli_resume_skips_corrected_files(chain, capsys):
    """``Annotate --resume 1`` over a folder that is already corrected has
    nothing to do and leaves the files as they are."""
    from nanomod_tpu_torch.io.fast5 import has_corrected_group
    root, _, dirs = chain
    folder = dirs["torch", "ctrl"]
    before = {n: os.path.getmtime(os.path.join(folder, n))
              for n in os.listdir(folder)}
    capsys.readouterr()
    torch_cli.main(["Annotate", "--wrkBase1", folder, "--Ref",
                    os.path.join(root, "ref.fa"), "--resume", "1",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    ok = sum(has_corrected_group(os.path.join(folder, n)) for n in before)
    assert f"Resume: {ok} already annotated, {len(before) - ok} to do" in out
    assert ok >= 10
    assert {n: os.path.getmtime(os.path.join(folder, n))
            for n in before} == before


_NO_H5PY = r"""
import sys
sys.modules["h5py"] = None           # the card's machine has no h5py
sys.modules["matplotlib"] = None     # and no matplotlib
from nanomod_tpu_torch.cli import main
main(sys.argv[1:])
assert sys.modules["h5py"] is None and "jax" not in sys.modules
"""


def test_cli_chain_runs_without_h5py(tmp_path):
    """The committed smoke inputs go through Annotate and detect with h5py
    and matplotlib unimportable, as on the card's machine: detect writes
    its table and says that it draws no plot."""
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
    assert "rplot_mod.pdf not drawn: matplotlib is not installed" in out
    assert not (tmp_path / "out" / "rplot_mod.pdf").exists()
    with open(tmp_path / "out" / "mod_sign_test.txt") as f:
        assert len(f.read().splitlines()) > 500
