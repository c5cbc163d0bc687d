"""The port's simulate / simulat2 / DownSampling harness against the JAX
harness on the CPU.

The same corrected-FAST5 fixtures (tests/test_harness.py's) go through
nanomod_tpu.harness.simulate and nanomod_tpu_torch.harness.simulate with
the same config and seed: the port's native reader must give the same read
dict (keys, order, arrays), and every ``.output`` file must be byte-equal,
for run_simulate, run_simulat2 and run_downsampling, the grid run in two
shards, and the CLI subcommands.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from fixtures import make_corrected_dataset, make_genome
from test_torch_refnative import DETECT_LIBS, require_reference_native
from nanomod_tpu import cli as jax_cli
from nanomod_tpu.config import RankConfig, SimulateConfig, replace
from nanomod_tpu.harness import simulate as jsim
from nanomod_tpu_torch import cli as torch_cli
from nanomod_tpu_torch import config as tconfig
from nanomod_tpu_torch.harness import simulate as tsim

MOD_POS = 120


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    """The JAX package's native libraries loaded, so that its paths
    here never take their Python fallback (test_torch_refnative.py)."""
    require_reference_native(*DETECT_LIBS)


@pytest.fixture(scope="module")
def sim_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_sim"))
    chrom, genome = make_genome(length=260, seed=21)
    case = os.path.join(root, "case")
    ctrl = os.path.join(root, "ctrl")
    make_corrected_dataset(case, chrom, genome, n_reads=40, seed=31,
                           mod_pos=MOD_POS, mod_delta=1.4, strands="-")
    make_corrected_dataset(ctrl, chrom, genome, n_reads=80, seed=32,
                           strands="-")
    return root, chrom, case, ctrl


@pytest.fixture(scope="module")
def grid_data(tmp_path_factory):
    """ctrl/{0,1,2}, case/{0,1}: the grid mode's numbered subfolders."""
    root = str(tmp_path_factory.mktemp("torch_grid"))
    chrom, genome = make_genome(length=260, seed=21)
    ctrl = os.path.join(root, "ctrl")
    case = os.path.join(root, "case")
    for i, seed in enumerate((41, 42, 43)):
        make_corrected_dataset(os.path.join(ctrl, str(i)), chrom, genome,
                               n_reads=16, seed=seed, strands="-")
    for j, seed in enumerate((51, 52)):
        make_corrected_dataset(os.path.join(case, str(j)), chrom, genome,
                               n_reads=16, seed=seed,
                               mod_pos=MOD_POS, mod_delta=1.4, strands="-")
    return root, chrom, ctrl, case


def _cfg(root, chrom, case, ctrl, out, **kw):
    cfg = SimulateConfig(
        wrk_base1=ctrl, wrk_base2=case, out_folder=os.path.join(root, out),
        target_chr=chrom, target_pos=MOD_POS, target_strand="-",
        random_times=3, rank=RankConfig(window=2))
    return replace(cfg, **kw) if kw else cfg


def _to_port(cfg):
    """The port's config of the same class with the fields of a JAX-package
    config."""
    cls = getattr(tconfig, type(cfg).__name__)
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = _to_port(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def _read(cfg, file_id=None):
    path = os.path.join(cfg.out_folder, (file_id or cfg.file_id) + ".output")
    with open(path, "rb") as f:
        return f.read()


def _both(cfg, run_jax, run_torch):
    """Run both harnesses on cfg with their own out folders; return the
    two configs."""
    cj = replace(cfg, out_folder=cfg.out_folder + "_jax")
    ct = _to_port(replace(cfg, out_folder=cfg.out_folder + "_torch"))
    run_jax(cj)
    run_torch(ct)
    return cj, ct


def test_load_group_reads_matches_jax(sim_data, tmp_path):
    """Same keys in the same order and the same arrays; a later file of
    the same name (in a subfolder) collapses onto the first key's place."""
    _, _, case, _ = sim_data
    folder = str(tmp_path / "reads")
    shutil.copytree(case, folder)
    first = sorted(os.listdir(os.path.join(folder, "0")))
    os.makedirs(os.path.join(folder, "0", "dup"))
    shutil.copyfile(os.path.join(folder, "0", first[-1]),
                    os.path.join(folder, "0", "dup", first[0]))
    want = jsim.load_group_reads(folder)
    got = tsim.load_group_reads(folder)
    assert list(got) == list(want)
    assert len(got) == 40
    for k in want:
        a, b = got[k], want[k]
        assert (a.chrom, a.strand, a.start) == (b.chrom, b.strand, b.start)
        np.testing.assert_array_equal(a.norm_mean, b.norm_mean)
        np.testing.assert_array_equal(a.base, b.base)


@pytest.mark.parametrize("perc", [0.9, 0.5])
def test_run_simulate_output_equal(sim_data, perc):
    root, chrom, case, ctrl = sim_data
    cfg = _cfg(root, chrom, case, ctrl, f"sim_{perc}", percentages=(perc,),
               wrk_base3=ctrl)
    cj, ct = _both(cfg, jsim.run_simulate,
                   lambda c: tsim.run_simulate(c, device="cpu"))
    got = _read(ct)
    assert got == _read(cj)
    if perc == 0.9:
        assert got.split() == [b"0.90000", b"1", b"1", b"1"]


def test_run_simulat2_output_equal(sim_data):
    root, chrom, case, ctrl = sim_data
    cfg = _cfg(root, chrom, case, ctrl, "s2", percentage=0.5, case_size=20,
               file_id="s2")
    cj, ct = _both(cfg, jsim.run_simulat2,
                   lambda c: tsim.run_simulat2(c, device="cpu"))
    assert _read(ct) == _read(cj) == b"20 1 1 1\n"


@pytest.mark.parametrize("backend", ["device", "host"])
def test_run_downsampling_output_equal(sim_data, backend):
    root, chrom, case, ctrl = sim_data
    cfg = _cfg(root, chrom, case, ctrl, f"ds_{backend}", case_size=60,
               random_times=2, file_id="ds", wrk_base1=case, wrk_base2=ctrl)
    cj, ct = _both(cfg, jsim.run_downsampling,
                   lambda c: tsim.run_downsampling(c, device="cpu",
                                                   backend=backend))
    assert _read(ct) == _read(cj)
    assert _read(ct).split()[1:] == [b"1", b"1"]


def test_grid_two_shards_output_equal(grid_data):
    """Two shards of the port's grid (explicit process_id/process_count)
    write the per-point files the single JAX grid writes."""
    root, chrom, ctrl, case = grid_data
    cfg = SimulateConfig(
        wrk_base1=ctrl, wrk_base2=case, out_folder=os.path.join(root, "g"),
        target_chr=chrom, target_pos=MOD_POS, target_strand="-",
        percentages=(0.9,), random_times=2, foldersep=1,
        rank=RankConfig(window=2))
    cj = replace(cfg, out_folder=cfg.out_folder + "_jax")
    ct = _to_port(replace(cfg, out_folder=cfg.out_folder + "_torch"))
    fids, _ = jsim.run_simulate_grid(cj)
    shards = [tsim.run_simulate_grid(ct, process_id=pid, process_count=2,
                                     device="cpu") for pid in range(2)]
    assert shards[0][0] == shards[1][0] == fids
    assert sorted(list(shards[0][1]) + list(shards[1][1])) == sorted(fids)
    for fid in fids:
        assert _read(ct, fid) == _read(cj, fid)
        assert os.path.isfile(os.path.join(ct.out_folder, fid + ".done"))
    assert tsim.merge_grid_outputs(ct, fids) == jsim.merge_grid_outputs(cj,
                                                                         fids)


def test_shard_list_round_robin():
    items = list(range(7))
    assert tsim.shard_list(items) == items
    parts = [tsim.shard_list(items, pid, 3) for pid in range(3)]
    assert parts == [[0, 3, 6], [1, 4], [2, 5]]


_HARNESS_CMDS = ("simulate", "simulat2", "DownSampling")


def _subparser(parser, name):
    return next(a for a in parser._actions
                if a.dest == "cmd").choices[name]


def _assert_png(path):
    with open(path, "rb") as f:
        head = f.read(8)
    assert head == b"\x89PNG\r\n\x1a\n", path
    assert os.path.getsize(path) > 1000


@pytest.mark.parametrize("name", _HARNESS_CMDS)
def test_parser_mirrors_reference_harness_args(name):
    """Every option of the reference's subcommand, with its default, plus
    --device."""
    ref = _subparser(jax_cli.build_parser(), name)
    port = _subparser(torch_cli.build_parser(), name)

    def opts(p):
        return {s: a.default for a in p._actions for s in a.option_strings}

    want = opts(ref)
    got = opts(port)
    assert got.pop("--device") == "cuda"
    assert got == want


def _cli_case(name, sim_data, out):
    root, chrom, case, ctrl = sim_data
    common = ["--outFolder", out, "--window", "5", "--outLevel", "2"]
    if name == "simulate":
        return ["simulate", "--wrkBase1", ctrl, "--wrkBase2", case,
                "--wrkBase3", ctrl, "--Percentages", "0.9,0.4"] + common
    if name == "simulat2":
        return ["simulat2", "--wrkBase1", ctrl, "--wrkBase2", case,
                "--Percentage", "0.5", "--CaseSize", "20",
                "--FileID", "cli2"] + common
    return ["DownSampling", "--wrkBase1", case, "--wrkBase2", ctrl,
            "--CaseSize", "60", "--FileID", "clids"] + common


@pytest.mark.parametrize("name", _HARNESS_CMDS)
def test_cli_harness_writes_reference_files(sim_data, name, capsys,
                                            monkeypatch):
    """The port's subcommand, and the JAX harness run on the config that
    the reference's CLI parses from the same arguments, write the same
    files; where the reference draws a histogram (simulate), the port
    draws it too."""
    root, chrom, _, _ = sim_data
    out_t = os.path.join(root, f"cli_{name}_torch")
    out_j = os.path.join(root, f"cli_{name}_jax")

    def at_site(cfg):
        # the fixture's planted site, not SimulateConfig's fixed spel 3072
        return replace(cfg, target_chr=chrom, target_pos=MOD_POS)

    a = jax_cli.build_parser().parse_args(_cli_case(name, sim_data, out_j))
    if name == "simulate":
        cfg = jax_cli._sim_cfg(a, percentages=(0.4, 0.9))
    elif name == "simulat2":
        cfg = jax_cli._sim_cfg(a, percentage=a.Percentage)
    else:
        cfg = jax_cli._sim_cfg(a)
    run = {"simulate": jsim.run_simulate, "simulat2": jsim.run_simulat2,
           "DownSampling": jsim.run_downsampling}[name]
    run(at_site(cfg))

    port_sim_cfg = torch_cli._sim_cfg
    monkeypatch.setattr(torch_cli, "_sim_cfg",
                        lambda *x, **kw: at_site(port_sim_cfg(*x, **kw)))
    capsys.readouterr()
    torch_cli.main(_cli_case(name, sim_data, out_t) + ["--device", "cpu"])
    # the reference draws hist_<FileID>.png for simulate (and runType 3)
    assert "not drawn" not in capsys.readouterr().out
    hist = [n for n in os.listdir(out_t) if n.endswith(".png")]
    assert hist == (["hist_mod.png"] if name == "simulate" else [])
    if hist:
        _assert_png(os.path.join(out_t, hist[0]))
    names = sorted(os.listdir(out_j))
    assert names == sorted(n for n in os.listdir(out_t)
                           if not n.endswith(".png"))
    assert sum(n.endswith(".output") for n in names) == 1
    for n in names:
        with open(os.path.join(out_j, n), "rb") as f:
            want = f.read()
        with open(os.path.join(out_t, n), "rb") as f:
            assert f.read() == want, n
    assert b" 1" in want


@pytest.mark.parametrize("name", ["simulat2", "DownSampling"])
def test_cli_runtype3_summarizes_and_says_no_histogram(tmp_path, name,
                                                        capsys):
    """runType 3 merges the .output files of a sweep and draws the
    histogram of the merged ranks, as the reference does."""
    out = tmp_path / "out"
    out.mkdir()
    (out / "mod_20.output").write_text("20 1 3\n")
    (out / "mod_40.output").write_text("40 1\n")
    torch_cli.main([name, "--runType", "3", "--outFolder", str(out),
                    "--device", "cpu"])
    assert "not drawn" not in capsys.readouterr().out
    _assert_png(str(out / "hist_mod.png"))
    grouped, labels = tsim.summarize_outputs(str(out), ["mod_20", "mod_40"])
    assert grouped == jsim.summarize_outputs(str(out),
                                             ["mod_20", "mod_40"])[0]
    assert grouped[40.0][labels[0]] == 1.0
