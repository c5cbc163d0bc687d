"""The port's stages (utils/observe.py) on the profiler's clock.

While a torch profiler records, every ``stage()`` is also a
``nanomod.<stage>`` span of its trace, nested as the stages nest; with no
profiler a stage makes no torch call.  run_battery, ingest, run_detect,
pools_from_selections and the builds record the stages that the
benchmark's per-layer metrics read, and a profiled detect writes the same
table as one without a profiler.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fixtures import make_corrected_dataset, make_genome
from nanomod_tpu_torch import config as tcfg
from nanomod_tpu_torch.detect import run_detect
from nanomod_tpu_torch.harness import simulate
from nanomod_tpu_torch.kernels import build as kbuild
from nanomod_tpu_torch.native import build as native
from nanomod_tpu_torch.stats.battery import run_battery
from nanomod_tpu_torch.utils.observe import Observer, observer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# snapshot() rounds each stage's seconds to 1e-4: a sum of three may be off
# by 1.5e-4
ROUNDING = 2e-4
BATTERY_SPANS = ("battery.gather", "battery.encode_wait", "battery.dispatch",
                 "battery.wait", "battery.finalize")


def _spans(path):
    """The ``nanomod.*`` spans of a Chrome trace, by name without the
    prefix."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        name = str(e.get("name", ""))
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and name.startswith("nanomod.")):
            out.setdefault(name[len("nanomod."):], []).append(e)
    return out


def _inside(inner, outer) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _traced(fn, path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    return out, _spans(path)


def test_stages_are_nested_spans_under_the_profiler(tmp_path):
    obs = Observer()

    def work():
        with obs.stage("outer"):
            for _ in range(2):
                with obs.stage("inner") as s:
                    s.add(1)
    _, spans = _traced(work, tmp_path / "trace.json")
    assert len(spans["outer"]) == 1 and len(spans["inner"]) == 2
    assert all(_inside(e, spans["outer"][0]) for e in spans["inner"])
    snap = obs.snapshot()
    assert snap["inner"]["calls"] == 2 and snap["inner"]["items"] == 2
    assert snap["outer"]["calls"] == 1


def test_stage_makes_no_torch_call_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    obs = Observer()
    with obs.stage("outer"):
        with obs.stage("inner", unit="reads") as s:
            s.add(3)
    snap = obs.snapshot()
    assert snap["inner"] == {"seconds": snap["inner"]["seconds"], "items": 3,
                             "unit": "reads", "calls": 1,
                             "per_sec": snap["inner"]["per_sec"]}
    assert snap["inner"]["seconds"] <= snap["outer"]["seconds"] + ROUNDING


def test_observe_imports_and_times_without_torch():
    code = ("import sys\n"
            "from nanomod_tpu_torch.utils.observe import observer, stage\n"
            "with stage('x') as s:\n"
            "    s.add(2)\n"
            "print('torch' in sys.modules, observer().snapshot()['x']"
            "['items'])\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == ["False", "2"]


def _battery_inputs(p, seed=5, c=16):
    rng = np.random.default_rng(seed)
    rows = p + 9
    v1 = np.round(rng.normal(90, 3, (rows, c)), 3).astype(np.float32)
    v2 = np.round(rng.normal(91, 3, (rows, c)), 3).astype(np.float32)
    n1 = rng.integers(3, c + 1, rows).astype(np.int32)
    n2 = rng.integers(3, c + 1, rows).astype(np.int32)
    idx1 = rng.permutation(rows)[:p]
    idx2 = rng.permutation(rows)[:p]
    return v1, n1[idx1], v2, n2[idx2], idx1, idx2


@pytest.mark.parametrize("p,tile", [(40, 64), (200, 48)],
                         ids=["one_tile", "five_tiles"])
def test_run_battery_stages_and_spans(tmp_path, p, tile):
    v1, n1, v2, n2, idx1, idx2 = _battery_inputs(p)

    def battery():
        return run_battery(v1, n1, v2, n2, tile_positions=tile, idx1=idx1,
                           idx2=idx2, device="cpu")
    observer().reset()
    want = battery()
    observer().reset()
    got, spans = _traced(battery, tmp_path / "trace.json")
    for k in ("stu", "pu", "stt", "pt", "stks", "pks"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    tiles = -(-p // tile)
    snap = observer().snapshot()
    assert snap["battery.gather"]["items"] == (v1[idx1].nbytes
                                               + v2[idx2].nbytes)
    for name in BATTERY_SPANS[1:]:
        assert snap[name]["calls"] == tiles, name
    assert snap["battery.finalize"]["items"] == p
    assert snap["battery.dispatch"]["items"] > 0
    assert {n for n in snap if n.startswith("battery.")} == set(
        BATTERY_SPANS)
    assert len(spans["battery.gather"]) == 1
    for name in BATTERY_SPANS[1:]:
        assert len(spans[name]) == tiles, name


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_observe"))
    chrom, genome = make_genome(length=400, seed=7)
    make_corrected_dataset(os.path.join(root, "control"), chrom, genome,
                           n_reads=12, seed=1)
    make_corrected_dataset(os.path.join(root, "case"), chrom, genome,
                           n_reads=12, seed=2, mod_pos=173, mod_delta=1.0)
    return root


def _detect(root, out, **kw):
    cfg = tcfg.DetectConfig(
        wrk_base1=os.path.join(root, "control"),
        wrk_base2=os.path.join(root, "case"), out_folder=out,
        file_id="obs", min_lr=0, rank=tcfg.RankConfig(window=4), **kw)
    table, _, _ = run_detect(cfg, device="cpu")
    with open(os.path.join(out, "obs_sign_test.txt"), "rb") as f:
        return len(table), f.read(), observer().snapshot()


@pytest.fixture(scope="module")
def detects(groups, tmp_path_factory):
    """(positions, table bytes, snapshot) of a detect without a profiler,
    then of one with ``profile_dir``, and the latter's spans."""
    out = str(tmp_path_factory.mktemp("detect_out"))
    plain = _detect(groups, os.path.join(out, "plain"))
    prof_dir = os.path.join(out, "trace")
    traced = _detect(groups, os.path.join(out, "traced"),
                     profile_dir=prof_dir)
    return plain, traced, _spans(os.path.join(prof_dir, "trace.rank0.json"))


DETECT_STAGES = ("ingest.list", "ingest", "ingest.read", "ingest.unpack",
                 "accumulate", "finalize_pools", "coverage_filter",
                 "test_battery") + BATTERY_SPANS + (
                 "combine_pvalues", "rank", "save", "top_sites")


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "profiled"])
def test_run_detect_records_the_split(detects, traced):
    n, _, snap = detects[traced]
    for name in DETECT_STAGES:
        assert snap[name]["calls"] >= 1, name
    assert snap["ingest.list"]["calls"] == 2
    assert snap["ingest.list"]["items"] == 24
    assert snap["ingest.read"]["items"] == 24
    assert snap["ingest.unpack"]["items"] == 24
    assert (snap["ingest.read"]["seconds"] + snap["ingest.unpack"]["seconds"]
            <= snap["ingest"]["seconds"] + ROUNDING)
    assert (snap["battery.wait"]["seconds"]
            + snap["battery.finalize"]["seconds"]
            <= snap["test_battery"]["seconds"] + ROUNDING)
    assert snap["host_cpu"]["items"] == n > 0
    assert snap["host_cpu"]["seconds"] > 0


def test_profiled_detect_writes_spans_and_the_same_table(detects):
    plain, traced, spans = detects
    assert traced[:2] == plain[:2]
    for name in DETECT_STAGES:
        assert len(spans[name]) == traced[2][name]["calls"], name
    assert "host_cpu" not in spans
    for e in spans["ingest.read"] + spans["ingest.unpack"]:
        assert any(_inside(e, g) for g in spans["ingest"])
    for e in spans["battery.finalize"]:
        assert any(_inside(e, g) for g in spans["test_battery"])


def test_pools_from_selections_stage(groups):
    reads = simulate.FlatReads(simulate.load_group_reads(
        os.path.join(groups, "case")))
    observer().reset()
    pools = simulate.pools_from_selections([reads.select_all()])
    snap = observer().snapshot()
    assert snap["pools_from_selections"]["calls"] == 1
    assert snap["pools_from_selections"]["items"] == sum(
        p.num_positions for p in pools.values()) > 0


def _native_build(tmp_path, monkeypatch):
    return lambda: native.build("format_core", build_dir=str(tmp_path))


def _kernel_build(tmp_path, monkeypatch):
    """The kernel library's build with nvcc's step replaced by a file
    written (no nvcc here)."""
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kbuild, "LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(kbuild, "LOCK_PATH", str(tmp_path / "lock"))

    def compile_(srcs):
        with open(kbuild.LIB_PATH, "wb") as f:
            f.write(b"\0")
    monkeypatch.setattr(kbuild, "_compile", compile_)
    return kbuild.build


@pytest.mark.parametrize("name,make", [("build.format_core", _native_build),
                                       ("build.kernels", _kernel_build)],
                         ids=["native", "kernels"])
def test_a_build_is_a_stage(tmp_path, monkeypatch, name, make):
    build = make(tmp_path, monkeypatch)
    observer().reset()
    build()
    build()                               # up to date: no second build
    snap = observer().snapshot()
    assert snap[name]["calls"] == 1 and snap[name]["items"] == 1
