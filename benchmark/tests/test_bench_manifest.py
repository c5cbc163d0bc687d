"""BENCHMARK.json against the benchmark's contract: its keys, the
character rules of names and units, the files each entry names, and a
cell added as files alone that the harness lists."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import run
from benchmark.core import manifest
from benchmark.tests.tiny import make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.fixture(scope="module")
def m():
    return manifest.load()


def test_top_level_keys(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(_line(w)
                                                for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


def test_configs(m):
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"])
        assert c["file"].startswith(m["paths"][0] + "/")
        assert os.path.isfile(os.path.join(manifest.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            assert sorted(json.load(f)["reduced"]) == sorted(c["reduced"])
        assert any(w["config"] == c["name"] for w in m["workloads"])
    assert len({c["file"] for c in m["configs"]}) == len(m["configs"])


def test_workloads(m):
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
        assert os.path.isfile(os.path.join(
            manifest.ROOT, "benchmark", "traffic", f"{w['traffic']}.json"))
    assert len(pairs) == len(m["workloads"])


def test_metrics(m):
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]
             + m["workloads"]]
    assert len(names) == len(set(names))
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in m["workloads"]}
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
        assert set(x.get("workloads", cells)) <= cells
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert x["source"] in SOURCES and _line(x["layer"])
        assert x["moves"] in e2e
        moved = next(e for e in m["end_to_end"] if e["name"] == x["moves"])
        assert set(x["workloads"]) <= set(moved.get("workloads", cells))
        assert os.path.isfile(os.path.join(
            manifest.ROOT, "benchmark", "metrics", f"{x['name']}.py"))
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    for w in cells:
        reported = [x for x in m["end_to_end"]
                    if w in x.get("workloads", cells)]
        assert {"setup_s"} < {x["name"] for x in reported}
        assert manifest.per_layer(m, w)


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirs, files in os.walk(manifest.BENCH_DIR):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), manifest.ROOT)
            assert PATH.match(rel), rel


def test_a_cell_added_as_files_alone_is_listed(tmp_path, capsys):
    root = make_root(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "ecoli_dummy.json"), "w") as f:
        json.dump({"genome_len": 9000, "read_len": 600, "read_step": 60,
                   "chrom": "dummy", "reduced": []}, f)
    with open(os.path.join(bench, "traffic", "dummy_mix.json"), "w") as f:
        json.dump({"entry": "detect", "generator": "ecoli_corrected",
                   "rate_metric": "detect_positions_per_s"}, f)
    with open(os.path.join(bench, "metrics", "dummy.layer_s.py"), "w") as f:
        f.write("def read(run):\n    return None\n")
    m = manifest.load(root)
    m["configs"].append({"name": "ecoli_dummy", "source": "a test",
                         "file": "benchmark/configs/ecoli_dummy.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "dummy_cell", "config": "ecoli_dummy",
                           "traffic": "dummy_mix", "chips": 1,
                           "why": "a test"})
    m["per_layer"].append({"name": "dummy.layer_s", "unit": "s",
                           "better": "lower", "source": "program_span",
                           "layer": "battery", "moves": "setup_s",
                           "workloads": ["dummy_cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    assert run.main(["--list"], root=root) == 0
    listed = {c["name"]: c for c in json.loads(capsys.readouterr().out)}
    assert listed["dummy_cell"]["entry"] == "detect"
    assert listed["dummy_cell"]["per_layer"] == ["dummy.layer_s"]
    assert set(listed) == {w["name"] for w in m["workloads"]}
