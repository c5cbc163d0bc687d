"""What the harness finds by name: the manifest (``BENCHMARK.json`` at the
root of the checkout), each configuration's file, each traffic mix's file
(``benchmark/traffic/<name>.json``), each per-layer metric's reader
(``benchmark/metrics/<name>.py``), the entry a mix drives
(``benchmark/entries/<entry>.py``) and the generator that writes its
inputs (``benchmark/gen/<generator>.py``).  Nothing lists them: a cell, a
mix or a metric is added by adding its files and its manifest entry."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: str = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "benchmark", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(manifest: dict, workload: str) -> list:
    return [m for m in manifest["end_to_end"] if _applies(m, workload)]


def per_layer(manifest: dict, workload: str) -> list:
    return [m for m in manifest["per_layer"] if _applies(m, workload)]


def reader(name: str, root: str = ROOT):
    """The ``read(run)`` function of metric ``name``."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry(name: str):
    return importlib.import_module(f"benchmark.entries.{name}")


def generator(name: str):
    return importlib.import_module(f"benchmark.gen.{name}")


def cells(root: str = ROOT) -> list:
    """Each workload with its configuration, mix, entry and metrics, as
    the harness would run it; raises where a file is missing."""
    m = load(root)
    out = []
    for w in m["workloads"]:
        t = traffic(w["traffic"], root)
        config(m, w["config"], root)
        for metric in per_layer(m, w["name"]):
            reader(metric["name"], root)
        out.append({"name": w["name"], "config": w["config"],
                    "traffic": w["traffic"], "entry": t["entry"],
                    "end_to_end": [e["name"]
                                   for e in end_to_end(m, w["name"])],
                    "per_layer": [p["name"]
                                  for p in per_layer(m, w["name"])]})
    return out
