"""``peak_host_gb`` reads the process that runs the port: the inputs are
made in a child process, whose allocation does not reach the metric."""

from __future__ import annotations

import json
import os
import resource

from benchmark import run
from benchmark.tests.tiny import make_root


def test_the_generators_memory_stays_in_its_process(tmp_path):
    root = make_root(str(tmp_path / "root"))
    # a slice whose level tracks and reads take the child ~100 MB more
    path = os.path.join(root, "benchmark", "configs", "ecoli.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(genome_len=3_000_000, read_step=3_000_000)
    with open(path, "w") as f:
        json.dump(cfg, f)
    before = run.peak_host_gb()
    child_before = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    out = run._generate("ecoli_detect", 5, str(tmp_path / "in"), 1, root)
    child = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    assert out["files"] > 0
    assert child * 1024 / 1e9 > 0.1 and child >= child_before
    assert run.peak_host_gb() - before < 0.01
