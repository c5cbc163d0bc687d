"""A checkout-shaped copy of the benchmark at a size the CPU runs in
seconds: BENCHMARK.json, the benchmark's folder, the configurations and
mixes cut down (every reader as committed), and the DownSampling cell that
PERF.md keeps for later, added to the manifest as a later PR would add
it."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.core import manifest

TINY_CONFIGS = {
    "ecoli": {"genome_len": 12000, "read_len": 600, "read_step": 60},
    "spel_oligo": {"genome_len": 300, "target_pos": 150,
                   "reads_per_group": 60, "minus_reads": 35},
}
# the manifest entries of the DownSampling cell (benchmark/configs/
# spel_oligo.json, benchmark/traffic/downsampling_case1000.json)
SPEL = {
    "configs": [{"name": "spel_oligo", "source": "NanoMod's SPEL oligo "
                 "simulation", "file": "benchmark/configs/spel_oligo.json",
                 "reduced": [], "why": "SPEL oligo simulation"}],
    "workloads": [{"name": "spel_downsampling", "config": "spel_oligo",
                   "traffic": "downsampling_case1000", "chips": 1,
                   "why": "DownSampling at CaseSize 1000"}],
    "end_to_end": [{"name": "harness_trials_per_s", "unit": "trials/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock",
                    "workloads": ["spel_downsampling"]}],
    "per_layer": [{"name": name, "unit": unit, "better": better,
                   "source": source, "layer": layer,
                   "moves": "harness_trials_per_s",
                   "workloads": ["spel_downsampling"]}
                  for name, unit, better, source, layer in (
                      ("harness.pools_s_per_trial", "s/trial", "lower",
                       "program_span", "harness trials"),
                      ("harness.battery_s_per_trial", "s/trial", "lower",
                       "program_span", "battery"),
                      ("battery_roofline.harness", "%", "higher",
                       "device_trace", "battery"),
                      ("device_idle_share.harness", "%", "lower",
                       "device_trace", "device"))],
}
TINY_TRAFFIC = {
    "detect_3kb_11x": {"jitter": 20, "fixed_edge_reads": 12,
                       "planted_sites": 2, "tile_positions": 4096},
    "downsampling_case1000": {"case_size": 40, "random_times": 3},
}


def make_root(dest: str, root: str = manifest.ROOT) -> str:
    """Write the tiny copy under ``dest``; returns it."""
    shutil.copytree(os.path.join(root, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest.load(root)
    for key, entries in SPEL.items():
        names = {e["name"] for e in m[key]}
        m[key] += [e for e in entries if e["name"] not in names]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    for c in m["configs"]:
        path = os.path.join(dest, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(TINY_CONFIGS.get(c["name"], {}))
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name, over in TINY_TRAFFIC.items():
        path = os.path.join(dest, "benchmark", "traffic", f"{name}.json")
        with open(path) as f:
            t = json.load(f)
        t.update(over)
        with open(path, "w") as f:
            json.dump(t, f)
    return dest
