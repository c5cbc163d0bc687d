"""The readers of the port's split stages: each reads its stage's summed
seconds over the positions tested (millions), and nothing where no
position was tested or where the program has no such stage (a checkout
from before the split)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.core import manifest

READERS = {
    "detect.ingest_read_s_per_mpos": "ingest.read",
    "detect.ingest_unpack_s_per_mpos": "ingest.unpack",
    "detect.battery_wait_s_per_mpos": "battery.wait",
    "detect.battery_finalize_s_per_mpos": "battery.finalize",
    "detect.host_cpu_s_per_mpos": "host_cpu",
}
# what a window of two detects of the parent's program records
PARENT_STAGES = {"ingest": 5.1, "accumulate": 1.0, "finalize_pools": 2.5,
                 "coverage_filter": 0.3, "test_battery": 3.9,
                 "combine_pvalues": 0.5, "rank": 1.8, "save": 3.0}


def _run(positions, stages):
    return SimpleNamespace(work={"positions": positions, "units": 2},
                           stages=stages, trace=None, battery_rows=[],
                           spans={}, window_s=20.0, traffic={})


@pytest.mark.parametrize("name", sorted(READERS))
def test_reads_its_stage_over_mpos(name):
    stages = dict(PARENT_STAGES, **{s: 0.25 for s in READERS.values()})
    stages[READERS[name]] = 1.5
    read = manifest.reader(name)
    assert read(_run(4_000_000, stages)) == pytest.approx(1.5 / 4)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reads_nothing_without_positions_or_its_stage(name):
    read = manifest.reader(name)
    assert read(_run(0, {READERS[name]: 1.5})) is None
    assert read(_run(4_000_000, dict(PARENT_STAGES))) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_manifest_entry(name):
    m = manifest.load()
    entry = next(x for x in m["per_layer"] if x["name"] == name)
    assert entry["workloads"] == ["ecoli_detect"]
    assert entry["moves"] == "detect_positions_per_s"
    assert entry["unit"] == "s/Mpos" and entry["better"] == "lower"
    assert entry["source"] == ("program_counter"
                               if READERS[name] == "host_cpu"
                               else "program_span")
    assert name in manifest.cells()[0]["per_layer"]
