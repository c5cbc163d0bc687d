"""``correct`` comes out false where it should: the bfloat16 control fails
each cell's numbers, and a run whose timed path is broken underneath
(the harness's look for a card skipped) reads false.  The faults that
these cells can have: an answer altered where it is produced (one count
of K3's output), and half of the batch left out (every other read
dropped at ingest).  Neither cell steps a state or exchanges between
cards."""

from __future__ import annotations

import json

import pytest

from benchmark import control, run
from benchmark.core import manifest
from benchmark.tests.tiny import make_root

CELLS = ["ecoli_detect", "spel_downsampling"]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("tiny")))


def _limits(root, workload):
    m = manifest.load(root)
    return manifest.traffic(manifest.cell(m, workload)["traffic"],
                            root)["limits"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(tiny_root, workload):
    r = control.readings(workload, 2**31 + 5, 0.2, True, root=tiny_root,
                         device="cpu")
    limits = _limits(tiny_root, workload)
    assert all(v <= limits[k] for k, v in r["program"].items())
    assert any(v > limits[k] for k, v in r["control"].items())


def _altered_k3(monkeypatch):
    from nanomod_tpu_torch.stats import kernels
    orig = kernels.battery_components_packed_milli

    def altered(*a, **kw):
        out = orig(*a, **kw).clone()
        out[0, 0] += 1                 # one KS numerator off by one
        return out
    monkeypatch.setattr(kernels, "battery_components_packed_milli", altered)


def _half_the_reads(monkeypatch):
    from nanomod_tpu_torch.native import fast5_bind
    orig = fast5_bind.read_corrected_batch

    def half(paths, *a, **kw):
        reads = orig(paths, *a, **kw)
        return [r if i % 2 == 0 else None for i, r in enumerate(reads)]
    monkeypatch.setattr(fast5_bind, "read_corrected_batch", half)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_altered_k3, _half_the_reads])
def test_a_broken_timed_path_reads_false(tiny_root, workload, fault,
                                         monkeypatch, capsys):
    fault(monkeypatch)
    rc = run.main(["--workload", workload, "--seed", "77", "--seconds",
                   "0.2", "--trace", "0"], root=tiny_root, device="cpu")
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is False
