"""The port's battery against independent ground truth for the scipy 1.2.1
statistics.

`tests/golden/scipy121_cases.json` holds, for each case, exact rational
statistics and 60-digit mpmath p-values, made without scipy or nanomod code
(tools/make_scipy121_fixture.py).  This test holds the port's own
``run_battery`` to them on CPU tensors, at both backends, with the bounds of
the JAX package's tests/test_scipy121_grounding.py: the Mann-Whitney U and
KS statistics exact, the p-values within 5e-12 relative and Welch's t
within 1e-12.  It checks the port against the fixture, not against the JAX
package.  tests/test_torch_cuda.py runs the same cases through K3 on the
card.
"""

import json
import os
from fractions import Fraction

import numpy as np
import pytest

from nanomod_tpu_torch.stats.battery import run_battery

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                       "scipy121_cases.json")

with open(FIXTURE) as f:
    CASES = json.load(f)["cases"]


def as_pools(case):
    """One position: the case's two samples (milli integers) as [1, C] f32
    pools and their counts."""
    a = np.asarray(case["a_milli"], np.float32) / np.float32(1000)
    b = np.asarray(case["b_milli"], np.float32) / np.float32(1000)
    c = max(len(a), len(b))
    v1 = np.zeros((1, c), np.float32)
    v2 = np.zeros((1, c), np.float32)
    v1[0, : len(a)] = a
    v2[0, : len(b)] = b
    return (v1, np.array([len(a)], np.int32),
            v2, np.array([len(b)], np.int32))


def _rel(x, y):
    return abs(x - y) / max(abs(y), 1e-300)


def check_against_ground_truth(res, case):
    """The bounds of the JAX package's grounding test."""
    assert res.stu[0] == float(Fraction(case["stu"]))
    assert res.stks[0] == float(Fraction(case["stks"]))
    assert _rel(res.pu[0], float(case["pu"])) < 5e-12, case["name"]
    assert _rel(res.pks[0], float(case["pks"])) < 5e-12, case["name"]
    if case["stt"] is not None:
        assert _rel(res.stt[0], float(case["stt"])) < 1e-12
        assert _rel(res.pt[0], float(case["pt"])) < 5e-12, case["name"]


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_battery_matches_independent_ground_truth(case, backend):
    res = run_battery(*as_pools(case), backend=backend, device="cpu")
    check_against_ground_truth(res, case)
