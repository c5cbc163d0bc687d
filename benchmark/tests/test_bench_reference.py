"""The plain reference against scipy's own tests, and against the port's
CPU path at a tiny size through a whole run of each cell."""

from __future__ import annotations

import json

import numpy as np
import pytest
from scipy import stats

from benchmark import run
from benchmark.reference import detect as ref
from benchmark.tests.tiny import make_root


def _rows(rng, n_rows, lo, hi, ties):
    """NaN-padded [R, C] values and their counts."""
    counts = rng.integers(lo, hi + 1, n_rows)
    vals = np.full((n_rows, hi), np.nan)
    for i, c in enumerate(counts):
        x = rng.normal(0, 1, c)
        vals[i, :c] = np.round(x, 1) if ties else np.round(x, 3)
    return vals, counts


@pytest.mark.parametrize("ties", [False, True])
def test_tests_match_scipy(ties):
    rng = np.random.default_rng(1)
    v1, n1 = _rows(rng, 64, 5, 30, ties)
    v2, n2 = _rows(rng, 64, 5, 30, ties)
    v2[::3] += 0.7
    stu, pu, stt, pt, d, pks = ref._tests(v1, n1, v2, n2)
    for i in range(64):
        x, y = v1[i, :n1[i]], v2[i, :n2[i]]
        u = stats.mannwhitneyu(x, y, alternative="two-sided").statistic
        assert stu[i] == pytest.approx(min(u, n1[i] * n2[i] - u), rel=1e-12)
        w = stats.ttest_ind(x, y, equal_var=False)
        assert stt[i] == pytest.approx(w.statistic, rel=1e-10)
        assert pt[i] == pytest.approx(w.pvalue, rel=1e-9)
        assert d[i] == pytest.approx(stats.ks_2samp(x, y).statistic,
                                     rel=1e-12)
        # scipy 1.2.1's one-sided legacy p of U: half the two-sided
        # asymptotic p with the continuity correction, where that is not
        # clipped at 1
        two = stats.mannwhitneyu(x, y, alternative="two-sided",
                                 method="asymptotic",
                                 use_continuity=True).pvalue
        if two < 1.0:
            assert pu[i] == pytest.approx(two / 2, rel=1e-9)


def test_stouffer_missing_neighbours_give_one():
    gid = np.zeros(6, np.int64)
    pos = np.array([0, 1, 2, 3, 10, 11])
    st, p = ref.stouffer(gid, pos, np.full(6, 0.01), 2, 2.0)
    assert p[4] == 1.0 and p[5] == 1.0 and p[0] == 1.0
    assert p[2] == 1.0            # +2 neighbour is position 10: missing


def test_bfloat16_rounding():
    # 1 + 2^-8 lies half way between 1 and 1 + 2^-7: ties go to even
    x = np.array([1.0, 1.00390625, 1.005859375, 1.01171875, -2.5, 3.14159])
    assert list(ref.to_bfloat16(x)) == [1.0, 1.0, 1.0078125, 1.015625,
                                        -2.5, 3.140625]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("workload", ["ecoli_detect", "spel_downsampling"])
def test_a_run_on_the_cpu_is_correct(tiny_root, workload, capsys):
    rc = run.main(["--workload", workload, "--seed", str(2**31 + 11),
                   "--seconds", "0.5", "--trace", "0"], root=tiny_root,
                  device="cpu")
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]
