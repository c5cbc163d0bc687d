"""Seconds a DownSampling trial outside detect: the benchmark's own span
around each run_downsampling call, less the port's detect stages inside
it (coverage_filter, test_battery, combine_pvalues, rank), over the
trials. What is left is the sampling, pools_from_selections, the
coverage-at-target check and the target's rank walk
(harness/simulate.py)."""

SPAN = "bench.unit.downsampling"
DETECT = ("coverage_filter", "test_battery", "combine_pvalues", "rank")


def read(run):
    n = run.work.get("trials", 0)
    if not n or SPAN not in run.spans:
        return None
    inside = sum(run.stages.get(s, 0.0) for s in DETECT)
    return (run.spans[SPAN] - inside) / n
