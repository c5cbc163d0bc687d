"""Seconds a DownSampling trial in the battery: the port's stage
test_battery, summed over the window's calls, over the trials they ran."""


def read(run):
    n = run.work.get("trials", 0)
    if not n:
        return None
    return sum(run.stages.get(s, 0.0) for s in ('test_battery',)) / (n / 1)
