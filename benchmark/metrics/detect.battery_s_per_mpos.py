"""Seconds a million positions tested in the battery
(stats/battery.py:run_battery and K3): the port's stage test_battery,
summed over the window's units."""


def read(run):
    n = run.work.get("positions", 0)
    if not n:
        return None
    return sum(run.stages.get(s, 0.0) for s in ('test_battery',)) / (n / 1e6)
