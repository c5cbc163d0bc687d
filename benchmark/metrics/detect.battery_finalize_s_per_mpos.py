"""Seconds a million positions tested in the battery's float64 statistics
on the host (stats/battery.py:finalize_packed and the scatter of a tile's
columns): the port's stage battery.finalize, inside test_battery, summed
over the window's units."""


def read(run):
    n = run.work.get("positions", 0)
    if not n or 'battery.finalize' not in run.stages:
        return None
    return run.stages['battery.finalize'] / (n / 1e6)
