"""Seconds a million positions tested in which the battery's calling
thread waits for the card's result of a tile (stats/battery.py:run_battery,
event.synchronize): the port's stage battery.wait, inside test_battery,
summed over the window's units."""


def read(run):
    n = run.work.get("positions", 0)
    if not n or 'battery.wait' not in run.stages:
        return None
    return run.stages['battery.wait'] / (n / 1e6)
