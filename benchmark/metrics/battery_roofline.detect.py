"""K3's share of its roofline, %: the least time of the battery tiles that
the window's joins need (benchmark/core/roofline.py: bytes read once and
written once over 3.35 TB/s, or the sort-and-merge operations over the
INT32 peak, the larger) over K3's device time in the profiler's trace of
the window."""

from benchmark.core.roofline import battery_bound_s

K3_NAMES = ("battery_warp", "battery_block")


def read(run):
    t = run.trace
    if not t or not run.battery_rows:
        return None
    k3 = sum(s for name, s in t["device_s"].items()
             if any(k in name for k in K3_NAMES))
    if k3 <= 0:
        return None
    return 100.0 * battery_bound_s(run.battery_rows,
                                   run.traffic["tile_positions"]) / k3
