"""Process CPU seconds a million positions tested (user and system time of
every thread, time.process_time over each whole run_detect): the port's
counter host_cpu, summed over the window's units.  Beside
detect.*_s_per_mpos's wall seconds it tells a slow host from more work."""


def read(run):
    n = run.work.get("positions", 0)
    if not n or 'host_cpu' not in run.stages:
        return None
    return run.stages['host_cpu'] / (n / 1e6)
