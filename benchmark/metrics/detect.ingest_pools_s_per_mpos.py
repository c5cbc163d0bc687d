"""Seconds a million positions tested in detect's corrected ingest and pool
build: the port's stages ingest, accumulate and finalize_pools
(detect.py:ingest_group, accum/pools.py), summed over the window's
units."""


def read(run):
    n = run.work.get("positions", 0)
    if not n:
        return None
    stages = ('ingest', 'accumulate', 'finalize_pools')
    return sum(run.stages.get(s, 0.0) for s in stages) / (n / 1e6)
