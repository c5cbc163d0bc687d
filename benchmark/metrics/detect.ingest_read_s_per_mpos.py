"""Seconds a million positions tested in the native open and parse of the
corrected files (native/fast5_bind.py:read_corrected_batch, fast5_ingest.cpp
on the port's worker threads): the port's stage ingest.read, inside
ingest, summed over the window's units."""


def read(run):
    n = run.work.get("positions", 0)
    if not n or 'ingest.read' not in run.stages:
        return None
    return run.stages['ingest.read'] / (n / 1e6)
