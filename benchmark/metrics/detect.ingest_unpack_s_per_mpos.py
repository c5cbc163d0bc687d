"""Seconds a million positions tested in the copy of the parsed files into
numpy and the reads built from it (native/fast5_bind.py:
read_corrected_batch): the port's stage ingest.unpack, inside ingest,
summed over the window's units."""


def read(run):
    n = run.work.get("positions", 0)
    if not n or 'ingest.unpack' not in run.stages:
        return None
    return run.stages['ingest.unpack'] / (n / 1e6)
