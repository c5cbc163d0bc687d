# Copied from nanomod_tpu_torch/tools/fixtures.py (make_corrected_dataset's write); takes (path, payload) pairs.
"""Corrected FAST5s written as the reference writes them with h5py: each
file first holds only its root group, then the port's native corrected
writer adds the corrected group (the card's machine has no h5py)."""

from __future__ import annotations

import os


def write_corrected(batch, nthreads: int):
    """Write each (path, payload) of ``batch``; raises if the native
    writer declines any."""
    from nanomod_tpu_torch.native.fast5_rawwrite_bind import write_empty
    from nanomod_tpu_torch.native.fast5_write_bind import (
        write_corrected_batch_native)
    paths = [p for p, _ in batch]
    for p in paths:
        os.makedirs(os.path.dirname(p), exist_ok=True)
        write_empty(p)
    ok = write_corrected_batch_native(paths, [pl for _, pl in batch],
                                      nthreads=nthreads)
    if ok is None or not ok.all():
        raise RuntimeError("the native corrected writer declined a file")
