# Copied from nanomod_tpu/io/__init__.py; only the imports differ.
from nanomod_tpu_torch.io.fast5 import (  # noqa: F401
    CorrectedRead,
    read_corrected_events,
    write_corrected_events,
    iter_fast5_files,
)
from nanomod_tpu_torch.io.fasta import FastaIndex  # noqa: F401
