# Copied from nanomod_tpu/signal/__init__.py; only the imports differ.
from nanomod_tpu_torch.signal.events import extract_events, EventTable  # noqa: F401
from nanomod_tpu_torch.signal.normalize import (  # noqa: F401
    load_kmer_model,
    kmer_shift_scale,
    mad_normalize,
)
