"""Device selection for the port.

Every entry point takes an explicit ``device`` and threads it through; there
is no global device state.  The CLI and the pipeline entry points default
to ``"cuda"``; the CPU tests pass ``"cpu"``.  A request for CUDA on a
machine without a usable card raises: the port never falls back to the CPU
on its own.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(name="cuda") -> torch.device:
    """torch.device for ``name`` ("cuda", "cuda:0", "cpu" or a device).

    Raises RuntimeError when a CUDA device is asked for and none is usable.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                f"is False (no CUDA card or a CPU-only PyTorch build)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``: a zero-copy view on the CPU;
    on CUDA a pinned host copy and a non-blocking host-to-device copy
    (PyTorch's pinned-memory allocator keeps the host buffer until the copy
    has run)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)
