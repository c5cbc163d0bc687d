"""Run metrics: per-stage timings plus the kernels' launch counts."""

from __future__ import annotations

import json
import os

import torch

from nanomod_tpu_torch.utils.observe import observer
from nanomod_tpu_torch.kernels.build import launch_counts


def write_metrics(path: str, device, **extra) -> str:
    """Write the Observer's per-stage snapshot, the kernels' launch counts
    and the device (with its name on CUDA) as JSON; ``extra`` adds keys."""
    payload = {"stages": observer().snapshot(),
               "kernel_launches": launch_counts(),
               "device": str(device), **extra}
    if torch.device(device).type == "cuda":
        payload["device_name"] = torch.cuda.get_device_name(device)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    return path
