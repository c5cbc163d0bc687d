"""What the scale tools share: peak RSS, a metrics file's stage times and
launch counts, the device-busy share of a torch.profiler trace, and the
default output root."""

from __future__ import annotations

import json
import os
import resource
import tempfile

import numpy as np

# K3's kernels in a trace (csrc/battery.cu)
K3_KERNELS = ("battery_warp", "battery_block")


def rss_gb() -> float:
    """This process's peak resident set, GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def metrics_summary(path: str) -> dict:
    """A run's metrics file (cfg.metrics_file): each stage's seconds and
    the kernels' launch counts."""
    with open(path) as f:
        m = json.load(f)
    return {"stages_s": {k: v["seconds"] for k, v in m["stages"].items()},
            "kernel_launches": m["kernel_launches"]}


def out_root(name: str) -> str:
    """The default output folder of a tool: ``name`` under the temporary
    directory."""
    return os.path.join(tempfile.gettempdir(), name)


def trace_busy_share(path: str, kernels=K3_KERNELS) -> dict:
    """From a Chrome trace of torch.profiler: the device-busy share (the
    union of the kernel and copy intervals over the profiled wall time,
    the span of all complete events), and the events and summed time of
    the kernels whose names hold one of ``kernels``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise AssertionError(f"{path} holds no complete event")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -np.inf
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    hits = [e for e in events if e.get("cat") == "kernel"
            and any(k in e["name"] for k in kernels)]
    return {"wall_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / (t1 - t0),
            "device_events": len(dev), "kernel_events": len(hits),
            "kernel_ms": sum(e["dur"] for e in hits) / 1e3}
