# Copied from nanomod_tpu_torch/tools/common.py (trace_busy_share); counts every kernel, copy and memset in the window, not K3's alone, and names the idle gaps.
"""The reduction of a torch.profiler Chrome trace of the measured window.

The window is the benchmark's ``bench.window`` span; its units are the
benchmark's ``bench.unit.<entry>`` spans (``record_function``, so they
lie on the trace's clock).  Device time is every kernel, copy and memset,
clipped to the window.  Idle gaps are the stretches of the window in
which no device operation runs, each named by the innermost benchmark
span that holds its middle."""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
PREFIX = "bench."
TOP = 10


def reduce(path: str) -> dict:
    """{window_s, busy_s, device_s {name: s}, device_ops [[name, s]],
    idle_gaps [[span, s]]} of the trace at ``path``; raises when the
    trace holds no window span."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)]
    windows = [e for e in spans if e["name"] == WINDOW]
    if not windows:
        raise RuntimeError(f"{path} holds no {WINDOW} span")
    w = max(windows, key=lambda e: e["dur"])
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    dev = []
    by_name = defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b > a:
            dev.append((a, b))
            by_name[e["name"]] += (b - a) / 1e6
    dev.sort()
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    inner = [e for e in spans if e is not w]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        holding = [e for e in inner
                   if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = (min(holding, key=lambda e: e["dur"])["name"] if holding
                else WINDOW)
        gaps.append([name, (b - a) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(([k, v] for k, v in by_name.items()), key=lambda x: -x[1])
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "device_s": dict(by_name), "device_ops": ops[:TOP],
            "idle_gaps": gaps[:TOP]}
