# Copied from nanomod_tpu/utils/observe.py; differs in the imports and has
# no device_trace (it wraps jax.profiler).
"""Tracing, per-stage throughput counters and gated logging.

The reference's observability is ad-hoc ``time.time()`` deltas printed
behind ``outLevel`` gates (ref bin/scripts/myDetect.py:426-440,455-518;
bin/scripts/myRefBaseSignalAnnotation.py:362-389,482-490) plus per-1000-file
progress snapshots (ref myDetect.py:605-623).  Here the same signals are
first-class: every pipeline stage records wall time and item counts into an
``Observer``, reports are structured (one line per stage with throughput).

Usage::

    with stage("ingest", unit="reads") as s:
        ...
        s.add(n_reads)
    report(out_level)                      # gated human-readable summary
    observer().to_json("metrics.json")     # machine-readable metrics
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nanomod_tpu_torch.config import OUTPUT_INFO


@dataclass
class StageStats:
    name: str
    seconds: float = 0.0
    items: int = 0
    unit: str = "items"
    calls: int = 0

    @property
    def per_sec(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


class _StageHandle:
    """Handle yielded by ``stage(...)``; call ``.add(n)`` to count items."""

    def __init__(self, stats: StageStats):
        self._stats = stats
        self.n = 0

    def add(self, n: int):
        self.n += int(n)


class Observer:
    """Thread-safe registry of per-stage wall time + item counts."""

    def __init__(self):
        self._stages: Dict[str, StageStats] = {}
        self._order: List[str] = []
        self._lock = threading.Lock()
        self.started = time.time()

    @contextlib.contextmanager
    def stage(self, name: str, unit: str = "items"):
        t0 = time.time()
        with self._lock:
            st = self._stages.get(name)
            if st is None:
                st = self._stages[name] = StageStats(name, unit=unit)
                self._order.append(name)
        h = _StageHandle(st)
        try:
            yield h
        finally:
            dt = time.time() - t0
            with self._lock:
                st.seconds += dt
                st.items += h.n
                st.calls += 1

    def add(self, name: str, items: int, seconds: float, unit: str = "items"):
        """Record a stage measured externally."""
        with self._lock:
            st = self._stages.get(name)
            if st is None:
                st = self._stages[name] = StageStats(name, unit=unit)
                self._order.append(name)
            st.seconds += seconds
            st.items += int(items)
            st.calls += 1

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                n: {
                    "seconds": round(s.seconds, 4),
                    "items": s.items,
                    "unit": s.unit,
                    "calls": s.calls,
                    "per_sec": round(s.per_sec, 2),
                }
                for n, s in ((n, self._stages[n]) for n in self._order)
            }

    def report(self, out_level: int = OUTPUT_INFO) -> Optional[str]:
        """Human-readable per-stage summary, printed when out_level <= INFO
        (the reference prints its timings behind the same gate,
        ref myDetect.py:426)."""
        if out_level > OUTPUT_INFO:
            return None
        lines = ["[observe] stage timings:"]
        for n, d in self.snapshot().items():
            rate = f" ({d['per_sec']:.1f} {d['unit']}/s)" if d["items"] else ""
            lines.append(
                f"[observe]   {n:<24s} {d['seconds']:8.2f}s"
                f" {d['items']:>10d} {d['unit']}{rate}")
        text = "\n".join(lines)
        print(text)
        return text

    def to_json(self, path: str):
        payload = {
            "wall_seconds": round(time.time() - self.started, 4),
            "stages": self.snapshot(),
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        return path

    def reset(self):
        with self._lock:
            self._stages.clear()
            self._order.clear()
            self.started = time.time()


_global = Observer()


def observer() -> Observer:
    return _global


def stage(name: str, unit: str = "items"):
    return _global.stage(name, unit=unit)


def report(out_level: int = OUTPUT_INFO):
    return _global.report(out_level)


def vlog(cfg_level: int, level: int, msg: str):
    """Gated print: emit when the message level clears the configured gate
    (mirrors the reference's ``moptions['outLevel']<=...`` checks)."""
    if level >= cfg_level:
        print(msg)
