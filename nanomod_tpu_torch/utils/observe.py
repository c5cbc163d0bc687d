# Copied from nanomod_tpu/utils/observe.py; differs in the imports, in
# device_trace, which wraps torch.profiler instead of jax.profiler, in
# stage(), which also opens a profiler span while a profiler records and
# times on the monotonic clock, and has no vlog or to_json.
"""Tracing, per-stage throughput counters and gated logging.

The reference's observability is ad-hoc ``time.time()`` deltas printed
behind ``outLevel`` gates (ref bin/scripts/myDetect.py:426-440,455-518;
bin/scripts/myRefBaseSignalAnnotation.py:362-389,482-490) plus per-1000-file
progress snapshots (ref myDetect.py:605-623).  Here the same signals are
first-class: every pipeline stage records wall time and item counts into an
``Observer``, reports are structured (one line per stage with throughput),
and the whole run can be wrapped in a ``torch.profiler`` trace of the host
and the card for Perfetto / chrome://tracing / TensorBoard inspection.

While a profiler records, each stage is also a span of the trace, named
``nanomod.<stage>`` (a ``user_annotation`` event, nested as the stages
nest), on the same clock as the card's kernels and copies.  So a trace
written by ``detect --profileDir DIR`` (or NANOMOD_PROFILE_DIR, or any
``torch.profiler.profile`` around the call) shows which stage the host was
in while the card sat idle.  Only spans opened on the thread that started
the profiler appear in its trace: work on a pool's threads shows as the
calling thread's wait for it.  With no profiler a stage makes no torch
call.

Usage::

    with stage("ingest", unit="reads") as s:
        ...
        s.add(n_reads)
    report(out_level)                      # gated human-readable summary
    observer().snapshot()                  # machine-readable metrics

    with device_trace("/tmp/trace", device):   # or NANOMOD_PROFILE_DIR=...
        run_detect(cfg, device)
"""

from __future__ import annotations

import contextlib
import os
import sys
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


def _profiler():
    """torch's autograd profiler module while a profiler records, else
    None: a dict lookup and an attribute read, so that a stage makes no
    torch call when no profiler records (a ``record_function`` costs
    several times a stage's own bookkeeping even then) and this module
    imports without torch."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof if prof is not None and prof._is_profiler_enabled else None


class Observer:
    """Thread-safe registry of per-stage wall time + item counts."""

    def __init__(self):
        self._stages: Dict[str, StageStats] = {}
        self._order: List[str] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, unit: str = "items"):
        """Time the block on the monotonic clock (``time.perf_counter``)
        into stage ``name``; while a torch profiler records, the block is
        also the span ``nanomod.<name>`` of its trace."""
        prof = _profiler()
        span = None
        if prof is not None:
            span = prof.record_function(f"nanomod.{name}")
            span.__enter__()
        t0 = time.perf_counter()
        with self._lock:
            st = self._stages.get(name)
            if st is None:
                st = self._stages[name] = StageStats(name, unit=unit)
                self._order.append(name)
        h = _StageHandle(st)
        try:
            yield h
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                st.seconds += dt
                st.items += h.n
                st.calls += 1
            if span is not None:
                span.__exit__(None, None, None)

    def add(self, name: str, items: int, seconds: float, unit: str = "items"):
        """Record a stage measured externally; it is no span of a trace.
        Its seconds need not be wall time: ``host_cpu`` holds the process
        CPU seconds of a whole detect (``time.process_time``: user and
        system time of all threads), beside the positions tested."""
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

    def reset(self):
        with self._lock:
            self._stages.clear()
            self._order.clear()


_global = Observer()


def observer() -> Observer:
    return _global


def stage(name: str, unit: str = "items"):
    return _global.stage(name, unit=unit)


def report(out_level: int = OUTPUT_INFO):
    return _global.report(out_level)


@contextlib.contextmanager
def device_trace(out_dir: Optional[str] = None, device=None):
    """torch.profiler trace around a block.

    Active when `out_dir` is given or NANOMOD_PROFILE_DIR is set; otherwise
    a no-op.  Records the host's activity always and the card's (kernels,
    copies) when `device` is a CUDA device, and writes one Chrome trace a
    process, ``trace.rank<r>.json`` in `out_dir` (r is the
    torch.distributed rank, 0 without a process group), in which every
    stage of the block is a ``nanomod.<stage>`` span.  The block should
    end by synchronizing the card, so that its last kernels are in the
    trace."""
    out_dir = out_dir or os.environ.get("NANOMOD_PROFILE_DIR")
    if not out_dir:
        yield
        return
    import torch
    import torch.distributed as tdist
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    rank = tdist.get_rank() if tdist.is_initialized() else 0
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, f"trace.rank{rank}.json"))
