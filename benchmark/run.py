"""Run one cell of the benchmark of nanomod_tpu_torch once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1
    python3 benchmark/run.py --list

A run (1) writes the cell's inputs from the seed in a child process
(benchmark/generate.py), (2) sets up the port on them and runs one whole
unit of work to warm every shape, (3) runs whole units of the cell's entry
until ``--seconds`` have passed, under torch.profiler with ``--trace 1``,
(4) compares the last outputs with the plain reference
(benchmark/reference/) and (5) prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics), device
(and with ``--trace 1`` the breakdown of the device trace), and last the
numbers compared, each beside its limit.  Those numbers are also the last
lines of standard error.

It exits with another code than 0, and prints no result, where CUDA is
not available or holds fewer cards than the cell asks for, and where JAX
or the JAX package was loaded into this process.  Inputs and outputs go
to a directory under TMPDIR that the run deletes; the port's build lands
in its own ``_build`` directory inside the checkout.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "nanomod_tpu")
# the port's switches that would change what a run measures
PROGRAM_ENV = ("NANOMOD_PROFILE_DIR", "NANOMOD_BATTERY_BACKEND",
               "NANOMOD_NO_MALLOC_TUNE")


def _log(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (nanomod_tpu_torch is not nanomod_tpu)."""
    names = {m.split(".")[0] for m in (modules if modules is not None
                                        else list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


def peak_host_gb() -> float:
    """This process's peak resident set, GB (10^9 bytes)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _environment(root: str):
    for k in PROGRAM_ENV:
        os.environ.pop(k, None)
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def _generate(workload, seed, out, threads, root):
    cmd = [sys.executable, "-m", "benchmark.generate", "--workload",
           workload, "--seed", str(seed), "--out", out, "--threads",
           str(threads), "--root", root]
    res = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True,
                         check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def _window(entry, state, seconds, trace_path, device, torch):
    """Whole units until ``seconds`` have passed.  Returns (window
    seconds, summed work, summed stages, per-unit battery rows, the
    units' host seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    work, stages, rows, unit_s = {}, {}, [], []
    on_cuda = device.startswith("cuda")

    def run_units():
        t0 = time.perf_counter()
        with record_function("bench.window"):
            while True:
                u0 = time.perf_counter()
                with record_function(entry.SPAN):
                    res = entry.unit(state)
                    if on_cuda:
                        torch.cuda.synchronize()
                unit_s.append(time.perf_counter() - u0)
                _log(f"unit {len(unit_s)} {unit_s[-1]:.3f} s, stages "
                     + json.dumps({k: round(v, 3)
                                   for k, v in res["stages"].items()}))
                for k, v in res["work"].items():
                    work[k] = work.get(k, 0) + v
                for k, v in res["stages"].items():
                    stages[k] = stages.get(k, 0.0) + v
                rows.extend(res.get("battery_rows", ()))
                if time.perf_counter() - t0 >= seconds:
                    break
        return time.perf_counter() - t0

    if trace_path is None:
        window_s = run_units()
    else:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_cuda else [])
        with profile(activities=acts) as prof:
            window_s = run_units()
        prof.export_chrome_trace(trace_path)
    return window_s, work, stages, rows, unit_s


def _device_info(torch, device, chips):
    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(max(
                    torch.cuda.max_memory_allocated(i)
                    for i in range(chips)))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run(a, root: str, device: str) -> int:
    import torch

    from benchmark.core import manifest, trace

    m = manifest.load(root)
    w = manifest.cell(m, a.workload)
    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            _log("torch.cuda.is_available() is False: no result")
            return 2
        if torch.cuda.device_count() < w["chips"]:
            _log(f"{w['name']} needs {w['chips']} cards, "
                 f"{torch.cuda.device_count()} found: no result")
            return 2
    cfg = manifest.config(m, w["config"], root)
    traffic = manifest.traffic(w["traffic"], root)
    entry = manifest.entry(traffic["entry"])
    threads = len(os.sched_getaffinity(0))
    torch.set_num_threads(threads)
    _log(f"host threads {threads} (the cores of os.sched_getaffinity), "
         f"passed to the port and to torch.set_num_threads")
    workdir = tempfile.mkdtemp(prefix="nanomod_bench_")
    try:
        t0 = time.perf_counter()
        inputs = _generate(w["name"], a.seed, os.path.join(workdir, "in"),
                           threads, root)
        _log(f"inputs {inputs['files']} files, {inputs['bytes']} bytes, "
             f"written in {time.perf_counter() - t0:.3f} s")
        ctx = SimpleNamespace(
            root=root, config=cfg, traffic=traffic, seed=a.seed,
            seconds=a.seconds, device=device, threads=threads, inputs=inputs,
            workdir=workdir, generator=manifest.generator(
                traffic["generator"]))
        state = entry.setup(ctx)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        trace_path = (os.path.join(workdir, "trace.json") if a.trace
                      else None)
        window_s, work, stages, rows, unit_s = _window(
            entry, state, a.seconds, trace_path, device, torch)
        host_gb = peak_host_gb()
        dev = _device_info(torch, device, w["chips"])
        written = inputs["bytes"] + work.pop("bytes_written", 0)
        units = json.dumps([round(u, 3) for u in unit_s])
        _log(f"set-up {setup_s:.3f} s; window {window_s:.3f} s, "
             f"{len(unit_s)} units of {units} s, work {json.dumps(work)}; "
             f"bytes written {written} (inputs and the window's outputs)")
        if "rejected" in work:
            _log(f"rejected attempts {work['rejected']}")
        reduced = trace.reduce(trace_path) if trace_path else None
        entry.release(state)
        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        numbers, info = entry.check(state)
        info["check_s"] = round(time.perf_counter() - t_check, 3)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    limits = traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(k in limits and v <= limits[k] for k, v in numbers.items())
    metrics = {}
    if a.trace:
        span = {entry.SPAN: sum(unit_s)}
        runv = SimpleNamespace(stages=stages, work=work, trace=reduced,
                               battery_rows=rows, spans=span,
                               window_s=window_s, traffic=traffic)
        for pm in manifest.per_layer(m, w["name"]):
            v = manifest.reader(pm["name"], root)(runv)
            if v is not None:
                metrics[pm["name"]] = {"value": v, "unit": pm["unit"]}
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
    else:
        values = {"setup_s": setup_s, "peak_host_gb": host_gb,
                  traffic["rate_metric"]: entry.rate(work, window_s)}
        for em in manifest.end_to_end(m, w["name"]):
            metrics[em["name"]] = {"value": values[em["name"]],
                                   "unit": em["unit"]}
    bad = forbidden_modules()
    if bad:
        _log(f"loaded in this process: {', '.join(bad)}: no result")
        return 3
    result = {"correct": bool(correct), "attempted": int(
        work.get("trials", work.get("units", 0))), "failed": 0,
        "metrics": metrics, "device": dev}
    if a.trace:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    _log("checked: " + json.dumps(info))
    for k, c in checks.items():
        print(f"[bench] check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None, root: str = ROOT, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true",
                    help="print the cells as the harness finds them")
    a = ap.parse_args(argv)
    if a.list:
        from benchmark.core import manifest
        print(json.dumps(manifest.cells(root), indent=1))
        return 0
    if a.workload is None or a.seed is None or a.seconds is None:
        ap.error("--workload, --seed and --seconds are required")
    _environment(root)
    return run(a, root, device)


if __name__ == "__main__":
    sys.exit(main())
