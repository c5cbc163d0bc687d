"""Compare K1's and K2's machine code and raw launch times between two
checkouts of the repository, on one card.

    python3 nanomod_tpu_torch/kernels/sass_ab.py DIR_A DIR_B [--out DIR]

DIR_A and DIR_B are roots of checkouts (for example an unpacked ``git
archive`` of a parent commit and the working tree).  Each checkout's
``csrc/banded_sw.cu`` (K1) and ``csrc/walk.cu`` (K2) is compiled with the
flags of DIR_B's ``kernels/build.py`` into objects and a shared library
under ``--out`` (default ``chiprun_out/sass_ab``).  For the instantiations
the main path runs (K1 at 4 lanes a thread, W = 128, not ragged; K2 with
its codes four a byte) it prints ptxas's registers and spills, the SASS
instruction count, and the opcodes whose counts differ between A and B;
their two SASS listings and opcode-sequence diff are written to ``--out``.
For every instantiation of K1's wide kernel (W > NARROW_MAX_W) in A and
in B it prints ptxas's registers and spills and the SASS instructions of
the row loop (``row_loop``: a row's, per thread, and a cell's).

Then both libraries are loaded into one process and their C entry points
called through ctypes, with no PyTorch wrapper, on the same inputs as
``ab_time.py`` (B 256, M 1024, W 128), alternately A, B, B, A, twice:
10-launch means and single launches between two CUDA events, each the
median of 5 after a warm-up.  B's PyTorch wrappers (``banded_sw_cuda``,
``banded.walk``, also on the raw calls' buffers) are timed in the same
way beside its raw calls, and the host time of a wrapper call
(``time.perf_counter`` over 200 calls, synced after), so that a
wrapper's cost shows apart from its kernel's.  The
outputs of A and B must be equal.  Prints the card's name and power limit
and one JSON line of results.
"""

import argparse
import collections
import ctypes
import difflib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

B, M, W = 256, 1024, 128
SOURCES = ("banded_sw.cu", "walk.cu")
# the main path's instantiation in each checkout: a mangled-name pattern
MAIN = {"banded_sw": r"banded_sw_kernelILi4E(?:Lb0ELb0E)?E",
        "walk": r"walk_packed_kernel|walk_kernelILb1EE"}
INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][\w.]*)")


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def _build(roots, out, nvcc, flags):
    """One object a source and one shared library a checkout, all sources
    compiled at once; returns ({tag: library}, {(tag, source): object},
    {(tag, source): ptxas log})."""
    jobs = {}
    for tag, root in zip("AB", roots):
        for src in SOURCES:
            obj = os.path.join(out, f"{tag}_{src[:-3]}.o")
            cmd = [nvcc] + flags + ["-c", os.path.join(
                root, "nanomod_tpu_torch", "csrc", src), "-o", obj]
            jobs[tag, src] = (obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    objs, logs = {}, {}
    for key, (obj, cmd, proc) in jobs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{' '.join(cmd)}\n{logs[key]}")
        objs[key] = obj
    libs = {}
    for tag in "AB":
        libs[tag] = os.path.join(out, f"lib_{tag}.so")
        subprocess.run([nvcc, "-shared", "-o", libs[tag]]
                       + [objs[tag, src] for src in SOURCES], check=True)
    return libs, objs, logs


def _functions(obj, nvcc):
    """{mangled name: ([opcodes], [listing lines])} of an object's SASS."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = ([], [])
        elif cur is not None:
            funcs[cur][1].append(line)
            m = INSN.search(line)
            if m:
                funcs[cur][0].append(m.group(1))
    return funcs


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                       r"([^;]*);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
TARGET = re.compile(r"(0x[0-9a-f]+)|`\((\.L_x_\d+)\)")


def row_loop(lines):
    """The row loop of a K1 listing: the innermost backward branch whose
    range holds a block barrier (BAR).  Returns {"instructions": SASS
    instructions in the loop, "bars": its BARs} (a row body has one BAR,
    so instructions / bars is a row's, per thread); None without one."""
    insts, labels, pending = [], {}, []
    for line in lines:
        lab = LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = SASS_LINE.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        insts.append((addr, m.group(3), m.group(4)))
    loops = []
    for addr, op, rest in insts:
        if not op.startswith("BRA"):
            continue
        t = TARGET.search(rest)
        if not t:
            continue
        target = int(t.group(1), 16) if t.group(1) else labels.get(
            t.group(2), addr)
        if target < addr:
            body = [o for a, o, _ in insts if target <= a <= addr]
            bars = sum(o.startswith("BAR") for o in body)
            if bars:
                loops.append((len(body), bars))
    if not loops:
        return None
    n, bars = min(loops)
    return {"instructions": n, "bars": bars}


def wide_stats(obj, nvcc, log, listings=None):
    """{instantiation: ptxas registers / spills and the row loop's
    instructions, a row and a cell} of every banded_sw_wide_kernel in the
    object ``obj`` (its -Xptxas -v log ``log``); with ``listings`` (a path
    prefix) each instantiation's SASS is written to
    ``<listings><instantiation>.sass``."""
    out = {}
    for name, (_, lines) in _functions(obj, nvcc).items():
        lanes = re.search(r"banded_sw_wide_kernelILi(\d+)E", name)
        if not lanes:
            continue
        loop = row_loop(lines)
        if loop:
            per_row = loop["instructions"] / loop["bars"]
            loop.update(per_row=per_row, per_cell=per_row / int(lanes[1]))
        short = re.search(r"banded_sw_wide_kernel(I[^_]*E)", name)
        key = short[1] if short else name
        out[key] = {"ptxas": _ptxas(log, name), "row_loop": loop}
        if listings:
            with open(f"{listings}{key}.sass", "w") as fh:
                fh.write("\n".join(lines) + "\n")
    return out


def _ptxas(log, name):
    """ptxas's lines (stack, spills, registers) for the function ``name``
    in a -Xptxas -v log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            return " | ".join(x.split(":", 1)[-1].strip()
                              for x in lines[i + 2:i + 4])
    return "not found"


def compare_sass(roots, out, nvcc, flags):
    libs, objs, logs = _build(roots, out, nvcc, flags)
    res = {f"log_{tag}": logs[tag, "banded_sw.cu"] for tag in "AB"}
    funcs = {}
    for (tag, src), obj in objs.items():
        funcs[tag, src] = _functions(obj, nvcc)
    for src, key in zip(SOURCES, MAIN):
        pick = {}
        for tag in "AB":
            names = [n for n in funcs[tag, src] if re.search(MAIN[key], n)]
            if len(names) != 1:
                raise RuntimeError(f"{tag} {src}: {names}")
            pick[tag] = names[0]
        ops = {t: funcs[t, src][pick[t]][0] for t in "AB"}
        for t in "AB":
            with open(os.path.join(out, f"{t}_{key}.sass"), "w") as fh:
                fh.write("\n".join(funcs[t, src][pick[t]][1]) + "\n")
        ca, cb = (collections.Counter(ops[t]) for t in "AB")
        diff = {op: [ca[op], cb[op]] for op in sorted(set(ca) | set(cb))
                if ca[op] != cb[op]}
        with open(os.path.join(out, f"{key}_opcodes.diff"), "w") as fh:
            fh.writelines(difflib.unified_diff(
                [o + "\n" for o in ops["A"]], [o + "\n" for o in ops["B"]],
                f"A {pick['A']}", f"B {pick['B']}", n=2))
        res[key] = {
            "functions": pick,
            "instructions": [len(ops["A"]), len(ops["B"])],
            "same_opcode_sequence": ops["A"] == ops["B"],
            "opcode_counts_differ": diff,
            "ptxas": {t: _ptxas(logs[t, src], pick[t]) for t in "AB"},
        }
    return libs, res


def _walk_takes_best(root):
    """Whether the checkout's nm_walk takes the DP's best scores (a fifth
    pointer: the 12-byte header), from its kernels/build.py signature."""
    with open(os.path.join(root, "nanomod_tpu_torch", "kernels",
                           "build.py")) as f:
        sig = re.search(r'"nm_walk": \[([^\]]*)\]', f.read())
    return bool(sig) and sig.group(1).count("_vp") == 6


def _entry(lib, root):
    """The library's K1 and K2 entry points with their argtypes, whether
    it is a checkout with row pitches (nm_walk) or without, and whether
    its nm_walk takes the best scores."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll = ctypes.CDLL(lib)
    pitched = hasattr(dll, "nm_walk")
    best = pitched and _walk_takes_best(root)
    dll.nm_banded_sw.argtypes = ([vp] * 7 + [i] * (4 if pitched else 3)
                                 + [f] * 4 + [vp])
    walk = dll.nm_walk if pitched else dll.nm_walk_packed
    walk.argtypes = ([vp] * (5 if best else 4) + [i] * (5 if pitched else 3)
                     + [vp])
    dll.nm_banded_sw.restype = walk.restype = ctypes.c_int
    return dll, walk, pitched, best


def _time(torch, fn, n, reps=5):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / n)
    return float(np.median(ts))


def time_raw(libs, roots):
    sys.path.insert(0, roots[1])
    import torch
    from nanomod_tpu_torch.resquiggle import banded
    from nanomod_tpu_torch.resquiggle.banded_kernel import banded_sw_cuda
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 4, (B, M + W)).astype(np.uint8)
    read = ref[:, W // 2: W // 2 + M].copy()
    sub = rng.random((B, M)) < 0.05
    read[sub] = rng.integers(0, 4, int(sub.sum()))
    read, ref = (torch.from_numpy(x).to(dev) for x in (read, ref))
    lens = torch.full((B,), M, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls, outs, bufs = {}, {}, {}
    for tag, root in zip("AB", roots):
        dll, walk, pitched, takes_best = _entry(libs[tag], root)
        tb = torch.empty((B, M, W), dtype=torch.uint8, device=dev)
        best = torch.empty(B, dtype=torch.float32, device=dev)
        bi = torch.empty(B, dtype=torch.int32, device=dev)
        bk = torch.empty(B, dtype=torch.int32, device=dev)
        codes = torch.empty((B, (2 * M + W) // 4), dtype=torch.uint8,
                            device=dev)
        dims = (B, M, W, W) if pitched else (B, M, W)
        k1_args = ([read.data_ptr(), ref.data_ptr(), lens.data_ptr(),
                    tb.data_ptr(), best.data_ptr(), bi.data_ptr(),
                    bk.data_ptr()] + list(dims) + [2.0, -3.0, -5.0, -2.0,
                                                   stream])
        k2_args = ([tb.data_ptr(), bi.data_ptr(), bk.data_ptr()]
                   + ([None] if takes_best else []) + [codes.data_ptr()]
                   + list(dims)
                   + ([1] if pitched else []) + [stream])

        def k1(d=dll, a=k1_args):
            if d.nm_banded_sw(*a):
                raise RuntimeError("K1 launch failed")

        def k2(w=walk, a=k2_args):
            if w(*a):
                raise RuntimeError("K2 launch failed")
        k1()
        k2()
        torch.cuda.synchronize()
        bufs[tag] = (tb, best, bi, bk, codes)   # alive while called
        outs[tag] = [x.clone() for x in bufs[tag]]
        calls[tag] = {"banded_sw": k1, "walk": k2}
    for x, y in zip(outs["A"], outs["B"]):
        if not torch.equal(x, y):
            raise AssertionError("A's and B's outputs differ")
    tb_w, _, bi_w, bk_w = banded_sw_cuda(read, ref, lens)
    tb_b, _, bi_b, bk_b, _ = bufs["B"]
    calls["B wrapper"] = {
        "banded_sw": lambda: banded_sw_cuda(read, ref, lens),
        "walk": lambda: banded.walk(tb_w, bi_w, bk_w),
        # the wrapper on the raw calls' buffers: a buffer's effect apart
        # from the wrapper's
        "walk on B's raw buffers": lambda: banded.walk(tb_b, bi_b, bk_b)}
    times = collections.defaultdict(lambda: collections.defaultdict(list))
    for tag in ("A", "B", "B wrapper", "B wrapper", "B", "A") * 2:
        for name, fn in calls[tag].items():
            times[tag][name + " mean10"].append(_time(torch, fn, 10))
            times[tag][name + " single"].append(_time(torch, fn, 1))
    host = {}
    for name, fn in calls["B wrapper"].items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host[name + " host_us_a_call"] = (t1 - t0) / 200 * 1e6
    return {"ms": {t: dict(v) for t, v in times.items()},
            "wrapper_host": host}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "sass_ab"))
    args = ap.parse_args()
    roots = [os.path.abspath(d) for d in (args.dir_a, args.dir_b)]
    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, roots[1])
    from nanomod_tpu_torch.kernels import build as kbuild
    flags = [f for f in kbuild.NVCC_FLAGS if f not in ("-Xcompiler",
                                                        "-fPIC")]
    flags += ["-Xcompiler", "-fPIC"]
    print(_card())
    libs, res = compare_sass(roots, args.out, kbuild._nvcc(), flags)
    res["wide"] = {tag: wide_stats(
        os.path.join(args.out, f"{tag}_banded_sw.o"), kbuild._nvcc(),
        res.pop(f"log_{tag}"), os.path.join(args.out, f"{tag}_wide_"))
        for tag in "AB"}
    res["timing"] = time_raw(libs, roots)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
