"""Build and load the port's CUDA kernels (csrc/*.cu) through ctypes.

The kernels are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, at first use, into
``nanomod_tpu_torch/_build/`` (listed in .gitignore): one ``nvcc -c`` a
source, all started at once, then one link.  No PyTorch header is
included, so the build takes seconds, not minutes.  The library is rebuilt
when any source is newer than it, under an inter-process lock
(``fcntl.flock`` on ``_build/kernels.lock``), so that processes starting
at once (the ranks of one launch) run nvcc once.

Each C entry point launches its kernel on the stream it is given and
returns the ``cudaGetLastError()`` code of the launch.  Wrappers call it
through ``launch``, which makes the tensors' device the current CUDA device
for the call and passes that device's current stream (CUDA refuses a
launch to a stream of another device than the current one, and PyTorch
leaves cuda:0 current), then raises on a non-zero code.  Every wrapper adds
one to its entry of ``LAUNCHES`` where it launches its kernel, and nowhere
else, so a run can show that it went through the kernels.  A build is the
stage ``build.kernels`` (one a build), so a build inside a timed run shows
in its stages and as a span of its trace.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading
import time

from nanomod_tpu_torch.utils.observe import stage

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libnanomod_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")
LOCK_PATH = os.path.join(BUILD_DIR, "kernels.lock")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # the DP must round exactly like the reference's separate f32 ops:
    # no fused multiply-add contraction anywhere
    "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# kernel name -> launches made by its wrapper in this process
LAUNCHES = {"banded_sw": 0, "walk": 0, "battery": 0, "battery_pooled": 0,
            "capped_ks": 0, "stencil": 0, "accumulate": 0}

_LOCK = threading.Lock()
_LIB = {}
# (card, peer) pairs whose peer access is enabled
_PEERS = set()
BUILD_INFO = {"seconds": None, "rebuilt": False, "log": BUILD_LOG}

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_u = ctypes.c_uint
_SIGNATURES = {
    # read, ref, lens, tb, best, bi, bk, bsz, m, w, tb pitch, match,
    # mismatch, go, ge, stream
    "nm_banded_sw": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                     _f, _f, _f, _f, _vp],
    # tb, bi, bk, best (or None: no header), out, bsz, m, w, tb pitch,
    # packed, stream
    "nm_walk": [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _vp],
    # v1, c1, C1, v2, c2, C2, P, is_i16, milli, out, stream
    "nm_battery": [_vp, _vp, _i, _vp, _vp, _i, _i, _i, _i, _vp, _vp],
    # z, lab, n1, n2, P, N, d, two_rank_sum, tie_sum, stream
    "nm_battery_pooled": [_vp, _vp, _vp, _vp, _i, _i, _vp, _vp, _vp, _vp],
    # v1, c1, C1, v2, c2, C2, row_index, P, cov, repeats, q_idx, seed_hi,
    # seed_lo, is_i16, out, stream
    "nm_capped_ks": [_vp, _vp, _i, _vp, _vp, _i, _vp, _i, _i, _i, _i, _u,
                     _u, _i, _vp, _vp],
    # counts, row_index, P, repeats * cov, seed_hi, seed_lo, group, out,
    # stream
    "nm_capped_draws": [_vp, _vp, _i, _i, _u, _u, _i, _vp, _vp],
    # cols [nshards, 3, 7] words (host: six pointers and a first column a
    # side), nshards, L, k, cov, d, ne1, ne2, ok, stream
    "nm_stencil_step": [_vp, _i, _i, _i, _i, _vp, _vp, _vp, _vp, _vp],
    # peer card
    "nm_enable_peer_access": [_i],
    # pos, val, ok, n, genome_len, acc [genome_len, 4], stream
    "nm_accumulate": [_vp, _vp, _vp, _i, _i, _vp, _vp],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def _run_all(cmds):
    """Run the commands at once; returns [(cmd, returncode, output)]."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    done = []
    for cmd, p in procs:
        out = p.communicate()[0]
        done.append((cmd, p.returncode, out))
    return done


def _up_to_date(srcs) -> bool:
    newest = max(os.path.getmtime(s) for s in srcs)
    return os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= newest


def build() -> str:
    """Compile csrc/*.cu into LIB_PATH unless it is up to date, one nvcc a
    source in parallel, then link, under the inter-process lock; returns
    the library path.  Raises RuntimeError with nvcc's output on failure."""
    srcs = _sources()
    if _up_to_date(srcs):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _up_to_date(srcs):
            with stage("build.kernels", unit="builds") as s:
                _compile(srcs)
                s.add(1)
    return LIB_PATH


def _compile(srcs):
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    cus = [s for s in srcs if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o")
            for s in cus]
    tmp = f"{LIB_PATH}.{tag}"
    t0 = time.perf_counter()
    try:
        runs = _run_all([[nvcc] + NVCC_FLAGS + ["-c", s, "-o", o]
                         for s, o in zip(cus, objs)])
        if all(rc == 0 for _, rc, _ in runs):
            runs += _run_all([[nvcc, "-shared", "-o", tmp] + objs])
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        BUILD_INFO["rebuilt"] = True
        log = "".join(" ".join(cmd) + "\n" + out for cmd, _, out in runs)
        with open(BUILD_LOG, "w") as f:
            f.write(log)
        failed = [rc for _, rc, _ in runs if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(tmp, LIB_PATH)
    finally:
        for path in objs + [tmp]:
            if os.path.exists(path):
                os.remove(path)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes set."""
    with _LOCK:
        if "lib" not in _LIB:
            dll = ctypes.CDLL(build())
            for name, args in _SIGNATURES.items():
                fn = getattr(dll, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            dll.nm_error_string.argtypes = [ctypes.c_int]
            dll.nm_error_string.restype = ctypes.c_char_p
            _LIB["lib"] = dll
        return _LIB["lib"]


def check(rc: int, name: str):
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib().nm_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {rc} ({msg})")


def launch(name: str, entry: str, device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the raw handle of
    PyTorch's current stream on ``device``, with ``device`` the current
    CUDA device for the call (its shared-memory attributes and launch
    belong to that device); raises naming kernel ``name`` if the launch
    failed."""
    import torch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib(), entry)(*args, stream)
    check(rc, name)


def enable_peer_access(device, peer) -> None:
    """Let CUDA card ``device`` read the memory of card ``peer`` (once a
    pair in this process; nothing to do for one card).  Raises naming both
    cards when they cannot reach each other (the sharded stencil asks only
    for pairs that can, and copies the columns it needs across the
    others)."""
    import torch
    device, peer = torch.device(device), torch.device(peer)
    pair = (device.index, peer.index)
    if device == peer or pair in _PEERS:
        return
    with torch.cuda.device(device):
        rc = lib().nm_enable_peer_access(peer.index)
    if rc == -1:
        raise RuntimeError(f"{device} cannot read the memory of {peer} "
                           f"(cudaDeviceCanAccessPeer is 0)")
    check(rc, f"peer access {device} -> {peer}")
    _PEERS.add(pair)
