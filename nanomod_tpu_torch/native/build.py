"""Race-free build and load of the port's native C++ libraries.

The port runs its host code in C++: ``nanomod_tpu_torch/native/<name>.cpp``
(copies of the reference's sources, held byte-equal to them by
tests/test_torch_standalone.py, and the port's own fast5_probe.cpp and
fast5_rawwrite.cpp, which include fast5_ingest.cpp and fast5_write.cpp),
bound with ctypes by the ``*_bind``
modules beside them.  ``load_native`` builds each library with g++ once,
under an inter-process lock (``fcntl.flock`` on a file in
``nanomod_tpu_torch/_build/``), into a temporary file that ``os.replace``
moves to ``_build/lib<name>.so``: a library there is either absent or
whole, so processes starting at once (test workers, the CLI processes of
one run) never open a half-written one.  A library that is cut short all
the same (``is_whole``), or that does not open on this machine, is rebuilt
before it is opened.  Call ``require``
with the libraries an entry point needs; it returns their handles and
raises naming the first that cannot be built.  A build of lib<name>.so is
the stage ``build.<name>`` (one a build), so a build inside a timed run
shows in its stages and as a span of its trace.
"""

from __future__ import annotations

import ctypes
import _ctypes
import fcntl
import os
import struct
import subprocess
import threading

from nanomod_tpu_torch.utils.observe import stage

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(SRC_DIR), "_build")
LOCK_PATH = os.path.join(BUILD_DIR, "native.lock")

# g++ flags per library, beyond "-O3 -march=native -shared -fPIC"
_EXTRA_FLAGS = {
    "annotate_core": ["-pthread"],
    "fast5_ingest": ["-lz", "-pthread"],
    "fast5_probe": ["-lz", "-pthread"],
    "fast5_write": ["-lz", "-pthread"],
    "fast5_rawwrite": ["-lz", "-pthread"],
    "sort_core": ["-pthread"],
    "traceback": ["-pthread"],
    "format_core": ["-pthread"],
}

# optional faster deflate backend (standard zlib output): the first flag
# set that links wins; plain zlib is the guaranteed fallback
_OPTIONAL_FLAGS = {
    "fast5_write": [["-l:libdeflate.so.0"], ["-ldeflate"],
                    ["-DNO_LIBDEFLATE"]],
    "fast5_ingest": [["-l:libdeflate.so.0"], ["-ldeflate"],
                     ["-DNO_LIBDEFLATE"]],
    "fast5_probe": [["-l:libdeflate.so.0"], ["-ldeflate"],
                    ["-DNO_LIBDEFLATE"]],
    "fast5_rawwrite": [["-l:libdeflate.so.0"], ["-ldeflate"],
                       ["-DNO_LIBDEFLATE"]],
}

# sources a library's source #includes: a library is stale when any of
# them is newer than it
_DEPS = {"fast5_probe": ["fast5_ingest.cpp"],
         "fast5_rawwrite": ["fast5_write.cpp"]}

_LOCK = threading.Lock()
_CACHE = {}
_ERRORS = {}


def source_path(name: str, src_dir: str = SRC_DIR) -> str:
    return os.path.join(src_dir, f"{name}.cpp")


def lib_path(name: str, build_dir: str = BUILD_DIR) -> str:
    return os.path.join(build_dir, f"lib{name}.so")


def is_whole(path: str) -> bool:
    """True for an ELF64 file that ends at or after the end of its section
    header table, which the linker writes last: a library cut short by a
    writer still at work fails this (and may crash dlopen with SIGBUS
    rather than raise)."""
    try:
        with open(path, "rb") as f:
            head = f.read(64)
        size = os.path.getsize(path)
    except OSError:
        return False
    if len(head) < 64 or head[:5] != b"\x7fELF\x02":
        return False
    shoff, = struct.unpack_from("<Q", head, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", head, 0x3A)
    return size >= shoff + shentsize * shnum > 0


def _opens(lib: str) -> bool:
    """Whether ``lib`` opens here.  The check's handle is closed again, so
    that it leaves nothing mapped: a library file cut short later would
    otherwise fault the process (SIGBUS) when it touches those pages."""
    try:
        handle = ctypes.CDLL(lib)._handle
    except OSError:
        return False
    _ctypes.dlclose(handle)
    return True


def _inputs(name: str, src: str) -> list:
    """The source of library ``name`` and the sources it includes."""
    here = os.path.dirname(src)
    return [src] + [os.path.join(here, d) for d in _DEPS.get(name, [])]


def _up_to_date(lib: str, srcs: list) -> bool:
    """Newer than each of its sources, whole, and it opens here (a library
    built on another machine may link a library this one lacks)."""
    return (os.path.exists(lib)
            and os.path.getmtime(lib) >= max(map(os.path.getmtime, srcs))
            and is_whole(lib) and _opens(lib))


def _compile(name: str, src: str, out: str):
    """g++ with the library's flags, trying its optional flag sets in
    order until one links and loads; raises RuntimeError with the last
    error when none does."""
    cmd = (["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", out,
            src] + _EXTRA_FLAGS.get(name, []))
    err = ""
    for opt in _OPTIONAL_FLAGS.get(name, [[]]):
        proc = subprocess.run(cmd + opt, capture_output=True, text=True)
        if proc.returncode != 0:
            err = proc.stderr
            continue
        # the linker may find a library (libdeflate) that the dynamic
        # loader does not: such a build links but never opens
        if _opens(out):
            return
        err = f"{out} links with {opt} but does not open"
    raise RuntimeError(f"g++ failed to build native library {name!r}:\n{err}")


def build(name: str, src_dir: str = SRC_DIR,
          build_dir: str = BUILD_DIR) -> str:
    """Build ``build_dir``/lib<name>.so from ``src_dir``/<name>.cpp unless
    it is up to date and whole, under the inter-process lock, through a
    temporary file; returns its path."""
    lib = lib_path(name, build_dir)
    src = source_path(name, src_dir)
    os.makedirs(BUILD_DIR, exist_ok=True)
    os.makedirs(build_dir, exist_ok=True)
    with open(LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _up_to_date(lib, _inputs(name, src)):
            tmp = f"{lib}.{os.getpid()}.tmp"
            try:
                with stage(f"build.{name}", unit="builds") as s:
                    _compile(name, src, tmp)
                    s.add(1)
                os.replace(tmp, lib)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return lib


def open_library(name: str, src_dir: str = SRC_DIR,
                 build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Build lib<name>.so if it is stale or not whole, then dlopen it."""
    return ctypes.CDLL(build(name, src_dir, build_dir))


def load_native(name: str):
    """ctypes.CDLL of native/<name>.cpp, built race-free on first use and
    kept for the process; None when it cannot be built (no g++ or missing
    headers), and the next call tries again."""
    with _LOCK:
        if name not in _CACHE:
            try:
                _CACHE[name] = open_library(name)
            except (OSError, RuntimeError) as e:   # FileNotFoundError: no g++
                _ERRORS[name] = str(e)
                return None
        return _CACHE[name]


def require(*names: str) -> tuple:
    """Load each named library (race-free) and return their handles in
    order; raises RuntimeError naming the first that cannot be built."""
    libs = []
    for name in names:
        lib = load_native(name)
        if lib is None:
            raise RuntimeError(f"native library {name!r} failed to build or "
                               f"load (needs g++; the fast5 libraries also "
                               f"zlib headers): {_ERRORS.get(name, '')}")
        libs.append(lib)
    return tuple(libs)
