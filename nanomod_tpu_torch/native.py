"""Race-free build and load of the reference's native C++ libraries.

The port runs the reference's host code in C++ (nanomod_tpu/native/
<name>.cpp, bound with ctypes by nanomod_tpu.native.*_bind).  The
reference's loader (nanomod_tpu/native/build.py) compiles a library straight
into its final path and caches a failed load for the rest of the process,
so a process that opens a library while another process is still writing
it loses that library for good.  Several processes starting at once (test
workers, the CLI processes of one run) hit that.

``load_native`` here builds with the reference's own compiler flags, under
an inter-process lock (``fcntl.flock`` on a file in ``nanomod_tpu_torch/
_build/``), into a temporary file that ``os.replace`` moves into the path
the reference's binds load (``nanomod_tpu/native/lib<name>.so``, a build
output that .gitignore lists): there a library is either absent or whole.
One that the reference's loader is still writing in place, in a process
that does not take the lock, is seen to be cut short (``is_whole``) and
rebuilt before it is opened.  The loaded handle is put into the reference
loader's cache, so every reference bind in the process uses it and none
compiles in place.  Call ``require`` with the libraries an entry point needs
before the first reference bind runs; it returns their handles.

The reference loader keeps its flags, directory and cache in private names;
``_reference_loader`` is the one place that reads them, and it fails at
import if any is gone.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import struct
import subprocess
import threading

from nanomod_tpu.native import build as _ref_build

_REF_NAMES = ("_DIR", "_LOCK", "_CACHE", "_EXTRA_FLAGS", "_OPTIONAL_FLAGS")


def _reference_loader():
    """The reference loader module (nanomod_tpu/native/build.py), whose
    private names this loader shares: ``_DIR`` (sources and libraries),
    ``_EXTRA_FLAGS`` / ``_OPTIONAL_FLAGS`` (g++ flags per library) and
    ``_LOCK`` / ``_CACHE`` (its in-process handle cache).  Raises
    ImportError naming any that is missing."""
    missing = [n for n in _REF_NAMES if not hasattr(_ref_build, n)]
    if missing:
        raise ImportError(f"nanomod_tpu.native.build lacks {missing}: the "
                          f"port's native loader needs to be updated")
    return _ref_build


_ref = _reference_loader()

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
LOCK_PATH = os.path.join(BUILD_DIR, "native.lock")

_LOCK = threading.Lock()
_ERRORS = {}


def source_path(name: str, native_dir: str = _ref._DIR) -> str:
    return os.path.join(native_dir, f"{name}.cpp")


def lib_path(name: str, native_dir: str = _ref._DIR) -> str:
    return os.path.join(native_dir, f"lib{name}.so")


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


def _up_to_date(name: str, native_dir: str) -> bool:
    lib = lib_path(name, native_dir)
    src = source_path(name, native_dir)
    return (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(src)
            and is_whole(lib))


def _compile(name: str, native_dir: str, out: str):
    """g++ with the reference's flags (build.py _build), trying its
    optional flag sets in order; raises RuntimeError with the compiler's
    output when none links."""
    cmd = (["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", out,
            source_path(name, native_dir)]
           + _ref._EXTRA_FLAGS.get(name, []))
    err = ""
    for opt in _ref._OPTIONAL_FLAGS.get(name, [[]]):
        proc = subprocess.run(cmd + opt, capture_output=True, text=True)
        if proc.returncode == 0:
            return
        err = proc.stderr
    raise RuntimeError(f"g++ failed to build native library {name!r}:\n{err}")


def build(name: str, native_dir: str = _ref._DIR) -> str:
    """Build ``native_dir``/lib<name>.so from <name>.cpp beside it unless
    it is up to date and whole, under the inter-process lock, through a
    temporary file; returns its path."""
    lib = lib_path(name, native_dir)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _up_to_date(name, native_dir):
            tmp = f"{lib}.{os.getpid()}.tmp"
            try:
                _compile(name, native_dir, tmp)
                os.replace(tmp, lib)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return lib


def open_library(name: str, native_dir: str = _ref._DIR) -> ctypes.CDLL:
    """Build lib<name>.so if it is stale or not whole (a loader that does
    not take the lock, the reference's own in another process, may still
    be writing it in place), then dlopen it."""
    return ctypes.CDLL(build(name, native_dir=native_dir))


def load_native(name: str):
    """ctypes.CDLL of nanomod_tpu/native/<name>.cpp, built race-free on
    first use; None when it cannot be built (no g++ or missing headers),
    as the reference's load_native."""
    with _LOCK:
        with _ref._LOCK:
            cached = _ref._CACHE.get(name)
        if cached is not None:
            return cached
        try:
            dll = open_library(name)
        except (OSError, RuntimeError) as e:   # FileNotFoundError: no g++
            _ERRORS[name] = str(e)
            return None
        with _ref._LOCK:
            _ref._CACHE[name] = dll
        return dll


def require(*names: str) -> tuple:
    """Load each named library (race-free) before a reference bind needs
    it and return their handles in order; raises RuntimeError naming the
    first that cannot be built."""
    libs = []
    for name in names:
        lib = load_native(name)
        if lib is None:
            raise RuntimeError(f"native library {name!r} failed to build or "
                               f"load (needs g++; the fast5 libraries also "
                               f"zlib headers): {_ERRORS.get(name, '')}")
        libs.append(lib)
    return tuple(libs)
