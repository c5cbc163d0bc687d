"""The JAX package's native libraries, loaded before a port test compares
its output with the reference's.

The reference's Annotate, detect and harness take a native (C++) path
where ``nanomod_tpu.native.build.load_native`` gives a library, and a
Python path (the h5py FAST5 writer, numpy sorts) where it gives None.  Its
build runs g++ straight into ``nanomod_tpu/native/lib<name>.so`` with no
lock between processes, and ``load_native`` remembers a failed load for
the rest of the process.  Under pytest-xdist one worker can open another
worker's half-written library and remember None; the reference then writes
its corrected FAST5s through h5py, valid files whose bytes are not those of
the native writer the port follows, and a byte-equality test fails for a
reason that is not the port's.

``require_reference_native`` forgets such a None and loads the library
again, with a short back-off while another process's g++ finishes, and
raises naming the library if it still does not load: a port test never
compares against the reference's fallback, and never skips for it.  It
changes no file of the JAX package; it reads and resets entries of that
package's private ``_CACHE``.

Port test files that run such a reference path call it from their module
fixtures (``from test_torch_refnative import require_reference_native``,
as they import ``fixtures``).
"""

import shutil
import time

import pytest

from nanomod_tpu.native import build as jbuild

# every native library of the JAX package; what its detect reads, sorts
# and formats with
ALL_LIBS = ("fast5_write", "fast5_ingest", "traceback", "seed_core",
            "annotate_core", "sort_core", "format_core")
DETECT_LIBS = ("fast5_ingest", "sort_core", "format_core")
WAIT_S = 60.0


def require_reference_native(*names, wait_s: float = WAIT_S):
    """Load each of the JAX package's native libraries ``names``; a load
    that failed earlier in this process is forgotten and tried again
    until ``wait_s`` seconds have passed.  Raises RuntimeError naming the
    library when it does not load, or when g++ is missing."""
    for name in names:
        deadline = time.monotonic() + wait_s
        delay = 0.1
        while jbuild.load_native(name) is None:
            if shutil.which("g++") is None:
                raise RuntimeError(
                    f"the JAX package's native library {name!r} does not "
                    f"load and g++ is not on PATH to build it")
            with jbuild._LOCK:
                if name in jbuild._CACHE and jbuild._CACHE[name] is None:
                    del jbuild._CACHE[name]
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"the JAX package's native library {name!r} did not "
                    f"load within {wait_s:g} s")
            time.sleep(delay)
            delay = min(2 * delay, 4.0)


@pytest.mark.parametrize("name", ALL_LIBS)
def test_reference_library_loads(name):
    require_reference_native(name)
    assert jbuild._CACHE[name] is not None


def test_native_fast5_writer_available():
    require_reference_native(*ALL_LIBS)
    assert all(jbuild._CACHE[name] is not None for name in ALL_LIBS)
    assert jbuild.native_available("fast5_write")


def _flaky_build(monkeypatch, failures):
    """_build raising OSError (a half-written library) ``failures`` times,
    then building as before; returns the list of its calls."""
    build = jbuild._build
    calls = []

    def flaky(name):
        calls.append(name)
        if len(calls) <= failures:
            raise OSError(f"lib{name}.so: file too short")
        return build(name)
    monkeypatch.setattr(jbuild, "_build", flaky)
    return calls


def test_a_remembered_failure_is_loaded_again(monkeypatch):
    """A None that load_native remembered is forgotten and the library
    loaded once the file is whole (the third attempt here)."""
    require_reference_native("fast5_write")
    monkeypatch.delitem(jbuild._CACHE, "fast5_write")
    calls = _flaky_build(monkeypatch, failures=2)
    assert jbuild.load_native("fast5_write") is None
    require_reference_native("fast5_write", wait_s=10)
    assert len(calls) == 3
    assert jbuild.native_available("fast5_write")


def test_a_library_that_never_loads_raises(monkeypatch):
    monkeypatch.delitem(jbuild._CACHE, "sort_core", raising=False)
    calls = _flaky_build(monkeypatch, failures=10 ** 6)
    with pytest.raises(RuntimeError, match="'sort_core' did not load"):
        require_reference_native("sort_core", wait_s=0.5)
    assert len(calls) >= 2


def test_without_gpp_it_raises(monkeypatch):
    monkeypatch.setitem(jbuild._CACHE, "format_core", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="'format_core' does not load"):
        require_reference_native("format_core")
