"""The port's native loader (nanomod_tpu_torch/native/build.py) builds a
library under an inter-process lock through a temporary file, so that
processes starting at once (test workers, CLI processes) never open a
half-written library.
"""

import ctypes
import os
import shutil
import struct
import subprocess
import sys
import time

import pytest

from nanomod_tpu_torch.native import build as native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "traceback"

_WORKER = r"""
import ctypes, sys, time
sys.path.insert(0, sys.argv[1])
from nanomod_tpu_torch.native import build as native
start = float(sys.argv[3])
while time.time() < start:
    time.sleep(0.001)
lib = ctypes.CDLL(native.build("traceback", sys.argv[2], sys.argv[2]))
print("ok" if hasattr(lib, "decode_walk_batch") else "no symbol")
"""


def _whole_elf(path):
    """An ELF64 file whose section header table ends where the file ends
    (ld writes it last)."""
    with open(path, "rb") as f:
        head = f.read(64)
    if head[:5] != b"\x7fELF\x02":
        return False
    shoff, = struct.unpack_from("<Q", head, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", head, 0x3A)
    return shoff + shentsize * shnum == os.path.getsize(path)


def _copy_source(tmp_path):
    d = str(tmp_path / "native")
    os.makedirs(d)
    shutil.copyfile(native.source_path(NAME), os.path.join(d, f"{NAME}.cpp"))
    return d


def test_four_processes_build_at_once(tmp_path):
    d = _copy_source(tmp_path)
    start = time.time() + 2.0
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, ROOT, d,
                               repr(start)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert [o.strip() for o, _ in outs] == ["ok"] * 4, outs
    lib = native.lib_path(NAME, build_dir=d)
    assert _whole_elf(lib)
    assert hasattr(ctypes.CDLL(lib), "decode_walk_batch")
    assert sorted(os.listdir(d)) == [f"lib{NAME}.so", f"{NAME}.cpp"]


def test_half_written_library_is_rebuilt(tmp_path):
    """A library cut short by an in-place writer (newer than its source,
    so it looks up to date) is rebuilt whole before it is opened."""
    d = _copy_source(tmp_path)
    lib = native.build(NAME, src_dir=d, build_dir=d)
    with open(lib, "rb") as f:
        data = f.read()
    with open(lib, "wb") as f:
        f.write(data[: len(data) // 3])
    assert not _whole_elf(lib) and not native.is_whole(lib)
    dll = native.open_library(NAME, src_dir=d, build_dir=d)
    assert hasattr(dll, "decode_walk_batch")
    assert _whole_elf(lib)


def test_require_returns_the_handles():
    libs = native.require("sort_core", "traceback")
    assert libs == (native.load_native("sort_core"),
                    native.load_native("traceback"))
    assert hasattr(libs[1], "decode_walk_batch")
    with pytest.raises(RuntimeError, match="no_such_lib"):
        native.require("no_such_lib")


def test_probe_is_stale_after_its_include_changes(tmp_path):
    """fast5_probe.cpp #includes fast5_ingest.cpp: a change to either makes
    the probe library stale, so --resume never runs an old parser."""
    lib, = native.require("fast5_probe")
    d = str(tmp_path)
    for src in ("fast5_probe.cpp", "fast5_ingest.cpp"):
        shutil.copyfile(os.path.join(native.SRC_DIR, src),
                        os.path.join(d, src))
    copy = native.lib_path("fast5_probe", build_dir=d)
    shutil.copyfile(lib._name, copy)
    srcs = native._inputs("fast5_probe", native.source_path("fast5_probe", d))
    assert [os.path.basename(s) for s in srcs] == ["fast5_probe.cpp",
                                                   "fast5_ingest.cpp"]
    now = time.time()
    os.utime(copy, (now, now))
    for s in srcs:
        os.utime(s, (now - 10, now - 10))
    assert native._up_to_date(copy, srcs)
    os.utime(srcs[1], (now + 10, now + 10))
    assert not native._up_to_date(copy, srcs)
