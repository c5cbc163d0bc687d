"""nanomod_tpu_torch — the PyTorch + CUDA port of nanomod_tpu.

The JAX package ``nanomod_tpu`` stays the reference.  This package runs the
same main path, ``Annotate`` (raw FAST5 -> corrected FAST5) then ``detect``
(two corrected groups -> ``<FileID>_sign_test.txt`` and a ranked site list),
and the evaluation harness on one NVIDIA Hopper card:

  * resquiggle/ — k-mer seeding, the banded affine-gap DP (CUDA kernel K1),
    the device traceback walk (CUDA kernel K2), the native correction core
    and FAST5 write-back;
  * stats/      — the per-position test battery (CUDA kernel K3), the
    coverage-capped KS (CUDA kernel K6, with a bit-exact replica of its
    ``jax.random`` draws), the float64 host finalizers, neighbor p-value
    combination;
  * rank/       — site ranking;
  * harness/    — the simulate / simulat2 / DownSampling mixing trials;
  * native/     — the C++ host libraries, their ctypes binds and their
    race-free build into ``_build/``;
  * detect.py, cli.py — the entry points.

The package imports nothing of ``nanomod_tpu``.  What it shares with the
reference it holds as copies, each marked on its first line with its
source: ``config.py``, ``io/`` (fast5, fasta), ``signal/`` (events,
normalize), ``accum/pools.py``, ``utils/observe.py`` (without the
jax.profiler trace), ``tune_malloc`` below, the seven C++ sources and five
binds of ``native/``, and the host modules ``resquiggle/seed.py``,
``resquiggle/annotate.py``, ``stats/special.py``, ``stats/combine.py``,
``rank/ranking.py`` and ``harness/simulate.py``.  Each kernel has a plain
PyTorch version in the same module; a wrapper runs the plain version only
for tensors on the CPU and launches its kernel, or raises, for tensors on a
CUDA device.
"""

__version__ = "0.1.0"


_MALLOC_TUNED = False


# Copied from nanomod_tpu/__init__.py tune_malloc.
def tune_malloc():
    """Keep large heap buffers out of per-allocation mmap/munmap.

    glibc services every allocation above M_MMAP_THRESHOLD (128 kB
    default) with a fresh mmap and returns it to the kernel on free, so
    each large numpy temporary faults its pages in from scratch.  Raising
    the thresholds keeps freed blocks in the arena for reuse.  Trade-off:
    RSS stays at the high-water mark; peak memory is unchanged.

    Called lazily from the pipeline entry points rather than at package
    import, so a host application that merely imports the package keeps
    its own malloc behavior.  Disable with NANOMOD_NO_MALLOC_TUNE=1."""
    import ctypes
    import os
    import sys

    global _MALLOC_TUNED
    if _MALLOC_TUNED:
        return
    _MALLOC_TUNED = True
    if os.environ.get("NANOMOD_NO_MALLOC_TUNE") == "1":
        return
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 2**31 - 1)
        libc.mallopt(M_TRIM_THRESHOLD, 2**31 - 1)
    except OSError:
        pass
