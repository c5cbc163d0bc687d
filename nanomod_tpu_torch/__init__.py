"""nanomod_tpu_torch — the PyTorch + CUDA port of nanomod_tpu.

The JAX package ``nanomod_tpu`` stays the reference.  This package runs the
same main path, ``Annotate`` (raw FAST5 -> corrected FAST5) then ``detect``
(two corrected groups -> ``<FileID>_sign_test.txt`` and a ranked site list),
on one NVIDIA Hopper card:

  * resquiggle/ — k-mer seeding, the banded affine-gap DP (CUDA kernel K1),
    the device traceback walk (CUDA kernel K2), the native correction core
    and FAST5 write-back;
  * stats/      — the per-position test battery (CUDA kernel K3) and the
    float64 host finalizers, neighbor p-value combination;
  * rank/       — site ranking;
  * detect.py, cli.py — the entry points.

It reuses by import only the reference modules that load no JAX
(``nanomod_tpu.config``, ``io``, ``native``, ``signal``, ``accum.pools``,
``utils.observe``).  Each kernel has a plain PyTorch version in the same
module; a wrapper runs the plain version only for tensors on the CPU and
launches its kernel, or raises, for tensors on a CUDA device.
"""

__version__ = "0.1.0"
