"""The port imports torch and never jax (nor triton, which is imported only
inside the launching function of a Triton kernel), nor any module of the
JAX package ``nanomod_tpu``; its device selection never falls back."""

import os
import subprocess
import sys

import pytest
import torch

from nanomod_tpu_torch.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import nanomod_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    nanomod_tpu_torch.__path__, "nanomod_tpu_torch."))
for name in names:
    importlib.import_module(name)
print(",".join(names))
print("jax" in sys.modules, "triton" in sys.modules, "torch" in sys.modules)
print(",".join(sorted(m for m in sys.modules
                      if m == "nanomod_tpu" or m.startswith("nanomod_tpu."))))
"""


def test_no_port_module_imports_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip().splitlines()
    names = set(out[0].split(","))
    for mod in ("cli", "detect", "device", "metrics", "kernels.build",
                "resquiggle.banded", "resquiggle.banded_kernel",
                "resquiggle.pipeline", "resquiggle.seed",
                "resquiggle.external", "bench", "tools.fixtures",
                "resquiggle.annotate", "stats.kernels", "stats.battery",
                "stats.special", "stats.combine", "stats.threefry",
                "rank.ranking", "harness.simulate", "config", "io.fast5",
                "io.fasta", "signal.events", "signal.normalize",
                "accum.pools", "utils.observe", "native.build",
                "native.fast5_bind", "native.annotate_bind",
                "native.fast5_write_bind", "native.prepare_bind",
                "native.format_bind", "parallel", "parallel.dist",
                "parallel.mesh", "parallel.sharded", "parallel.shardmerge"):
        assert f"nanomod_tpu_torch.{mod}" in names, mod
    assert out[1] == "False False True", out[1]
    assert len(out) == 2 or out[2] == "", f"JAX-package modules: {out[2]}"


def test_resolve_device_cpu():
    assert resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_cuda_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


def test_resolve_device_rejects_other_backends():
    with pytest.raises(ValueError):
        resolve_device("meta")
