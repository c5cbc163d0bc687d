"""The whole-name check of what a run loaded, and the reference's
independence from the program."""

from __future__ import annotations

import subprocess
import sys

from benchmark import run
from benchmark.core import manifest


def test_whole_top_level_names():
    assert run.forbidden_modules(["nanomod_tpu_torch", "nanomod_tpu_torch.x",
                                  "numpy", "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["nanomod_tpu.stats", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "nanomod_tpu"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.detect, "
            "benchmark.reference.compare, benchmark.core.roofline, "
            "benchmark.core.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'nanomod_tpu_torch', 'nanomod_tpu', 'jax', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_sources_import_nothing_of_the_jax_package():
    import os
    import re
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|nanomod_tpu)"
                     r"(\s|\.|$)")
    for dirpath, _, files in os.walk(manifest.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        assert not bad.match(line), (f, line)
