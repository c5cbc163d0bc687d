"""The port's detect_from_pools + save_sign_test must byte-match the
checked-in golden sign-test files (tests/golden, made by the independent
scipy-only oracle), on the device backend (plain K3 on the CPU) and on the
native host backend.  The coverage-capped variant (K6's plain version on
the CPU, for both backends) must byte-match the golden sign-test and
_meanstd.cvs files, whatever the tile size."""

import os

import numpy as np
import pytest

from nanomod_tpu_torch.accum.pools import PoolBuilder
from nanomod_tpu_torch.config import DetectConfig, StatConfig
from nanomod_tpu_torch.detect import detect_from_pools, save_sign_test

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

VARIANTS = {
    "stouffer": StatConfig(test_method="stouffer"),
    "fisher": StatConfig(test_method="fisher"),
    "ks": StatConfig(test_method="ks"),
    "nb0": StatConfig(test_method="stouffer", neighbor_pvalues=0),
}


@pytest.fixture(scope="module")
def pools():
    z = np.load(os.path.join(GOLDEN, "reads.npz"))
    out = []
    for group in ("group1", "group2"):
        b = PoolBuilder()
        for i in range(len(z[f"{group}_chrom"])):
            b.add_read(str(z[f"{group}_chrom"][i]),
                       str(z[f"{group}_strand"][i]),
                       int(z[f"{group}_start"][i]), z[f"{group}_vals"][i],
                       z[f"{group}_bases"][i])
        out.append(b.finalize())
    return out


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_golden_sign_test(pools, tmp_path, name, backend):
    cfg = DetectConfig(out_folder=str(tmp_path), file_id=name,
                       stats=VARIANTS[name])
    table, order = detect_from_pools(pools[0], pools[1], cfg, device="cpu",
                                     backend=backend)
    with open(save_sign_test(table, cfg), "rb") as f:
        got = f.read()
    with open(os.path.join(GOLDEN, f"golden_{name}_sign_test.txt"), "rb") as f:
        want = f.read()
    assert len(want) > 10_000
    assert got == want


# tests/test_golden.py VARIANTS["capped"]
CAPPED = StatConfig(test_method="stouffer", coverages=(8, 8), downsampling=20,
                    downsampling_quantile=0.25, downsampling_seed=0)


@pytest.mark.parametrize("tile_positions", [16384, 40])
@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("suffix", ["sign_test.txt", "meanstd.cvs"])
def test_golden_capped(pools, tmp_path, suffix, backend, tile_positions):
    cfg = DetectConfig(out_folder=str(tmp_path), file_id="capped",
                       stats=CAPPED, mstd=True,
                       tile_positions=tile_positions)
    table, order = detect_from_pools(pools[0], pools[1], cfg, device="cpu",
                                     backend=backend)
    save_sign_test(table, cfg)
    with open(os.path.join(str(tmp_path), f"capped_{suffix}"), "rb") as f:
        got = f.read()
    with open(os.path.join(GOLDEN, f"golden_capped_{suffix}"), "rb") as f:
        want = f.read()
    assert len(want) > 10_000
    assert got == want
