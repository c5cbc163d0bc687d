"""Kernels K1, K2 and K3 against their plain PyTorch versions on the card.

These tests need an NVIDIA card and nvcc; without a card they skip.  Run
them on the card with ``python -m pytest tests/test_torch_cuda.py -q``.
chip_smoke.py checks the same kernels at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from nanomod_tpu_torch.kernels import build as kbuild
from nanomod_tpu_torch.resquiggle import banded
from nanomod_tpu_torch.stats import battery, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    kbuild.lib()
    return torch.device("cuda", 0)


def _reads(rng, b, m, w):
    ref = rng.integers(0, 4, (b, m + w)).astype(np.uint8)
    read = np.empty((b, m), np.uint8)
    for i in range(b):
        read[i] = ref[i, w // 2: w // 2 + m]
        mut = rng.random(m) < 0.08
        read[i, mut] = rng.integers(0, 5, mut.sum())
    lens = rng.integers(1, m + 1, b).astype(np.int32)
    lens[0] = m
    return read, ref, lens


@pytest.mark.parametrize("b,m,w", [(3, 256, 128), (13, 512, 64),
                                   (5, 256, 256), (9, 300, 32)])
def test_k1_k2_match_plain(dev, b, m, w):
    rng = np.random.default_rng(b * m + w)
    read, ref, lens = (torch.from_numpy(x).to(dev) for x in _reads(rng, b, m, w))
    before = kbuild.launch_counts()
    got = banded.banded_sw(read, ref, lens, match=2, mismatch=-4, go=-6, ge=-1)
    want = banded.banded_sw_plain(read, ref, lens, match=2, mismatch=-4,
                                  go=-6, ge=-1)
    for a, c in zip(got, want):
        assert torch.equal(a, c)
    codes = banded.walk_device(got[0], got[2], got[3])
    assert torch.equal(codes, banded.walk_device_plain(got[0], got[2], got[3]))
    after = kbuild.launch_counts()
    assert after["banded_sw"] == before["banded_sw"] + 1
    assert after["walk"] == before["walk"] + 1


def test_k1_rejects_bad_band(dev):
    read = torch.zeros((2, 64), dtype=torch.uint8, device=dev)
    ref = torch.zeros((2, 64 + 48), dtype=torch.uint8, device=dev)
    lens = torch.full((2,), 64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 32"):
        banded.banded_sw(read, ref, lens)


@pytest.mark.parametrize("c1,c2,lo,hi,dtype", [
    (32, 16, 0, 32, "i16"), (128, 128, 30, 100, "i16"),
    (1024, 1024, 645, 645, "i16"), (64, 32, 0, 32, "f32"),
    (64, 32, 0, 32, "mixed")])
def test_k3_matches_plain(dev, c1, c2, lo, hi, dtype):
    rng = np.random.default_rng(c1 + c2 + lo)
    p = 300
    v1 = (rng.integers(-20, 21, (p, c1)) * 50).astype(np.int16)
    v2 = (rng.integers(-20, 21, (p, c2)) * 50).astype(np.int16)
    n1 = rng.integers(lo, min(hi, c1) + 1, p).astype(np.int32)
    n2 = rng.integers(lo, min(hi, c2) + 1, p).astype(np.int32)
    if dtype != "i16":
        v2 = v2.astype(np.float32) / np.float32(1000)
        if dtype == "f32":
            v1 = v1.astype(np.float32) / np.float32(1000)
    t = [torch.from_numpy(x).to(dev) for x in (v1, n1, v2, n2)]
    milli = dtype == "i16"
    got = kernels.battery_rows(*t, milli=milli)
    assert torch.equal(got, kernels.battery_rows_plain(*t, milli=milli))
    if milli:
        host = battery.host_components(v1, n1, v2, n2)
        comp = battery.milli_components(got.cpu().numpy())
        both = (n1 > 0) & (n2 > 0)
        for key in host:
            np.testing.assert_array_equal(comp[key][both], host[key][both])


def test_run_battery_device_equals_host(dev):
    rng = np.random.default_rng(9)
    p, c = 5000, 64
    v1 = np.round(rng.normal(0, 1, (p, c)), 3).astype(np.float32)
    v2 = np.round(rng.normal(0.2, 1, (p, c)), 3).astype(np.float32)
    n1 = rng.integers(1, c + 1, p).astype(np.int32)
    n2 = rng.integers(1, c + 1, p).astype(np.int32)
    d = battery.run_battery(v1, n1, v2, n2, device=dev, tile_positions=1024,
                            want_mstd=True)
    h = battery.run_battery(v1, n1, v2, n2, backend="host", want_mstd=True)
    for key in ("stu", "pu", "stt", "pt", "stks", "pks", "mstd"):
        np.testing.assert_array_equal(getattr(d, key), getattr(h, key))
