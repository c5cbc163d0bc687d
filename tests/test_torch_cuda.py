"""Kernels K1, K2, K3 and K6 against their plain PyTorch versions on the
card.

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


def _ties(rng, b, m, w):
    """Tandem-repeat reads on tandem-repeat windows: the best score is
    reached at several cells, across rows and within a row."""
    unit = np.array([0, 1, 0, 1, 2], np.uint8)
    ref = np.resize(unit, (b, m + w)).copy()
    read = np.resize(unit, (b, m)).copy()
    for i in range(b):
        read[i] = np.roll(read[i], i)
        cut = rng.integers(m // 4, m)
        read[i, cut:cut + 3] = 3               # one break in the repeat
    lens = np.full(b, m, np.int32)
    return read, ref, lens


def _mismatch(rng, b, m, w):
    """Every code mismatches (read A, window C): best 0 at (0, 0)."""
    return (np.zeros((b, m), np.uint8), np.ones((b, m + w), np.uint8),
            rng.integers(1, m + 1, b).astype(np.int32))


def _k1_k2_equal(dev, read, ref, lens, **score):
    read, ref, lens = (torch.from_numpy(x).to(dev) for x in (read, ref, lens))
    before = kbuild.launch_counts()
    got = banded.banded_sw(read, ref, lens, **score)
    want = banded.banded_sw_plain(read, ref, lens, **score)
    for a, c in zip(got, want):
        assert torch.equal(a, c)
    packed = banded.walk_packed(got[0], got[2], got[3])
    assert torch.equal(packed,
                       banded.walk_packed_plain(got[0], got[2], got[3]))
    after = kbuild.launch_counts()
    assert after["banded_sw"] == before["banded_sw"] + 1
    assert after["walk"] == before["walk"] + 1
    return got


@pytest.mark.parametrize("b,m,w", [(3, 256, 128), (13, 512, 64),
                                   (5, 256, 256), (9, 300, 32),
                                   (37, 256, 128), (4, 128, 1024),
                                   (6, 160, 96)])
def test_k1_k2_match_plain(dev, b, m, w):
    rng = np.random.default_rng(b * m + w)
    _k1_k2_equal(dev, *_reads(rng, b, m, w), match=2, mismatch=-4, go=-6,
                 ge=-1)


@pytest.mark.parametrize("w", [32, 128])
def test_k1_k2_ties(dev, w):
    rng = np.random.default_rng(w)
    got = _k1_k2_equal(dev, *_ties(rng, 37, 256, w))
    # the best value is held by more than one cell of the matrix
    assert got[1].min() > 0


def test_k1_k2_all_mismatch(dev):
    got = _k1_k2_equal(dev, *_mismatch(np.random.default_rng(1), 11, 128,
                                       128))
    assert float(got[1].abs().max()) == 0.0
    assert int(got[2].abs().max()) == 0 and int(got[3].abs().max()) == 0


def test_k2_start_outside_the_matrix(dev):
    """A start cell that K1 never gives (rows past the end, lanes off the
    band on either side) walks with the reference's clamps."""
    rng = np.random.default_rng(3)
    read, ref, lens = (torch.from_numpy(x).to(dev)
                       for x in _reads(rng, 40, 256, 64))
    tbm = banded.banded_sw(read, ref, lens)[0]
    bi = torch.from_numpy(rng.integers(-2, 256 + 3, 40).astype(np.int32))
    bk = torch.from_numpy(rng.integers(-2, 64 + 3, 40).astype(np.int32))
    bi[:4] = torch.tensor([256, 300, -1, 100], dtype=torch.int32)
    bk[:4] = torch.tensor([-1, 64, 5, 65], dtype=torch.int32)
    bi, bk = bi.to(dev), bk.to(dev)
    assert torch.equal(banded.walk_packed(tbm, bi, bk),
                       banded.walk_packed_plain(tbm, bi, bk))


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


@pytest.mark.parametrize("dtype,cov,reps,q", [
    ("i16", 16, 20, 5), ("f32", 100, 12, 0), ("mixed", 8, 10, 9),
    ("nan", 645, 4, 3)])
def test_k6_matches_plain(dev, dtype, cov, reps, q):
    rng = np.random.default_rng(cov + reps)
    p, c = 200, 1024 if cov == 645 else 128
    v1 = (rng.integers(-20, 21, (p, c)) * 50).astype(np.int16)
    v2 = (rng.integers(-20, 21, (p, c)) * 50).astype(np.int16)
    n1 = rng.integers(0, c + 1, p).astype(np.int32)
    n2 = rng.integers(0, c + 1, p).astype(np.int32)
    n1[:4] = (1, cov, cov + 1, 0)
    n2[:4] = (cov + 1, 1, cov, 0)
    if dtype != "i16":
        v2 = v2.astype(np.float32) / np.float32(1000)
        if dtype != "mixed":
            v1 = v1.astype(np.float32) / np.float32(1000)
        if dtype == "nan":
            for i in range(p):
                v1[i, n1[i]:] = np.nan
                v2[i, n2[i]:] = np.nan
    rows = (np.arange(p) + (1 << 20)).astype(np.int32)
    t = [torch.from_numpy(x).to(dev) for x in (v1, n1, v2, n2, rows)]
    kw = dict(cov=cov, repeats=reps, quantile_idx=q, seed=7)
    before = kbuild.launch_counts()["capped_ks"]
    got = kernels.capped_ks_d(*t, **kw)
    assert kbuild.launch_counts()["capped_ks"] == before + 1
    assert torch.equal(got, kernels.capped_ks_d_plain(*t, **kw))
    for group in (0, 1):
        d = dict(cov=cov, repeats=reps, seed=7, group=group)
        assert torch.equal(kernels.capped_draws_cuda(t[group * 2 + 1], t[4], **d),
                           kernels.capped_draws_plain(t[group * 2 + 1], t[4], **d))


@pytest.mark.parametrize("cov,reps", [(700, 6), (2000, 3)])
def test_k6_above_645_matches_plain(dev, cov, reps):
    """One group of 650-1,000 observations, the other at most 290: at
    cov = 700 the deep rows are subsampled, at 2000 no row is capped."""
    rng = np.random.default_rng(cov)
    p = 64
    v1 = (rng.integers(-40, 41, (p, 1000)) * 25).astype(np.int16)
    v2 = (rng.integers(-35, 46, (p, 290)) * 25).astype(np.int16)
    n1 = rng.integers(650, 1001, p).astype(np.int32)
    n2 = rng.integers(0, 291, p).astype(np.int32)
    rows = (np.arange(p) + 11).astype(np.int32)
    t = [torch.from_numpy(x).to(dev) for x in (v1, n1, v2, n2, rows)]
    kw = dict(cov=cov, repeats=reps, quantile_idx=1, seed=5)
    assert torch.equal(kernels.capped_ks_d(*t, **kw),
                       kernels.capped_ks_d_plain(*t, **kw))


def test_run_battery_capped_device_equals_host(dev):
    from nanomod_tpu_torch.config import StatConfig
    rng = np.random.default_rng(10)
    p, c = 3000, 64
    v1 = np.round(rng.normal(0, 1, (p, c)), 3).astype(np.float32)
    v2 = np.round(rng.normal(0.2, 1, (p, c)), 3).astype(np.float32)
    n1 = rng.integers(1, c + 1, p).astype(np.int32)
    n2 = rng.integers(1, c + 1, p).astype(np.int32)
    cfg = StatConfig(coverages=(20, 20), downsampling=30)
    d = battery.run_battery(v1, n1, v2, n2, cfg=cfg, device=dev,
                            tile_positions=1024, row_offset=5)
    h = battery.run_battery(v1, n1, v2, n2, cfg=cfg, backend="host",
                            device=dev, row_offset=5)
    c = battery.run_battery(v1, n1, v2, n2, cfg=cfg, device="cpu",
                            tile_positions=700, row_offset=5)
    for key in ("stks", "pks"):
        np.testing.assert_array_equal(getattr(d, key), getattr(h, key))
        np.testing.assert_array_equal(getattr(d, key), getattr(c, key))
