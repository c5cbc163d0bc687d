"""Kernels K1, K2, K3, K6, K7 and K9 against their plain PyTorch versions
on the card, and the sharded battery against the single-device one.

These tests need an NVIDIA card and nvcc; without a card they skip.  Run
them on the card with ``python -m pytest tests/test_torch_cuda.py -q``.
chip_smoke.py checks the same kernels at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from nanomod_tpu_torch.kernels import build as kbuild
from nanomod_tpu_torch.kernels import hardcases
from nanomod_tpu_torch.resquiggle import banded
from nanomod_tpu_torch.resquiggle.banded_kernel import (FULL_BATCH,
                                                        NARROW_MAX_W,
                                                        WIDE_PLANS)
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
    codes = banded.walk_device_plain(got[0], got[2], got[3])
    walks = 1
    if codes.shape[1] % 4 == 0:
        assert torch.equal(banded.walk(got[0], got[2], got[3],
                                       packed=True)[0],
                           banded.pack_codes2(codes))
        walks += 1
    assert torch.equal(banded.walk(got[0], got[2], got[3], packed=False)[0],
                       codes)
    after = kbuild.launch_counts()
    assert after["banded_sw"] == before["banded_sw"] + 1
    assert after["walk"] == before["walk"] + walks
    return got


@pytest.mark.parametrize("b,m,w", [(3, 256, 128), (13, 512, 64),
                                   (5, 256, 256), (9, 300, 32),
                                   (37, 256, 128), (4, 128, 1024),
                                   (6, 160, 96)])
def test_k1_k2_match_plain(dev, b, m, w):
    rng = np.random.default_rng(b * m + w)
    _k1_k2_equal(dev, *_reads(rng, b, m, w), match=2, mismatch=-4, go=-6,
                 ge=-1)


@pytest.mark.parametrize("w", [1, 4, 31, 33, 100, 130, 1000])
@pytest.mark.parametrize("m", [256, 300])
def test_k1_k2_off_grid_widths_match_plain(dev, w, m):
    """Band widths off the grid of 32 (K1's ragged last thread, rows padded
    to a multiple of 32 bytes) and of 4 (the walk's unpacked codes); a
    compact copy of the traceback walks alike (the wrapper pads it)."""
    rng = np.random.default_rng(7 * w + m)
    got = _k1_k2_equal(dev, *_reads(rng, 13, m, w))
    tbm, _, bi, bk = got
    assert torch.equal(banded.walk(tbm.contiguous(), bi, bk, packed=False)[0],
                       banded.walk_device_plain(tbm, bi, bk))


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
    assert torch.equal(banded.walk(tbm, bi, bk, packed=True)[0],
                       banded.walk_packed_plain(tbm, bi, bk))


def _wide_reads(rng, b, m, w):
    """Reads that start anywhere in their band (so that walks cross the
    warps' boundaries), with substitutions, deletions and insertions, some
    shorter than M."""
    ref = rng.integers(0, 4, (b, m + w)).astype(np.uint8)
    read = np.full((b, m), 4, np.uint8)
    lens = np.empty(b, np.int32)
    for i in range(b):
        off = int(rng.integers(0, w))
        s = ref[i, off:off + m + m // 4].copy()
        r = rng.random(len(s))
        s[r < 0.05] = rng.integers(0, 4, int((r < 0.05).sum()))
        rep = np.where(r > 0.97, 0, np.where(r > 0.94, 2, 1))
        seq = np.repeat(s, rep)[:m]
        lens[i] = len(seq) if i % 2 else int(rng.integers(m // 2, m + 1))
        read[i, :lens[i]] = seq[:lens[i]]
    return read, ref, lens


@pytest.mark.parametrize("w", [1025, 1100, 2048, 2050, 4096, 4100, 8192,
                               9000, 16385, 32768])
def test_k1_k2_wide_bands_match_plain(dev, w):
    """Band widths above 1024: K1 with a block of warps a read (ragged last
    warp off the grid of 32 lanes a thread) and K2 walking in windows; a
    compact copy of the traceback walks alike."""
    rng = np.random.default_rng(w)
    m = 96 if w > 8192 else 200
    got = _k1_k2_equal(dev, *_wide_reads(rng, 6, m, w))
    tbm, _, bi, bk = got
    assert torch.equal(banded.walk(tbm.contiguous(), bi, bk, packed=False)[0],
                       banded.walk_device_plain(tbm, bi, bk))


@pytest.mark.parametrize("w", [1056, 2048])
def test_k1_k2_wide_ties_and_mismatch(dev, w):
    rng = np.random.default_rng(w + 1)
    got = _k1_k2_equal(dev, *_ties(rng, 9, 160, w))
    assert got[1].min() > 0
    got = _k1_k2_equal(dev, *_mismatch(rng, 5, 64, w))
    assert float(got[1].abs().max()) == 0.0


def test_k2_wide_start_outside_the_matrix(dev):
    rng = np.random.default_rng(5)
    read, ref, lens = (torch.from_numpy(x).to(dev)
                       for x in _wide_reads(rng, 24, 128, 2048))
    tbm = banded.banded_sw(read, ref, lens)[0]
    bi = torch.from_numpy(rng.integers(-2, 128 + 3, 24).astype(np.int32))
    bk = torch.from_numpy(rng.integers(-2, 2048 + 3, 24).astype(np.int32))
    bi[:4] = torch.tensor([128, 200, -1, 100], dtype=torch.int32)
    bk[:4] = torch.tensor([-1, 2048, 5, 2049], dtype=torch.int32)
    bi, bk = bi.to(dev), bk.to(dev)
    assert torch.equal(banded.walk(tbm, bi, bk, packed=True)[0],
                       banded.walk_packed_plain(tbm, bi, bk))


# the windowed walk's traceback cells: (M, D then D, D, I then I, I) nibbles
# and each mix's shares of them; no stop cell, so each walk runs until it
# leaves the band or passes row 0
WALK_CELLS = (1, 2 | 4, 2, 3 | 8, 3)
WALK_MIXES = {
    "straight": (1.0, 0.0, 0.0, 0.0, 0.0),        # up to row 0
    "mixed": (0.9, 0.01, 0.04, 0.01, 0.04),
    "d_heavy": (0.5, 0.15, 0.15, 0.1, 0.1),       # drifts out on the left
    "i_heavy": (0.5, 0.1, 0.1, 0.15, 0.15),       # drifts out on the right
}


def _walk_tb(dev, b, m, w, pitch, mix, seed):
    """A [B, M, W] view of [B, M, pitch] rows of traceback cells drawn
    with the shares of WALK_MIXES[mix] (the padding drawn alike), made on
    the card a read at a time."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    share = torch.tensor(WALK_MIXES[mix], dtype=torch.float64)
    edges = (share.cumsum(0) * 256).round().to(torch.int64)
    lut = torch.tensor(WALK_CELLS, dtype=torch.uint8)[
        torch.searchsorted(edges, torch.arange(256), right=True).clamp(
            max=len(WALK_CELLS) - 1)].to(dev)
    rows = torch.empty((b, m, pitch), dtype=torch.uint8, device=dev)
    for r in range(b):
        u = torch.randint(0, 256, (m, pitch), generator=g, device=dev,
                          dtype=torch.int32)
        rows[r] = lut[u]
    return rows[..., :w]


def _walk_starts(rng, dev, b, m, w):
    """best_i, best_k: the last row, at k = 0, k = w - 1 and anywhere;
    best scores with x.5 among them (the header's rounding)."""
    bi = np.where(rng.random(b) < 0.75, m - 1, rng.integers(0, m, b))
    bi[0] = m - 1
    bk = rng.integers(0, w, b)
    bk[0::3] = 0
    bk[1::3] = w - 1
    best = rng.integers(-50, 5000, b) + rng.choice([0.0, 0.5, -0.5, 0.25], b)
    return (torch.from_numpy(bi.astype(np.int32)).to(dev),
            torch.from_numpy(bk.astype(np.int32)).to(dev),
            torch.from_numpy(best.astype(np.float32)).to(dev))


def _walk_modes_equal(tbv, bi, bk, best):
    """K2 in every mode against the plain walk: codes one a byte, four a
    byte (where 2M+W is a multiple of 4), and the rows with the DP header
    in the walk's own mode; one launch each."""
    codes = banded.walk_device_plain(tbv, bi, bk)
    before = kbuild.launch_counts()["walk"]
    assert torch.equal(banded.walk(tbv, bi, bk, packed=False)[0], codes)
    launches = 1
    if codes.shape[1] % 4 == 0:
        assert torch.equal(banded.walk(tbv, bi, bk, packed=True)[0],
                           banded.pack_codes2(codes))
        launches += 1
    rows, packed = banded.walk_outputs(tbv, best, bi, bk)
    want = banded.pack_codes2(codes) if packed else codes
    assert torch.equal(rows, banded.pack_outputs(want, best, bi, bk))
    assert kbuild.launch_counts()["walk"] == before + launches + 1
    return codes


@pytest.mark.parametrize("mix", list(WALK_MIXES))
@pytest.mark.parametrize("w", [1025, 2048, 4096, 32768])
def test_k2_windowed_walk_matches_plain(dev, w, mix):
    """The windowed walk (pitch above 1024) on walks that run straight up
    to row 0, drift across a window's side (D- and I-heavy), start at
    k = 0, k = w - 1 and anywhere; byte-equal to the plain walk in every
    mode."""
    rng = np.random.default_rng(w + len(mix))
    b, m = (4, 256) if w > 4096 else (8, 1024)
    tbv = _walk_tb(dev, b, m, w, -(-w // 32) * 32, mix, w)
    codes = _walk_modes_equal(tbv, *_walk_starts(rng, dev, b, m, w))
    if mix == "straight":      # every walk from the last row reaches row 0
        assert int((codes != 0).sum(1).max()) == m


@pytest.mark.parametrize("w,pitch", [(1025, 2048), (2048, 4096),
                                     (1100, 32768)])
def test_k2_windowed_walk_pitch_above_w(dev, w, pitch):
    """Rows whose pitch is larger than W (the window may reach the
    padding): read at the given pitch, not copied."""
    rng = np.random.default_rng(pitch + w)
    tbv = _walk_tb(dev, 6, 512, w, pitch, "mixed", pitch)
    assert banded._pitched(tbv)[1] == pitch
    _walk_modes_equal(tbv, *_walk_starts(rng, dev, 6, 512, w))


@pytest.mark.parametrize("w", [2048, 4096])
def test_k2_windowed_walk_long_reads(dev, w):
    """B 64, M 4096 (tools/bench_dp_buckets.py's bucket): K1's traceback
    and a drifting synthetic one, each byte-equal to the plain walk."""
    rng = np.random.default_rng(w)
    read, ref, lens = (torch.from_numpy(x).to(dev)
                       for x in _wide_reads(rng, 64, 4096, w))
    tbm, best, bi, bk = banded.banded_sw(read, ref, lens)
    _walk_modes_equal(tbm, bi, bk, best)
    tbv = _walk_tb(dev, 64, 4096, w, w, "d_heavy", w + 1)
    _walk_modes_equal(tbv, *_walk_starts(rng, dev, 64, 4096, w))


WIDE_WIDTHS = [1025, 1056, 1536, 2047, 2048, 2049, 3000, 4096, 4097, 8192,
               16384, 32768]


@pytest.mark.parametrize("b", [1, 37, 64])
@pytest.mark.parametrize("w", WIDE_WIDTHS)
def test_k1_wide_plans_match_plain(dev, w, b):
    """K1's wide kernel under each launch plan (lanes a thread by W), on and
    off the grid of lanes and of warps, at one read, a ragged batch and a
    batch under the card's SM count: array-equal to the plain version."""
    rng = np.random.default_rng(w * 100 + b)
    m = 48 if w > 8192 else 96
    read, ref, lens = (torch.from_numpy(x).to(dev)
                       for x in _wide_reads(rng, b, m, w))
    got = banded.banded_sw(read, ref, lens)
    want = banded.banded_sw_plain(read, ref, lens)
    for name, a, c in zip(("tb", "best", "best_i", "best_k"), got, want):
        assert torch.equal(a, c), name


@pytest.mark.parametrize("w", WIDE_WIDTHS)
def test_k1_wide_plans_ties_and_mismatch(dev, w):
    """Ties across rows and lanes (tandem repeats) and no positive cell at
    all (best 0 at (0, 0)) under each plan."""
    rng = np.random.default_rng(w + 7)
    m = 40 if w > 8192 else 80
    for make in (_ties, _mismatch):
        read, ref, lens = (torch.from_numpy(x).to(dev)
                           for x in make(rng, 37, m, w))
        got = banded.banded_sw(read, ref, lens)
        want = banded.banded_sw_plain(read, ref, lens)
        for a, c in zip(got, want):
            assert torch.equal(a, c)
        if make is _mismatch:
            assert not got[1].any() and not got[2].any() and \
                not got[3].any()


# the narrow/wide edge: the narrow kernel's widest band (NARROW_MAX_W), the
# wide kernel's narrowest and the next; each wide plan's last band and the
# next plan's first up to 1024 / 1025
EDGE_WIDTHS = sorted({NARROW_MAX_W, NARROW_MAX_W + 1, NARROW_MAX_W + 2}
                     | {w + i for w, *_ in WIDE_PLANS if w <= 1024
                        for i in (0, 1)})


@pytest.mark.parametrize("b", [1, 37, 64])
@pytest.mark.parametrize("w", EDGE_WIDTHS)
def test_k1_narrow_wide_edge_matches_plain(dev, w, b):
    """K1 either side of its narrow/wide edge (the narrow kernel's widest
    instantiation, the wide kernel's narrowest plan) and of each wide
    plan's range up to 1025: array-equal to the plain version, and K2's
    walks with it."""
    rng = np.random.default_rng(w * 10 + b)
    read, ref, lens = _wide_reads(rng, b, 96, w)
    _k1_k2_equal(dev, read, ref, lens)


@pytest.mark.parametrize("w", EDGE_WIDTHS)
def test_k1_narrow_wide_edge_ties_and_mismatch(dev, w):
    rng = np.random.default_rng(w + 3)
    for make in (_ties, _mismatch):
        read, ref, lens = (torch.from_numpy(x).to(dev)
                           for x in make(rng, 37, 80, w))
        got = banded.banded_sw(read, ref, lens)
        want = banded.banded_sw_plain(read, ref, lens)
        for a, c in zip(got, want):
            assert torch.equal(a, c)
        if make is _ties:
            assert got[1].min() > 0
        else:
            assert not got[1].any() and not got[2].any() and \
                not got[3].any()


# K1's rows whose plan changes with the batch: each such row's first and
# widest band at B 1, 8, either side of FULL_BATCH and 256
BATCH_EDGES = [(w, b) for w in sorted({
    w for lo, (max_w, part, full) in zip(
        [NARROW_MAX_W] + [p[0] for p in WIDE_PLANS], WIDE_PLANS)
    if part != full for w in (lo + 1, max_w)})
    for b in (1, 8, FULL_BATCH - 1, FULL_BATCH, FULL_BATCH + 1, 256)]


@pytest.mark.parametrize("w,b", BATCH_EDGES)
def test_k1_batch_plans_match_plain(dev, w, b):
    """K1 either side of its batch threshold (the plan of a batch that
    fills the card against the one of a batch that does not), at one read
    and at 256: array-equal to the plain version."""
    rng = np.random.default_rng(w * 1000 + b)
    m = 48 if w > 8192 else 96
    read, ref, lens = (torch.from_numpy(x).to(dev)
                       for x in _wide_reads(rng, b, m, w))
    got = banded.banded_sw(read, ref, lens)
    want = banded.banded_sw_plain(read, ref, lens)
    for name, a, c in zip(("tb", "best", "best_i", "best_k"), got, want):
        assert torch.equal(a, c), name


@pytest.mark.parametrize("m,w,packed", [(256, 128, True), (256, 130, False),
                                        (128, 2048, True),
                                        (128, 2050, False), (96, 1025, False)])
def test_k2_writes_the_dp_header(dev, m, w, packed, monkeypatch):
    """K2 with the DP's best scores writes each row's 12-byte header and
    then its codes: byte-equal to pack_outputs of the walk, with bests at
    x.5 (round half to even), in the packed, unpacked and windowed (pitch
    above 1024) walks; the card's walk_outputs runs no pack_outputs."""
    rng = np.random.default_rng(m + w)
    read, ref, lens = (torch.from_numpy(x).to(dev)
                       for x in _wide_reads(rng, 37, m, w))
    tbm, best, bi, bk = banded.banded_sw(read, ref, lens)
    half = rng.choice([0.5, -0.5, 1.5, 2.5, 0.0, -1.5], 37)
    best = best + torch.from_numpy(half.astype(np.float32)).to(dev)
    codes, _ = banded.walk(tbm, bi, bk, packed=packed)
    want = banded.pack_outputs(codes, best, bi, bk)
    before = kbuild.launch_counts()["walk"]

    def refuse(*a, **kw):
        raise AssertionError("pack_outputs ran on the card")
    monkeypatch.setattr(banded, "pack_outputs", refuse)
    rows, mode = banded.walk_outputs(tbm, best, bi, bk, packed=packed)
    assert mode is packed
    assert kbuild.launch_counts()["walk"] == before + 1
    assert rows.shape == (37, 12 + codes.shape[1])
    assert torch.equal(rows, want)
    head = rows[:, :4].cpu().contiguous().numpy().view(np.int32)[:, 0]
    np.testing.assert_array_equal(
        head, np.round(best.cpu().numpy()).astype(np.int32))


def test_k1_rejects_bad_band(dev):
    """Above 32,768 band lanes (32 warps of 32 a thread) K1 raises; the
    walk too."""
    read = torch.zeros((2, 64), dtype=torch.uint8, device=dev)
    ref = torch.zeros((2, 64 + 32769), dtype=torch.uint8, device=dev)
    lens = torch.full((2,), 64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=r"in \[1, 32768\]"):
        banded.banded_sw(read, ref, lens)
    z = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=r"in \[1, 32768\]"):
        banded.walk(torch.zeros((2, 64, 32769), dtype=torch.uint8,
                                device=dev), z, z)


@pytest.mark.parametrize("c1,c2,lo,hi,dtype", [
    (32, 16, 0, 32, "i16"), (128, 128, 30, 100, "i16"),
    (1024, 1024, 645, 645, "i16"), (64, 32, 0, 32, "f32"),
    (64, 32, 0, 32, "mixed"), (16, 8, 0, 16, "i16"),
    (128, 128, 0, 128, "f32"), (512, 300, 0, 300, "f32")])
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


@pytest.mark.parametrize("case", hardcases.K3_CASES)
def test_k3_hard_cases_match_plain(dev, case):
    """NaN inside the valid prefix, -0.0 against +0.0, one tie run, one
    value a group, counts 0 and 1, 645 + 645, and full rows either side of
    the warp/block switch: K3 array-equal to its plain version (and to the
    host battery on int16 rows with both groups non-empty)."""
    v1, n1, v2, n2 = hardcases.k3_tile(case, 64 if case == "deep_645"
                                       else 300, seed=len(case))
    t = [torch.from_numpy(x).to(dev) for x in (v1, n1, v2, n2)]
    milli = case not in hardcases.F32_CASES
    before = kbuild.launch_counts()["battery"]
    got = kernels.battery_rows(*t, milli=milli)
    assert kbuild.launch_counts()["battery"] == before + 1
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


@pytest.mark.parametrize("case", hardcases.K6_CASES)
def test_k6_hard_cases_match_plain(dev, case):
    """NaN inside the valid prefix, -0.0 against +0.0, one tie run, every
    value distinct, counts 0, 1, cov and cov + 1, one group under cov and
    the other over: K6 array-equal to its plain version."""
    cov = 40
    v1, n1, v2, n2 = hardcases.k6_tile(case, 200, 128, cov, seed=len(case))
    rows = (np.arange(200) + 31).astype(np.int32)
    t = [torch.from_numpy(x).to(dev) for x in (v1, n1, v2, n2, rows)]
    kw = dict(cov=cov, repeats=12, quantile_idx=3, seed=2)
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


def _stencil_shards(rng, dev, nsh, length, cov):
    """Shards of (num, cap, n1c, n2c, pos, valid) on ``dev``: two joins
    (positions start again inside a shard), capped and uncapped rows,
    padding at the end."""
    p = nsh * length
    hi = 2 * cov if cov else 60
    cols = [rng.integers(0, 5000, p), rng.integers(0, 5000, p),
            rng.integers(1, hi + 1, p), rng.integers(1, hi + 1, p)]
    n_valid = p - 13
    cut = p // 3
    pos = np.full(p, -(2 ** 30), np.int64)
    pos[:cut] = np.cumsum(rng.integers(1, 3, cut))
    pos[cut:n_valid] = 5 + np.cumsum(rng.integers(1, 3, n_valid - cut))
    valid = np.arange(p) < n_valid
    arrays = [c.astype(np.int32) for c in cols + [pos]] + [valid]
    tensors = [torch.from_numpy(a).to(dev) for a in arrays]
    return [tuple(t[s * length:(s + 1) * length] for t in tensors)
            for s in range(nsh)]


@pytest.mark.parametrize("k,cov", [(0, 0), (2, 0), (2, 200), (5, 30)])
def test_k7_matches_plain(dev, k, cov):
    from nanomod_tpu_torch.parallel import sharded
    rng = np.random.default_rng(k * 100 + cov)
    shards = _stencil_shards(rng, dev, 4, 300, cov)
    before = kbuild.launch_counts()["stencil"]
    got = sharded.sharded_stencil(shards, k, cov)
    # the whole step, four shards of one card, is one launch
    assert kbuild.launch_counts()["stencil"] == before + 1
    cpu = [tuple(t.cpu() for t in sh) for sh in shards]
    want = sharded.sharded_stencil(cpu, k, cov)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("length,k", [(4, 2), (4, 4), (5, 3)])
def test_k7_short_shards_match_plain(dev, length, k):
    """k >= L / 2 (k = L: a column's window reaches across the whole
    neighbour shard), five shards."""
    from nanomod_tpu_torch.parallel import sharded
    rng = np.random.default_rng(700 + 10 * length + k)
    shards = _stencil_shards(rng, dev, 5, length, 30)
    got = sharded.sharded_stencil(shards, k, 30)
    want = sharded.sharded_stencil_plain(
        [tuple(t.cpu() for t in sh) for sh in shards], k, 30)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("length,k,cov", [(300, 0, 0), (300, 2, 0),
                                          (300, 2, 200), (300, 5, 30),
                                          (4, 4, 30), (5, 3, 30)])
def test_k7_staged_route_matches_in_place_and_plain(dev, length, k, cov):
    """The route for cards without peer access on one card: each
    neighbour's k edge columns copied first and read at their own offset;
    array-equal to the in-place route and to the plain step, one launch
    each (five shards: k up to L)."""
    from nanomod_tpu_torch.parallel import sharded
    rng = np.random.default_rng(900 + length + 10 * k + cov)
    shards = _stencil_shards(rng, dev, 5, length, cov)
    before = kbuild.launch_counts()["stencil"]
    in_place = sharded._stencil_step_cuda(shards, k, cov)
    staged = sharded._stencil_step_cuda(shards, k, cov, {(dev.index,
                                                          dev.index)})
    assert kbuild.launch_counts()["stencil"] == before + 2
    want = sharded.sharded_stencil_plain(
        [tuple(t.cpu() for t in sh) for sh in shards], k, cov)
    for s, i, w in zip(staged, in_place, want):
        for a, b, c in zip(s, i, w):
            assert torch.equal(a, b)
            assert torch.equal(a.cpu(), c)


def test_k7_step_is_one_kernel_and_nothing_else(dev):
    """The profiler sees one device operation a sharded stencil step of
    four shards: K7's launch (no halo op, copy or fill).  The card idles
    50 ms on either side: the tracer misses the start of its window."""
    import time

    from torch.profiler import ProfilerActivity, profile
    from nanomod_tpu_torch.parallel import sharded
    shards = _stencil_shards(np.random.default_rng(71), dev, 4, 4096, 200)
    sharded.sharded_stencil(shards, 2, 200)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(5):
            sharded.sharded_stencil(shards, 2, 200)
        torch.cuda.synchronize()
        time.sleep(0.05)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 5, names
    assert all("stencil_step_kernel" in name for name in names), names


def _k9_bound_check(got, pos, val, keep, g):
    """Sums (cnt, s1, s2) held to a float64 sum of the same kept events, at
    each position p with n_p of them: s1 within (n_p - 1) 2^-24 sum |x|
    and s2 within n_p 2^-24 sum x^2, the error bound of recursive f32
    summation in any order (one rounding an addition, each at most 2^-24
    of a partial sum's magnitude; the squares add one rounding each)."""
    p = pos[keep]
    x = val[keep].astype(np.float64)
    n = np.bincount(p, minlength=g)
    s64 = np.bincount(p, weights=x, minlength=g)
    q64 = np.bincount(p, weights=x * x, minlength=g)
    abs64 = np.bincount(p, weights=np.abs(x), minlength=g)
    eps = 2.0 ** -24
    s1 = got[1].numpy().astype(np.float64)
    s2 = got[2].numpy().astype(np.float64)
    over1 = np.abs(s1 - s64) > np.maximum(n - 1, 0) * eps * abs64
    over2 = np.abs(s2 - q64) > n * eps * q64
    assert not over1.any(), np.flatnonzero(over1)[:10]
    assert not over2.any(), np.flatnonzero(over2)[:10]


def _k9_equal(dev, pos, val, ok, g):
    """K9 on the card against the plain version and index_add_: counts
    equal; the sums of both K9 and the plain version within the bound of
    f32 summation of a float64 sum of the same events
    (``_k9_bound_check``)."""
    from nanomod_tpu_torch.parallel import mesh
    t = [torch.from_numpy(x).to(dev) for x in (pos, val, ok)]
    before = kbuild.launch_counts()["accumulate"]
    got = [x.cpu() for x in mesh.accumulate(*t, g)]
    assert kbuild.launch_counts()["accumulate"] == before + 1
    assert all(x.shape == (g,) for x in got)
    want = mesh.accumulate_plain(*(x.cpu() for x in t), g)
    p = torch.from_numpy(pos.reshape(-1).astype(np.int64))
    p = torch.where(p < 0, p + g + 1, p)
    keep = torch.from_numpy(ok.reshape(-1)) & (p >= 0) & (p < g)
    lib = torch.zeros(g).index_add_(0, p[keep], torch.ones(int(keep.sum())))
    assert torch.equal(got[0], want[0]) and torch.equal(got[0], lib)
    for sums in (got, want):
        _k9_bound_check(sums, p.numpy(), val.reshape(-1), keep.numpy(), g)


def test_k9_matches_plain(dev):
    rng = np.random.default_rng(9)
    g = 5000
    pos = rng.integers(-5, g + 5, 200_000).astype(np.int32)
    val = rng.normal(0, 1, 200_000).astype(np.float32)
    ok = rng.random(200_000) < 0.9
    _k9_equal(dev, pos, val, ok, g)


@pytest.mark.parametrize("g", [5000, 4_641_652])
def test_k9_read_major_matches_plain(dev, g):
    """distributed_detect_step's shape: [R, L] reads of consecutive
    positions (one or two events a base) starting anywhere in [-L, G)."""
    rng = np.random.default_rng(90)
    r, length = 512, 1024
    start = rng.integers(-length, g, (r, 1))
    pos = (start + np.cumsum(rng.integers(0, 2, (r, length)), axis=1)
           ).astype(np.int32)
    val = rng.normal(0, 1, (r, length)).astype(np.float32)
    ok = rng.random((r, length)) < 0.9
    _k9_equal(dev, pos, val, ok, g)


@pytest.mark.parametrize("case", ["wrap", "one_position", "empty",
                                  "none_ok", "large_genome"])
def test_k9_edge_cases_match_plain(dev, case):
    """Negative positions wrap to p + G + 1 (-1 dropped, -2 the last
    position, below -(G + 1) dropped); every event on one position; no
    events; none ok; a genome of 40 M positions."""
    rng = np.random.default_rng(91)
    g, n = 5000, 100_000
    if case == "wrap":
        pos = np.array([-1, -2, -3, -g - 1, -g - 2, -3 * g, g, g + 1, 0,
                        g - 1] * 1000, np.int32)
    elif case == "one_position":
        pos = np.full(2000, 4097, np.int32)
    elif case == "empty":
        pos = np.zeros(0, np.int32)
    elif case == "large_genome":
        g = 40_000_000
        pos = rng.integers(-3, g + 3, n).astype(np.int32)
    else:
        pos = rng.integers(0, g, n).astype(np.int32)
    val = rng.normal(0, 1, pos.size).astype(np.float32)
    ok = (np.zeros(pos.size, bool) if case == "none_ok"
          else rng.random(pos.size) < 0.9)
    _k9_equal(dev, pos, val, ok, g)


def _pooled_equal(dev, arrays):
    """K3's pooled entry (one launch) against the plain version on the
    card: d bit-equal (NaN equal to NaN), the rank and tie sums
    array-equal."""
    t = [torch.from_numpy(x).to(dev) for x in arrays]
    before = kbuild.launch_counts()
    got = kernels.pooled_rank_components(*t)
    after = kbuild.launch_counts()
    launched = 1 if arrays[0].shape[0] else 0
    assert after["battery_pooled"] == before["battery_pooled"] + launched
    assert after["battery"] == before["battery"]
    want = kernels.pooled_rank_components_plain(*t)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    return got


def test_pooled_rank_components_on_k3_match_plain(dev):
    rng = np.random.default_rng(4)
    p, n = 3000, 64
    z = np.where(rng.random((p, n)) < 0.8,
                 np.round(rng.normal(0, 1, (p, n)), 2), np.inf)
    z = np.sort(z, axis=1).astype(np.float32)
    lab = (rng.random((p, n)) < 0.5).astype(np.float32)
    lab[:, :2] = (1.0, 0.0)                     # both groups non-empty
    lab[~np.isfinite(z)] = 0.0
    fin = np.isfinite(z)
    n1 = (lab * fin).sum(1).astype(np.float32)
    n2 = ((1 - lab) * fin).sum(1).astype(np.float32)
    _pooled_equal(dev, (z, lab, n1, n2))


@pytest.mark.parametrize("case", hardcases.POOLED_CASES)
def test_pooled_cases_match_plain(dev, case):
    """The pooled hard cases (the CPU tests hold the plain version to JAX
    on the same tiles): an empty group 1 with n1 = 1 gives d = 1.0."""
    arrays = hardcases.pooled_tile(case, seed=11)
    got = _pooled_equal(dev, arrays)
    if case == "empty_group1":
        z, lab, _, n2 = arrays
        empty = ((z < np.inf) & (lab > 0.5)).sum(1) == 0
        assert (got[0].cpu().numpy()[empty & (n2 > 0)] == 1.0).all()


@pytest.mark.parametrize("n", [33, 100, 1000, 4096, 8192])
def test_pooled_widths_match_plain(dev, n):
    """Every variant of the pooled entry (one warp a row to N 256, E 2, 4,
    8; one block a row above, to the 8,192 stage) on rows with ties."""
    rng = np.random.default_rng(n)
    p = 40 if n > 1000 else 300
    z = np.where(rng.random((p, n)) < 0.9,
                 rng.integers(-30, 30, (p, n)) * 0.25, np.inf
                 ).astype(np.float32)
    lab = (rng.random((p, n)) < 0.4).astype(np.float32)
    valid = z < np.inf
    n1 = (valid & (lab > 0.5)).sum(1).astype(np.float32)
    n2 = (valid & (lab <= 0.5)).sum(1).astype(np.float32)
    _pooled_equal(dev, (z, lab, n1, n2))


def test_pooled_width_above_the_stage_raises(dev):
    z = torch.zeros((2, kernels.POOLED_MAX_WIDTH + 1), device=dev)
    n = torch.ones(2, device=dev)
    with pytest.raises(ValueError, match="pooled width 8193"):
        kernels.pooled_rank_components(z, z, n, n)


def test_pooled_rank_components_is_one_kernel_and_nothing_else(dev):
    """The profiler sees one device operation a pooled_rank_components
    call: the pooled kernel (no argsort, gather, sum or divide).  The card
    idles 50 ms on either side: the tracer misses the start of its
    window."""
    import time

    from torch.profiler import ProfilerActivity, profile
    arrays = hardcases.pooled_tile("random", seed=5)
    t = [torch.from_numpy(x).to(dev) for x in arrays]
    kernels.pooled_rank_components(*t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(5):
            kernels.pooled_rank_components(*t)
        torch.cuda.synchronize()
        time.sleep(0.05)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 5, names
    assert all("pooled_warp" in name for name in names), names


def test_battery_on_card_matches_independent_ground_truth(dev):
    """K3's milli path on the eleven cases of tests/golden/
    scipy121_cases.json (exact rationals and 60-digit p-values), with the
    bounds of tests/test_torch_scipy121.py."""
    from test_torch_scipy121 import (CASES, as_pools,
                                     check_against_ground_truth)
    before = kbuild.launch_counts()["battery"]
    for case in CASES:
        res = battery.run_battery(*as_pools(case), backend="device",
                                  device=dev)
        check_against_ground_truth(res, case)
    assert kbuild.launch_counts()["battery"] >= before + len(CASES)


@pytest.mark.parametrize("method,cov", [("stouffer", 0), ("fisher", 40),
                                        ("stouffer", 40)])
def test_sharded_join_battery_on_card_equals_single_device(dev, method, cov):
    """Four shards on one card (K3, K6 a shard, one K7 launch for the
    four): every float64 column bit-equal to run_battery on the card plus the host combination."""
    from nanomod_tpu_torch.config import StatConfig
    from nanomod_tpu_torch.parallel import mesh, sharded
    from nanomod_tpu_torch.stats.combine import combine_neighbor_pvalues
    rng = np.random.default_rng(cov + len(method))
    p, c = 6000, 64
    v1 = np.round(rng.normal(0, 1, (p, c)), 3).astype(np.float32)
    v2 = np.round(rng.normal(0.2, 1, (p, c)), 3).astype(np.float32)
    n1 = rng.integers(1, c + 1, p).astype(np.int32)
    n2 = rng.integers(1, c + 1, p).astype(np.int32)
    pos = np.cumsum(rng.integers(1, 3, p)).astype(np.int64)
    cfg = StatConfig(test_method=method, coverages=(cov, cov),
                     downsampling=20)
    before = kbuild.launch_counts()
    got = sharded.sharded_join_battery(
        mesh.make_mesh(4, devices=[dev] * 4), v1, n1, v2, n2, pos, cfg=cfg,
        want_mstd=True)
    after = kbuild.launch_counts()
    assert after["battery"] == before["battery"] + 4
    assert after["stencil"] == before["stencil"] + 1
    assert after["capped_ks"] == before["capped_ks"] + (4 if cov else 0)
    want = battery.run_battery(v1, n1, v2, n2, cfg=cfg, device=dev,
                               want_mstd=True)
    want.stcomb, want.pcomb = combine_neighbor_pvalues(
        np.zeros(p, np.int64), pos, want.pks, cfg)
    for key in ("stu", "pu", "stt", "pt", "stks", "pks", "stcomb", "pcomb",
                "mstd"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)
