"""The port's battery (plain version of kernel K3, run_battery) against the
JAX package and the native host battery on the same numpy pools.

Integer rows are compared for equality.  The f32 Welch moments of
battery_components_packed are sums taken in another order than XLA's, so
they are held to rtol=1e-6 with an absolute floor of 1e-6 (values of
magnitude <= 1 summed over <= 64 entries: a few f32 ulps of the sum, which
is what cancellation leaves of a mean near zero).
"""

import numpy as np
import pytest
import torch

from nanomod_tpu import config as jcfg
from nanomod_tpu.stats import battery as jbat
from nanomod_tpu.stats import kernels as jk
from nanomod_tpu_torch import config as tcfg
from nanomod_tpu_torch.kernels import build as kbuild
from nanomod_tpu_torch.kernels import hardcases
from nanomod_tpu_torch.stats import battery as tbat
from nanomod_tpu_torch.stats import kernels as tk


def _tile(p, c1, c2, seed, lo=0, hi=None, levels=40):
    """int16 milli tile with heavy ties and non-zero padding; counts in
    [lo, hi], with rows of count 0 and 1 in each group."""
    rng = np.random.default_rng(seed)
    v1 = (rng.integers(-levels, levels + 1, (p, c1)) * 25).astype(np.int16)
    v2 = (rng.integers(-levels, levels + 1, (p, c2)) * 25).astype(np.int16)
    n1 = rng.integers(lo, (hi or c1) + 1, p).astype(np.int32)
    n2 = rng.integers(lo, (hi or c2) + 1, p).astype(np.int32)
    n1[:4] = (0, 1, 0, 1)
    n2[:4] = (0, 0, 1, 1)
    return v1, n1, v2, n2


TILES = {
    "ties_small": dict(p=64, c1=32, c2=16, seed=1),
    "ties_wide": dict(p=40, c1=128, c2=64, seed=2, lo=20, levels=6),
    "deepest_1290": dict(p=8, c1=1024, c2=1024, seed=3, lo=645, hi=645,
                         levels=10),
}


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in a]


@pytest.mark.parametrize("name", sorted(TILES))
def test_milli_rows_match_jax(name):
    v1, n1, v2, n2 = _tile(**TILES[name])
    if name == "deepest_1290":
        n1[:] = 645
        n2[:] = 645
    want = np.asarray(jk.battery_components_packed_milli(v1, n1, v2, n2))
    got = tk.battery_components_packed_milli(*_t(v1, n1, v2, n2)).numpy()
    assert got.shape == want.shape == (9, len(n1))
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("case", hardcases.K3_CASES)
def test_hard_case_rows_match_jax(case):
    """The tiles on which a kernel that sorts could go wrong (NaN inside
    the valid prefix, -0.0 against +0.0, one tie run, one value a group,
    counts 0 and 1, 645 + 645, either side of K3's warp/block switch): the
    plain version's rows equal the JAX package's."""
    v1, n1, v2, n2 = hardcases.k3_tile(case, 6 if case == "deep_645" else 24,
                                       seed=len(case))
    args = _t(v1, n1, v2, n2)
    if case in hardcases.F32_CASES:
        want = np.asarray(jk.battery_components_packed(v1, n1, v2, n2))
        got = tk.battery_components_packed(*args).numpy()
        np.testing.assert_allclose(got[3:], want[3:], rtol=1e-6, atol=1e-6)
        nrows = 3
    else:
        want = np.asarray(jk.battery_components_packed_milli(v1, n1, v2, n2))
        got = tk.battery_components_packed_milli(*args).numpy()
        nrows = 9
    np.testing.assert_array_equal(want[:nrows].view(np.int32),
                                  got[:nrows].view(np.int32))
    assert got.shape[1] == len(n1)
    if nrows == 9:   # and the native host battery, where both groups hold
        comp = tbat.milli_components(got)
        host = tbat.host_components(v1, n1, v2, n2)
        both = (n1 > 0) & (n2 > 0)
        for key in host:
            np.testing.assert_array_equal(comp[key][both], host[key][both],
                                          err_msg=key)


@pytest.mark.parametrize("mixed", [False, True])
def test_f32_rows_match_jax(mixed):
    v1, n1, v2, n2 = _tile(**TILES["ties_small"])
    f1 = v1 if mixed else v1.astype(np.float32) / np.float32(1000)
    f2 = v2.astype(np.float32) / np.float32(1000)
    want = np.asarray(jk.battery_components_packed(f1, n1, f2, n2))
    got = tk.battery_components_packed(*_t(f1, n1, f2, n2)).numpy()
    assert got.shape == want.shape == (7, len(n1))
    np.testing.assert_array_equal(want[:3].view(np.int32),
                                  got[:3].view(np.int32))
    np.testing.assert_allclose(got[3:], want[3:], rtol=1e-6, atol=1e-6)


def test_rows_match_native_host_battery():
    v1, n1, v2, n2 = _tile(p=256, c1=128, c2=128, seed=4, lo=30, hi=100)
    rows = tk.battery_rows(*_t(v1, n1, v2, n2), milli=True).numpy()
    got = tbat.milli_components(rows)
    want = tbat.host_components(v1, n1, v2, n2)
    # rows with an empty group (D undefined) are defined differently by
    # the host battery; run_battery never sends them
    both = (n1 > 0) & (n2 > 0)
    for key in want:
        np.testing.assert_array_equal(got[key][both], want[key][both],
                                      err_msg=key)


def _pools(seed, p=3000, c=48):
    rng = np.random.default_rng(seed)
    v1 = np.round(rng.normal(0, 1, (p, c)), 3).astype(np.float32)
    v2 = np.round(rng.normal(0.1, 1, (p, c)), 3).astype(np.float32)
    v1[:, -3:] = 9.999                        # padding is never read
    n1 = rng.integers(5, c - 3, p).astype(np.int32)
    n2 = rng.integers(1, c - 3, p).astype(np.int32)
    return v1, n1, v2, n2


@pytest.mark.parametrize("jax_backend", ["device", "host"])
def test_run_battery_matches_jax(jax_backend):
    v1, n1, v2, n2 = _pools(5)
    want = jbat.run_battery(v1, n1, v2, n2, tile_positions=1024,
                            want_mstd=True, backend=jax_backend)
    got = tbat.run_battery(v1, n1, v2, n2, tile_positions=1024,
                           want_mstd=True, device="cpu")
    for key in ("stu", "pu", "stt", "pt", "stks", "pks", "mstd"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)


def test_run_battery_host_backend_matches_device():
    v1, n1, v2, n2 = _pools(6, p=500)
    dev = tbat.run_battery(v1, n1, v2, n2, device="cpu", backend="device")
    host = tbat.run_battery(v1, n1, v2, n2, backend="host")
    for key in ("stu", "pu", "stt", "pt", "stks", "pks"):
        np.testing.assert_array_equal(getattr(dev, key), getattr(host, key))


def test_backend_selection(monkeypatch):
    monkeypatch.delenv("NANOMOD_BATTERY_BACKEND", raising=False)
    assert tbat.resolve_backend() == "device"
    monkeypatch.setenv("NANOMOD_BATTERY_BACKEND", "host")
    assert tbat.resolve_backend() == "host"
    monkeypatch.setenv("NANOMOD_BATTERY_BACKEND", "hots")
    with pytest.raises(ValueError, match="hots"):
        tbat.resolve_backend()
    with pytest.raises(ValueError, match="auto"):
        tbat.resolve_backend("auto")


@pytest.mark.parametrize("backend", ["device", "host"])
def test_capped_ks_raises(backend):
    """A cap above 645 (which K6 once refused), with a row of 1,000 above
    it: the port's run_battery equals the JAX package's (the row's pooled
    width, 1,000 + <= 200, stays within the battery's int32 bound)."""
    v1, n1, v2, n2 = _pools(7, p=16)
    v1 = np.pad(v1, ((0, 0), (0, 1000 - v1.shape[1])))
    n1[3] = 1000
    n2[3] = min(n2[3], 200)
    v1[3, 45:] = np.round(np.random.default_rng(70).normal(0, 1, 955), 3)
    kw = dict(coverages=(646, 646), downsampling=4)
    want = jbat.run_battery(v1, n1, v2, n2, cfg=jcfg.StatConfig(**kw),
                            backend=backend)
    got = tbat.run_battery(v1, n1, v2, n2, cfg=tcfg.StatConfig(**kw),
                           backend=backend, device="cpu")
    for key in ("stu", "pu", "stks", "pks"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)


@pytest.mark.parametrize("quantile", [0.25, 1.0])
@pytest.mark.parametrize("backend", ["device", "host"])
def test_capped_ks_matches_jax(backend, quantile):
    """run_battery with a coverage cap against the JAX package's, with a
    row offset and tiles that cut the capped rows; a quantile of 1 takes
    the last repeat, as the reference's index does."""
    v1, n1, v2, n2 = _pools(8, p=300)
    ckw = dict(coverages=(12, 20), downsampling=16,
               downsampling_quantile=quantile)
    for strand in ("+", "-"):
        kw = dict(strand=strand, row_offset=40, want_mstd=True)
        want = jbat.run_battery(v1, n1, v2, n2, backend=backend,
                                cfg=jcfg.StatConfig(**ckw), **kw)
        got = tbat.run_battery(v1, n1, v2, n2, backend=backend, device="cpu",
                               tile_positions=128, cfg=tcfg.StatConfig(**ckw),
                               **kw)
        for key in ("stu", "pu", "stks", "pks", "mstd"):
            np.testing.assert_array_equal(getattr(got, key),
                                          getattr(want, key), err_msg=key)


def test_to_device_tile_cpu_and_no_launch():
    v1, n1, v2, n2 = _tile(**TILES["ties_small"])
    tv, tc = tbat.to_device_tile(v1, n1, "cpu")
    assert tv.dtype == torch.int16 and tc.dtype == torch.int32
    assert tv.device.type == "cpu"
    before = kbuild.launch_counts()
    tk.battery_rows(tv, tc, *tbat.to_device_tile(v2, n2, "cpu"), milli=True)
    assert kbuild.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        tk.battery_rows_cuda(tv, tc, tv, tc, milli=True)
