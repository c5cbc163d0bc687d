"""The coverage-capped KS: the port's capped_ks_d_plain (kernel K6's plain
version) must be array-equal to the reference's capped_ks_d on the same
numpy inputs, made from a seed: int16 milli and f32 pools, mixed types,
rows below, at and above the cap (counts of 0 and 1 included), non-zero
row indices, the first and the last quantile, NaN padding, pools narrower
than the cap, and caps above 645 (where a group of up to 1,000 is
subsampled, and where no row is capped)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanomod_tpu.stats.kernels import capped_ks_d as jax_capped_ks_d
from nanomod_tpu_torch.kernels import build as kbuild
from nanomod_tpu_torch.kernels import hardcases
from nanomod_tpu_torch.stats import kernels


def _pools(rng, p, c1, c2, cov, kind):
    if kind == "f32" or kind == "nan":
        v1 = np.round(rng.normal(0, 1, (p, c1)), 2).astype(np.float32)
        v2 = np.round(rng.normal(0.3, 1, (p, c2)), 2).astype(np.float32)
    else:   # heavy ties in the milli domain
        v1 = (rng.integers(-12, 13, (p, c1)) * 25).astype(np.int16)
        v2 = (rng.integers(-10, 15, (p, c2)) * 25).astype(np.int16)
    if kind == "mixed":
        v2 = v2.astype(np.float32) / np.float32(7)
    n1 = rng.integers(0, c1 + 1, p).astype(np.int32)
    n2 = rng.integers(0, c2 + 1, p).astype(np.int32)
    edge = [0, 1, cov - 1, cov, cov + 1, min(c1, c2)]
    n1[: len(edge)] = [min(e, c1) for e in edge]
    n2[: len(edge)] = [min(e, c2) for e in edge[::-1]]
    if kind == "nan":
        for i in range(p):
            v1[i, n1[i]:] = np.nan
            v2[i, n2[i]:] = np.nan
    return v1, n1, v2, n2


CASES = {
    # name: (kind, P, C1, C2, cov, repeats, quantile_idx, row offset)
    "i16": ("i16", 40, 48, 40, 16, 20, 5, 0),
    "i16_q0": ("i16", 24, 32, 32, 12, 10, 0, 2 ** 20),
    "i16_qlast": ("i16", 24, 32, 32, 12, 10, 9, 17),
    "f32": ("f32", 32, 40, 48, 16, 12, 3, 2 ** 20),
    "mixed": ("mixed", 24, 32, 24, 10, 8, 2, 5),
    "nan_padding": ("nan", 32, 40, 40, 16, 12, 3, 0),
    "narrow": ("i16", 16, 8, 8, 20, 6, 1, 3),
    "cov1": ("f32", 16, 16, 16, 1, 5, 1, 0),
    "cov646": ("i16", 7, 700, 300, 646, 4, 1, 9),
}


def _run_both(name):
    kind, p, c1, c2, cov, reps, q, off = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    v1, n1, v2, n2 = _pools(rng, p, c1, c2, cov, kind)
    rows = (np.arange(p) + off).astype(np.int32)
    kw = dict(cov=cov, repeats=reps, quantile_idx=q, seed=11)
    want = np.asarray(jax_capped_ks_d(jnp.asarray(v1), jnp.asarray(n1),
                                      jnp.asarray(v2), jnp.asarray(n2),
                                      jnp.asarray(rows), **kw))
    args = [torch.from_numpy(x) for x in (v1, n1, v2, n2, rows)]
    return want, args, kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_jax(name):
    want, args, kw = _run_both(name)
    before = kbuild.launch_counts()
    got = kernels.capped_ks_d(*args, **kw)     # a CPU tensor: the plain one
    assert kbuild.launch_counts() == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        kernels.capped_ks_d_plain(*args, **kw).numpy(), want)
    assert (want > 0).any()


@pytest.mark.parametrize("case", hardcases.K6_CASES)
def test_hard_case_plain_equals_jax(case):
    """The tiles on which a kernel that ranks the row could go wrong (NaN
    inside the valid prefix, -0.0 against +0.0, one tie run, every value
    distinct, counts 0, 1, cov and cov + 1, one group under cov and the
    other over it): the plain version equals the JAX package's."""
    cov = 16
    v1, n1, v2, n2 = hardcases.k6_tile(case, 12, 40, cov, seed=len(case))
    rows = (np.arange(12) + 77).astype(np.int32)
    kw = dict(cov=cov, repeats=8, quantile_idx=2, seed=5)
    want = np.asarray(jax_capped_ks_d(jnp.asarray(v1), jnp.asarray(n1),
                                      jnp.asarray(v2), jnp.asarray(n2),
                                      jnp.asarray(rows), **kw))
    got = kernels.capped_ks_d_plain(
        *[torch.from_numpy(x) for x in (v1, n1, v2, n2, rows)], **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((n1 > cov) | (n2 > cov)).any()


def test_row_index_keys_the_draws_not_the_tile():
    """A slice of the rows with its absolute row index gives the slice of
    the whole result (so tiling does not change the draws); the default
    row index is 0..P-1."""
    want, (v1, n1, v2, n2, rows), kw = _run_both("i16")
    sl = slice(9, 31)
    part = kernels.capped_ks_d(v1[sl], n1[sl], v2[sl], n2[sl], rows[sl], **kw)
    np.testing.assert_array_equal(part.numpy(), want[sl])
    none = kernels.capped_ks_d(v1, n1, v2, n2, None, **kw)
    np.testing.assert_array_equal(none.numpy(), want)   # offset 0


def _deep(rng, p, cov):
    """int16 pools of one group holding 650-1,000 observations and one
    holding at most 290 (the battery's pooled-width bound, 1,290)."""
    v1 = (rng.integers(-40, 41, (p, 1000)) * 25).astype(np.int16)
    v2 = (rng.integers(-35, 46, (p, 290)) * 25).astype(np.int16)
    n1 = rng.integers(650, 1001, p).astype(np.int32)
    n2 = rng.integers(0, 291, p).astype(np.int32)
    n1[:3] = (650, min(cov, 1000), 1000)
    n2[:3] = (290, 1, 0)
    return v1, n1, v2, n2


@pytest.mark.parametrize("cov,repeats,q", [(700, 6, 1), (2000, 3, 2)])
def test_plain_equals_jax_above_645(cov, repeats, q):
    """At cov = 700 the rows above 700 are subsampled; at cov = 2000 no
    row is capped and every repeat is the whole pool."""
    rng = np.random.default_rng(cov)
    v1, n1, v2, n2 = _deep(rng, 5, cov)
    rows = (np.arange(5) + 123).astype(np.int32)
    kw = dict(cov=cov, repeats=repeats, quantile_idx=q, seed=3)
    want = np.asarray(jax_capped_ks_d(jnp.asarray(v1), jnp.asarray(n1),
                                      jnp.asarray(v2), jnp.asarray(n2),
                                      jnp.asarray(rows), **kw))
    got = kernels.capped_ks_d_plain(
        *[torch.from_numpy(x) for x in (v1, n1, v2, n2, rows)], **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (n1 > cov).any() == (cov == 700) and (want > 0).sum() >= 4


@pytest.mark.parametrize("bad", [dict(cov=0), dict(quantile_idx=20),
                                 dict(repeats=0)])
def test_bad_arguments_raise(bad):
    _, args, kw = _run_both("i16")
    with pytest.raises(ValueError):
        kernels.capped_ks_d(*args, **{**kw, **bad})


@pytest.mark.parametrize("widths,cov,warps,want", [
    ((512, 512), 200, 1, 16384 + 12 * 1026 + 400),   # the capped detect's
    ((512, 512), 200, 8, 4 * 8 * 1026 + 12 * 1026 + 400),
    ((100, 40), 200, 8, 4 * 8 * 140 + 12 * 140 + 400),  # never capped
])
def test_k6_shared_memory_layout(widths, cov, warps, want):
    """K6's shared memory as its launch lays it out: a group of width w has
    w sources, w + 1 where it can be capped; the sort buffer (8 bytes a
    source, a power of two) doubles as the histograms (4 bytes a source a
    warp).  Two 8,192-wide pools do not fit the card."""
    assert kernels.capped_ks_smem(*widths, cov, 100, warps) == want
    assert kernels.capped_ks_smem(8192, 8192, 100, 100) > kernels.SMEM_LIMIT


def test_cuda_wrapper_refuses_cpu_tensors():
    _, args, kw = _run_both("cov1")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.capped_ks_d_cuda(*args, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.capped_draws_cuda(args[1], args[4], cov=1, repeats=5,
                                  seed=0, group=0)
