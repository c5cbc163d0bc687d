"""The port's threefry replica (nanomod_tpu_torch/stats/threefry.py) against
``jax.random``: PRNGKey, fold_in, split and randint, bit for bit, over the
grid of seeds, rows, subsample sizes, repeats and ranges that capped_ks_d
uses (randint with a per-row maxval under vmap included)."""

import jax
import numpy as np
import pytest
import torch

from nanomod_tpu_torch.stats import kernels, threefry

SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 40 + 7]
ROWS = [0, 5, 2 ** 20 + 3]
COVS = [1, 8, 100, 645]
REPEATS = [1, 20, 100]
MAXVALS = [1, 2, 7, 645]


def _words(key):
    return tuple(int(w) for w in np.asarray(key))


def _t(key):
    return tuple(int(w) for w in key)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_split(seed):
    base = jax.random.PRNGKey(seed)
    assert threefry.prng_key(seed) == _words(base)
    for row in ROWS:
        folded = jax.random.fold_in(base, row)
        got = threefry.fold_in(threefry.prng_key(seed), torch.tensor(row))
        assert _t(got) == _words(folded)
        want = np.asarray(jax.random.split(folded))
        a, b = threefry.split(got)
        assert (_t(a), _t(b)) == (tuple(want[0]), tuple(want[1]))


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_grid(seed, row):
    """randint(k, (R, cov), 0, maxval) of both of a row's keys."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), row))
    ours = threefry.row_keys(seed, torch.tensor([row]))
    for g in range(2):
        assert _t(w[0] for w in ours[g]) == _words(keys[g])
    for cov in COVS:
        for reps in REPEATS:
            counters = torch.arange(reps * cov, dtype=torch.int64)[None, :]
            for maxval in MAXVALS:
                for g in range(2):
                    want = np.asarray(jax.random.randint(
                        keys[g], (reps, cov), 0, maxval))
                    got = threefry.randint(
                        ours[g], counters,
                        torch.tensor([[maxval]], dtype=torch.int64))
                    np.testing.assert_array_equal(
                        got.reshape(reps, cov).numpy(), want,
                        err_msg=f"cov={cov} R={reps} maxval={maxval} g={g}")


@pytest.mark.parametrize("group", [0, 1])
def test_capped_draws_match_vmapped_jax(group):
    """capped_draws_plain: per-row maxval max(count, 1) under vmap, as in
    the reference's capped_ks_d.row_draws."""
    seed, cov, reps = 3, 8, 20
    rows = np.array([0, 1, 7, 2 ** 20, 2 ** 20 + 9], np.int32)
    counts = np.array([0, 1, 9, 645, 30], np.int32)
    base = jax.random.PRNGKey(seed)

    def row_draws(idx, cnt):
        k = jax.random.split(jax.random.fold_in(base, idx))[group]
        return jax.random.randint(k, (reps, cov), 0, jax.numpy.maximum(cnt, 1))

    want = np.asarray(jax.vmap(row_draws)(rows, counts))
    got = kernels.capped_draws_plain(
        torch.from_numpy(counts), torch.from_numpy(rows), cov=cov,
        repeats=reps, seed=seed, group=group)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
