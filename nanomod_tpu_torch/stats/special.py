# Copied from nanomod_tpu/stats/special.py; only the imports differ.
"""Host-side float64 p-value transforms.

The reference runs under scipy 1.2.1 (pinned in env.py27nanomod.yml); several
scipy defaults changed since, so the exact 1.2.1 formulas are written out
here (against scipy's stable distribution primitives, which are unchanged):

  * ks_2samp (1.2.1): asymptotic Kolmogorov-Smirnov with Stephens' small-
    sample correction — p = kstwobign.sf((en + 0.12 + 0.11/en) * D),
    en = sqrt(n1*n2/(n1+n2)).  Modern scipy's 'asymp' mode dropped the
    correction and 'auto' switches to an exact method; we keep 1.2.1.
  * mannwhitneyu (1.2.1 defaults): u = min(u1,u2), z from max(u1,u2) with
    continuity correction, p = norm.sf(|z|)  (legacy half-two-sided p).
  * ttest_ind(equal_var=False): Welch two-sided p via Student t sf.
  * combine_pvalues: Fisher (chi2 sf, 2k df) and weighted Stouffer
    (z = Σ w_i ndtri(1-p_i) / ||w||).

Float clamps mirror m_min_float/m_max_float (ref myDetect.py:317-325).
"""

from __future__ import annotations

import sys

import numpy as np
from scipy.stats import distributions as _dist

FLOAT_MIN = sys.float_info.min
FLOAT_MAX = sys.float_info.max


def clamp_p(p):
    """m_min_float (ref myDetect.py:317-320): lower-clamp p-values to the
    smallest positive normal double (never 0)."""
    return np.where(np.asarray(p, dtype=np.float64) < FLOAT_MIN, FLOAT_MIN, p)


def clamp_stat(s):
    """m_max_float (ref myDetect.py:322-325): upper-clamp statistics."""
    return np.where(np.asarray(s, dtype=np.float64) > FLOAT_MAX, FLOAT_MAX, s)


def ks_pvalue(d, n1, n2):
    """scipy 1.2.1 ks_2samp p-value for D and sample sizes (vectorized)."""
    d = np.asarray(d, dtype=np.float64)
    n1 = np.asarray(n1, dtype=np.float64)
    n2 = np.asarray(n2, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        en = np.sqrt(n1 * n2 / (n1 + n2))
        p = _dist.kstwobign.sf((en + 0.12 + 0.11 / en) * d)
    return np.where(np.isfinite(p), p, 1.0)


def mwu_pvalue(z):
    """scipy 1.2.1 mannwhitneyu(alternative=None): p = norm.sf(|z|).

    NaN z marks a degenerate pool (all 2N pooled values identical; sd = 0)
    where scipy 1.2.1 raised ValueError and the reference crashed
    (myDetect.py:331): map it to p = 1.0 — identical samples carry no
    evidence of modification (documented in DIVERGENCES.md)."""
    z = np.asarray(z, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        p = _dist.norm.sf(np.abs(z))
    return np.where(np.isnan(z), 1.0, p)


def welch_pvalue(t, df):
    """Two-sided Welch p = 2 * t.sf(|t|, df) (scipy ttest_ind)."""
    t = np.asarray(t, dtype=np.float64)
    df = np.asarray(df, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        p = 2.0 * _dist.t.sf(np.abs(t), df)
    return p


def _threaded_elementwise(fn, x, min_n=1_000_000):
    """Apply an elementwise scipy transform in row chunks across threads
    (the special-function ufuncs release the GIL).  Bitwise identical to
    one call — pure per-element math."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < min_n:
        return fn(x)
    import os
    from concurrent.futures import ThreadPoolExecutor
    nthreads = min(8, os.cpu_count() or 1)
    if nthreads <= 1:
        return fn(x)
    out = np.empty(n, np.float64)
    bounds = np.linspace(0, n, nthreads * 2 + 1, dtype=np.int64)

    def run(i):
        out[bounds[i]:bounds[i + 1]] = fn(x[bounds[i]:bounds[i + 1]])
    with ThreadPoolExecutor(nthreads) as ex:
        list(ex.map(run, range(len(bounds) - 1)))
    return out


def norm_isf(p):
    """scipy norm.isf (the Stouffer z transform); threaded at scale."""
    return _threaded_elementwise(_dist.norm.isf, p)


def norm_sf(z):
    return _threaded_elementwise(_dist.norm.sf, z)


def chi2_sf(stat, df):
    return _dist.chi2.sf(np.asarray(stat, dtype=np.float64), df)


def fisher_combine(pvals, axis=-1):
    """scipy combine_pvalues(method='fisher') (ref myDetect.py:392-393).

    Returns (statistic, pvalue): stat = -2 Σ ln p, p = chi2.sf(stat, 2k).
    """
    pvals = np.asarray(pvals, dtype=np.float64)
    k = pvals.shape[axis]
    with np.errstate(divide="ignore"):
        stat = -2.0 * np.sum(np.log(pvals), axis=axis)
    p = _dist.chi2.sf(stat, 2 * k)
    return stat, p


def stouffer_combine(pvals, weights, axis=-1):
    """scipy combine_pvalues(method='stouffer', weights=w)
    (ref myDetect.py:395-401).

    z_i = norm.isf(p_i); stat = Σ w_i z_i / ||w||_2; p = norm.sf(stat).
    A neighbor p of exactly 1.0 gives z = -inf and hence combined p = 1.0 —
    the reference relies on this for missing neighbors (myDetect.py:383-389).
    """
    pvals = np.asarray(pvals, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    z = _dist.norm.isf(pvals)
    with np.errstate(invalid="ignore"):
        stat = np.sum(w * z, axis=axis) / np.linalg.norm(w)
    # (+inf) + (-inf) = nan can only arise from a p=0 neighbor, which
    # clamp_p precludes upstream; keep nan-safe anyway
    stat = np.where(np.isnan(stat), -np.inf, stat)
    p = _dist.norm.sf(stat)
    return stat, p


def stouffer_weights(neighbor_pvalues: int, weights_dif: float):
    """Geometric weight vector centered at 100 (ref myDetect.py:396-400)."""
    mid = 100.0
    w = [mid]
    for _ in range(neighbor_pvalues):
        w.insert(0, w[0] / weights_dif)
        w.append(w[-1] / weights_dif)
    return np.asarray(w, dtype=np.float64)
