# Copied from nanomod_tpu/signal/normalize.py; only the imports differ.
"""Raw-signal normalization.

Replicates the reference's two-stage normalization
(ref bin/scripts/myRefBaseSignalAnnotation.py:66-113 k-mer-model calibration,
:245-259 ``mnormalized`` median/MAD + winsorize):

  1. optional nanopolish-style calibration: weighted least squares of event
     means against 5-mer model levels (2x2 normal equations), then
     raw := (raw - shift) / scale
  2. median/MAD normalization over the event-covered span, then clamp to
     median ± 5*MAD and round to 3 decimals.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def load_kmer_model(path: str) -> Dict[str, Tuple[float, float]]:
    """Parse a nanopolish r9 model file: kmer -> (level_mean, 1/stdv^2)
    (ref get_kmer_corrected_info :66-82)."""
    model = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 3:
                continue
            try:
                mean, stdv = float(parts[1]), float(parts[2])
            except ValueError:
                continue
            model[parts[0]] = (mean, 1.0 / (stdv * stdv))
    return model


def kmer_shift_scale(event_means: np.ndarray, model_states: np.ndarray,
                     kmer_model: Dict[str, Tuple[float, float]]):
    """Weighted 2x2 least-squares shift/scale (ref get_cur_shift_scale
    :86-113): solve [[Σw, Σwm],[Σwm, Σwm²]]·[shift,scale]ᵀ = [Σwe, Σwem]
    with w = 1/stdv², m = model level, e = event mean."""
    levels = np.empty(len(model_states))
    weights = np.empty(len(model_states))
    for i, ms in enumerate(model_states):
        k = ms.decode() if isinstance(ms, bytes) else str(ms)
        levels[i], weights[i] = kmer_model[k]
    wm = weights * levels
    a = np.array([[weights.sum(), wm.sum()],
                  [wm.sum(), (wm * levels).sum()]])
    e = event_means.astype(np.float64) * weights
    b = np.array([e.sum(), (e * levels).sum()])
    shift, scale = np.linalg.solve(a, b)
    return shift, scale


def mad_normalize(raw: np.ndarray, span: Tuple[int, int],
                  shift_scale: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """mnormalized (ref :245-259): statistics over raw[span], transform
    applied to the whole array, winsorized at ±5 MAD, rounded to 3
    decimals."""
    raw = raw.astype(np.float64)
    if shift_scale is not None:
        shift, scale = shift_scale
        raw = np.round(raw / scale - shift / scale, 6)   # ref :111
    lo, hi = span
    seg = raw[lo:hi]
    mshift = np.median(seg)
    mscale = np.median(np.abs(seg - mshift))
    raw = (raw - mshift) / mscale
    seg = raw[lo:hi]
    med = np.median(seg)
    mad = np.median(np.abs(seg - med))
    raw = np.clip(raw, med - 5 * mad, med + 5 * mad)
    return np.round(raw, 3)
