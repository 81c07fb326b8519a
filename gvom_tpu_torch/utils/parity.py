"""Parity-comparison utilities shared by the test suite and the CLI parity
report: engine and oracle (f32 engine vs f64 NumPy) can only be compared cell-wise
where the math is well-conditioned."""

from __future__ import annotations

import numpy as np

__all__ = ["singular_fit_mask"]


def singular_fit_mask(hm: np.ndarray, res: float) -> np.ndarray:
    """Cells whose 3x3 plane fit (gvom.py:663-734 semantics) is
    (near-)singular — det == 0 mathematically (e.g. exactly 3 collinear known
    cells). Any implementation's det != 0 guard then keys off rounding noise,
    flipping slope/roughness/positive-obstacle outputs arbitrarily; such cells
    are excluded from parity comparisons."""
    hm = np.asarray(hm, np.float64)
    X = hm.shape[0]
    known = hm > -1000
    cnt = np.zeros_like(hm); sx = np.zeros_like(hm); sy = np.zeros_like(hm)
    sxx = np.zeros_like(hm); sxy = np.zeros_like(hm); syy = np.zeros_like(hm)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            s0 = slice(max(0, -di), min(X, X - di)); s1 = slice(max(0, -dj), min(X, X - dj))
            t0 = slice(max(0, di), min(X, X + di)); t1 = slice(max(0, dj), min(X, X + dj))
            k = np.zeros_like(hm); k[s0, s1] = known[t0, t1]
            cnt += k; sx += di * res * k; sy += dj * res * k
            sxx += (di * res) ** 2 * k; sxy += di * dj * res * res * k; syy += (dj * res) ** 2 * k
    c = np.maximum(cnt, 1)
    xx = sxx - (sx * sx) / c
    xy = sxy - (sx * sy) / c
    yy = syy - (sy * sy) / c
    det = xx * yy - xy * xy
    scale = np.maximum(xx * yy, 1e-12)
    return (cnt < 3) | (np.abs(det) <= 1e-4 * scale)
