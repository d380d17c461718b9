"""The comparisons that decide ``correct``: the program's answer to a
request against the plain reference's for the same inputs. A cell's
limits file (``limits/<cell>.json``) names the comparisons it holds, each
a function here of (program's answer, reference's answer)."""

from __future__ import annotations

import numpy as np


def image_rms_rel(got: np.ndarray, want: np.ndarray) -> float:
    """The largest over the request's images of the RMS of the pixel
    difference over the RMS of the reference image about its own mean, in
    uint8 levels. A missing image, a wrong shape or a blank reference reads
    infinite."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape or got.dtype != np.uint8:
        return float("inf")
    worst = 0.0
    for g, w in zip(got.astype(np.float64), want.astype(np.float64)):
        spread = float(np.sqrt(np.mean((w - w.mean()) ** 2)))
        if spread == 0.0:
            return float("inf")
        worst = max(worst, float(np.sqrt(np.mean((g - w) ** 2))) / spread)
    return worst


def map_max_abs(got: np.ndarray, want: np.ndarray) -> float:
    """The largest absolute difference between two float maps in [0, 1]
    (a preprocessor's control image). A wrong shape, a non-float map or a
    value that is not finite reads infinite."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape or got.dtype.kind != "f":
        return float("inf")
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return float(gap.max()) if np.isfinite(gap).all() else float("inf")
