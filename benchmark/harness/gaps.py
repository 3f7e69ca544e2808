"""How far apart two answers lie, for the comparisons of the references.

An answer of one side matches one of the other where every gap between them
is within the comparison's tolerance; a value that is not finite matches
nothing.
"""

from __future__ import annotations

import numpy as np


def segment_distances(a, b) -> np.ndarray:
    """(N, M) distances between the segments a (N, 4) and b (M, 4), [x1 y1 x2
    y2]: the farther pair of endpoints, paired in whichever direction is
    closer (pixels)."""
    a, b = np.asarray(a, np.float64).reshape(-1, 4), np.asarray(b, np.float64).reshape(-1, 4)

    def far(p, q):
        d0 = np.linalg.norm(p[:, None, :2] - q[None, :, :2], axis=-1)
        d1 = np.linalg.norm(p[:, None, 2:] - q[None, :, 2:], axis=-1)
        return np.maximum(d0, d1)

    return np.minimum(far(a, b), far(a, b[:, [2, 3, 0, 1]]))


def unmatched(within: np.ndarray) -> int:
    """Rows and columns of a (N, M) table of matches that match nothing."""
    within = np.asarray(within, bool)
    if within.size == 0:
        return int(sum(within.shape))
    return int((~within.any(axis=1)).sum() + (~within.any(axis=0)).sum())


def angle_gap(a, b) -> np.ndarray:
    """|a - b| of angles in radians, wrapped into [0, pi]."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(np.angle(np.exp(1j * d)))
