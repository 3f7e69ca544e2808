"""Reference of entry `detect_cuboid`: the expected answers on the fixed
world's frames, made by an independent implementation (the JAX package on
the CPU, `expected/make_expected.py`) and read from the traffic's `expected`
file; this module only compares (numpy).

Every frame the window produced is compared with the file's answers for that
frame.  Two implementations in float32 agree on most answers to rounding and
part on a few: a segment near the detector's thresholds, or a ranking that a
near tie decides.  So each number is the share of answers that find no
counterpart within a tolerance far above rounding:
- `line_miss_pct`: line segments of either side with no segment of the other
  within `LINE_TOL_PX` (endpoints, in either direction);
- `cuboid_miss_pct`: valid ranked cuboids of either side with no valid
  cuboid of the other, for the same box, whose centre and half-extents lie
  within `CUBE_TOL_M`, yaw within `YAW_TOL_RAD` and score (the normalised
  edge error) within `SCORE_TOL`;
- `best_miss_pct`: boxes whose best cuboid does not match the other side's
  best so, or is valid on one side only.
"""

from __future__ import annotations

import numpy as np

from harness import gaps as g

LINE_TOL_PX = 0.1
CUBE_TOL_M = 1e-3
YAW_TOL_RAD = 1e-3
SCORE_TOL = 1e-3
FIELDS = ("valid", "pos", "scale", "rotY", "normalized_error")


def _matches(got: dict, want: dict, b: int) -> np.ndarray:
    """(N_got, N_want) matches between the valid ranked cuboids of box b."""
    vg, vw = np.asarray(got["valid"][b], bool), np.asarray(want["valid"][b], bool)
    pick = lambda d, k, v: np.asarray(d[k][b], np.float64)[v]  # noqa: E731
    near = lambda k: np.linalg.norm(  # noqa: E731
        pick(got, k, vg)[:, None] - pick(want, k, vw)[None], axis=-1)
    yaw = g.angle_gap(pick(got, "rotY", vg)[:, None], pick(want, "rotY", vw)[None])
    err = np.abs(pick(got, "normalized_error", vg)[:, None]
                 - pick(want, "normalized_error", vw)[None])
    return ((near("pos") <= CUBE_TOL_M) & (near("scale") <= CUBE_TOL_M)
            & (yaw <= YAW_TOL_RAD) & (err <= SCORE_TOL))


def frame_misses(got: dict, want: dict) -> dict:
    """Misses and totals of one frame: lines, ranked cuboids, best cuboids."""
    d = g.segment_distances(got["lines"], want["lines"])
    out = {"line": (g.unmatched(d <= LINE_TOL_PX), d.shape[0] + d.shape[1])}
    cube = best = n_cube = n_best = 0
    for b in range(np.asarray(want["valid"]).shape[0]):
        m = _matches(got, want, b)
        cube += g.unmatched(m)
        n_cube += m.shape[0] + m.shape[1]
        bg, bw = bool(got["valid"][b][0]), bool(want["valid"][b][0])
        if bg or bw:
            n_best += 1
            best += not (bg and bw and m[0, 0])
    out.update(cuboid=(cube, n_cube), best=(best, n_best))
    return out


def readings(ctx, frames) -> tuple:
    """(each number in percent, the frames with a miss, the frames compared)."""
    a = ctx.expected
    miss, total, frames_missed = {}, {}, 0
    for f in frames:
        i = f["frame"]
        want = {"lines": a["lines"][i][a["lmask"][i]], **{k: a[k][i] for k in FIELDS}}
        per = frame_misses(f, want)
        frames_missed += any(m for m, _ in per.values())
        for k, (m, n) in per.items():
            miss[k] = miss.get(k, 0) + m
            total[k] = total.get(k, 0) + n
    values = {f"{k}_miss_pct": 100.0 * miss[k] / max(total[k], 1) for k in miss}
    return values, frames_missed, len(frames)
