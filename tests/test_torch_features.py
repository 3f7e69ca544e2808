"""Port parity: the point-feature front-end (slam/features.py) — Harris
corners, ZNCC tracking, the incremental slot tracker and the track builder —
against the JAX package on rendered frames of the synthetic KITTI world (with
ground texture, so the ground has corners).

Exact: the cumulative sums and the box filter (same summation order as XLA on
the CPU), Harris corners in float32 (same fused multiply-adds), every mask
(tracked, alive, respawned, ground hint) and slot assignment.  Tolerances:
tracked positions 1e-4 px and ZNCC peaks 1e-5 (the grouped correlation sums
its 81 taps in a different order than XLA's convolution); float64 Harris
corners exactly on this frame.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread)
from torch_parity import to_np

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.slam import features as jfeat
from cube_slam_wu_tpu_torch.slam import features as tfeat
from cube_slam_wu_tpu_torch.utils import io as uio
from cube_slam_wu_tpu_torch.utils import synth as tsynth

N = 6
SEQ = tsynth.make_sequence(n_frames=N, n_objects=3, size=(240, 320), speed=0.5, curve=0.002,
                           noise_px=0.8, seed=6, ground_texture=4.0)
GRAYS = [im.astype(np.float32) for im in SEQ.images]


@pytest.mark.parametrize("n", [1, 5, 16, 17, 57, 320, 1242])
def test_cumsum_and_box_blur_bit_equal(n):
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((7, n)) * 100).astype(np.float32) ** 2
    j = np.asarray(jax.jit(lambda x: jnp.cumsum(x, axis=-1))(a))
    np.testing.assert_array_equal(j, tfeat._cumsum(torch.from_numpy(a), -1).numpy())
    j0 = np.asarray(jax.jit(lambda x: jnp.cumsum(x, axis=0))(a.T))
    np.testing.assert_array_equal(j0, tfeat._cumsum(torch.from_numpy(a.T.copy()), 0).numpy())
    if n >= 5:
        jb = np.asarray(jax.jit(lambda x: jfeat._box_blur(x, 2))(a))
        np.testing.assert_array_equal(jb, tfeat._box_blur(torch.from_numpy(a), 2).numpy())


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_harris_corners_on_rendered_frame(dtype):
    npd = np.float32 if dtype == "f32" else np.float64
    g = SEQ.images[0].astype(npd)
    jp, jm = jax.device_get(jfeat.harris_corners(jnp.asarray(g), max_corners=64))
    tp, tm = tfeat.harris_corners(torch.from_numpy(g), max_corners=64)
    np.testing.assert_array_equal(jm, to_np(tm))
    np.testing.assert_array_equal(jp, to_np(tp))
    assert 10 < int(jm.sum()) <= 64
    ys = to_np(tp)[to_np(tm), 1]
    assert (ys > SEQ.K[1, 2] + 5).any(), "ground corners below the horizon"


def test_track_corners_known_shift_and_variance_floor():
    """The next frame is the previous one shifted by (+3, -2) px: textured
    corners track to exactly that shift; corners put in the flat sky hit the
    variance floor (every candidate's ZNCC is 0) and are not tracked."""
    prev = GRAYS[0]
    nxt = np.roll(prev, (-2, 3), axis=(0, 1))
    pts, mask = jax.device_get(jfeat.harris_corners(jnp.asarray(prev), max_corners=32))
    pts = np.array(pts, np.float64)
    mask = np.array(mask)
    sky = np.array([[60.0, 20.0], [200.0, 25.0], [280.0, 18.0]])  # rows above the horizon
    pts = np.vstack([pts, sky])
    mask = np.concatenate([mask, np.ones(3, bool)])
    j = jax.device_get(jfeat.track_corners(jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts),
                                           jnp.asarray(mask)))
    t = tfeat.track_corners(torch.from_numpy(prev), torch.from_numpy(nxt), torch.from_numpy(pts),
                            torch.from_numpy(mask))
    np.testing.assert_array_equal(j[1], to_np(t[1]))
    np.testing.assert_allclose(j[0][j[1]], to_np(t[0])[j[1]], atol=1e-4)
    np.testing.assert_allclose(j[2], to_np(t[2]), atol=1e-5)
    tracked = to_np(t[1])
    inner = tracked[:-3]
    assert inner.sum() >= 0.8 * mask[:-3].sum()
    shift = to_np(t[0])[:-3][inner] - pts[:-3][inner]
    # the integer peak is the true shift; the sub-pixel step stays within its
    # +-0.5 px clamp (flat-shaded plateaus make the parabola lopsided)
    np.testing.assert_array_equal(np.round(shift), np.broadcast_to([3.0, -2.0], shift.shape))
    assert np.abs(shift - [3.0, -2.0]).max() <= 0.5
    # flat sky: every candidate below the variance floor -> ZNCC 0, not tracked
    assert not tracked[-3:].any()
    np.testing.assert_array_equal(to_np(t[2])[-3:], 0.0)


def test_incremental_tracker_advance():
    """Six frames of the rolling slot tracker with detection boxes: slot
    positions, alive / respawned / ground-hint masks and the checkpointed
    state, frame by frame."""
    J = jfeat.IncrementalTracker(32, horizon_row=float(SEQ.K[1, 2]) + 5.0)
    T = tfeat.IncrementalTracker(32, horizon_row=float(SEQ.K[1, 2]) + 5.0)
    respawns = 0
    for i in range(N):
        boxes, _, m = uio.detections_from_rows(SEQ.detections[i], n_max=3)
        jo = J.advance(jnp.asarray(GRAYS[i]), boxes[m])
        to = T.advance(torch.from_numpy(GRAYS[i]), boxes[m])
        for k, name in ((1, "alive"), (2, "respawned"), (3, "ground")):
            np.testing.assert_array_equal(jo[k], to[k], err_msg=f"frame {i} {name}")
        np.testing.assert_allclose(jo[0][jo[1]], to[0][to[1]], atol=1e-4, err_msg=f"frame {i}")
        respawns += int(to[2].sum())
        js, ts = J.state(), T.state()
        for k in js:
            np.testing.assert_allclose(js[k], ts[k], atol=1e-4)
    assert to[3].any() and not to[3].all(), "ground hints below the horizon, outside the boxes"
    assert respawns >= 32 * 0.6


def test_incremental_tracker_state_roundtrip():
    T = tfeat.IncrementalTracker(8)
    T.advance(torch.from_numpy(GRAYS[0]))
    U = tfeat.IncrementalTracker(8)
    U.load_state(T.state())
    for k, v in T.state().items():
        np.testing.assert_array_equal(U.state()[k], v)


def test_build_point_tracks():
    """Tracks through five frames with a small corner budget, so re-detection
    appends into unused slots: observation raster and masks."""
    jg = [jnp.asarray(g) for g in GRAYS[:5]]
    tg = [torch.from_numpy(g) for g in GRAYS[:5]]
    kw = dict(max_corners=24, redetect_min_alive=30)  # re-detect every frame
    juv, jm = jfeat.build_point_tracks(jg, **kw)
    tuv, tm = tfeat.build_point_tracks(tg, **kw)
    np.testing.assert_array_equal(jm, tm)
    np.testing.assert_allclose(juv[jm], tuv[tm], atol=1e-4)
    assert tm.shape == (5, 48) and tm[:, 24:].any(), "re-detection filled later slots"
