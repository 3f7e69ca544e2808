"""Helpers of the port's parity tests for the TUM dataset commands.  Numpy
and the port only: chip_smoke.py imports `tilt`, `write_world`,
`write_offline_files` and the segment-set helpers from here, so this module
imports nothing of JAX or of the JAX package
(tests/test_torch_pipeline_tum_offline.py holds it to that).

`write_world` writes a synthetic world in the reference's object_slam/data
layout: the images, the YOLO-style detections and the truth poses that
`write_tum_sequence` writes, plus the two files of the offline replay that
`utils.synth.write_offline_files` makes up from the world's ground truth.
"""

import numpy as np

from cube_slam_wu_tpu_torch.utils import synth as tsynth
from cube_slam_wu_tpu_torch.utils.synth import write_offline_files

# The parity world: 8 frames at 240x320, three objects, textured ground (the
# point tracks need corners off the cuboids), seed 1, every written truth
# pose tilted by 0.4 deg roll / 0.7 deg pitch: at an exactly level camera the
# vertical vanishing point is at infinity, where the proposal engine's
# support-edge choice is a tie that the last bit decides (ROADMAP queue 3
# entry 2).  The folder readers fix the TUM intrinsics (principal point
# (320.1, 247.6), at this render's right edge): on seed 0 the strongest box
# of every frame then has no valid proposal in either package, on seed 1
# only frame 0's (no roll/pitch sampling there), so seed 1 exercises the
# drivers.  On seed 1 no tie flips between the packages in these 8 frames.
N_FRAMES, SIZE, N_OBJECTS, SEED = 8, (240, 320), 3, 1
WORLD = dict(n_frames=N_FRAMES, size=SIZE, n_objects=N_OBJECTS, seed=SEED, ground_texture=4.0)
TILT_DEG = (0.4, 0.7)  # roll, pitch


def tilt(T, roll_deg=TILT_DEG[0], pitch_deg=TILT_DEG[1]):
    """Pose(s) T with the camera turned by `roll_deg` about its optical axis
    and `pitch_deg` about its x axis (the images stay as they are)."""
    r, p = np.radians(roll_deg), np.radians(pitch_deg)
    Rx = np.array([[1, 0, 0], [0, np.cos(p), -np.sin(p)], [0, np.sin(p), np.cos(p)]])
    Rz = np.array([[np.cos(r), -np.sin(r), 0], [np.sin(r), np.cos(r), 0], [0, 0, 1]])
    out = np.array(T, dtype=np.float64)
    out[..., :3, :3] = out[..., :3, :3] @ Rx @ Rz
    return out


def write_world(folder, world=WORLD, tilt_deg=TILT_DEG, offline_seed=1):
    """Write the world (tilted truth poses) and its offline files under
    `folder`; returns (folder, the in-memory sequence)."""
    seq = tsynth.make_sequence(**world)
    seq = seq._replace(T_wc=tilt(seq.T_wc, *tilt_deg))
    folder = tsynth.write_tum_sequence(seq, folder)
    write_offline_files(seq, folder, offline_seed)
    return folder, seq


def segment_distances(a, b):
    """(Na, Nb): for segments a (Na, 4) and b (Nb, 4), the larger of the two
    endpoint distances, in the closer of the two endpoint orders."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d_same = np.maximum(
        np.linalg.norm(a[:, None, 0:2] - b[None, :, 0:2], axis=-1),
        np.linalg.norm(a[:, None, 2:4] - b[None, :, 2:4], axis=-1),
    )
    d_swap = np.maximum(
        np.linalg.norm(a[:, None, 0:2] - b[None, :, 2:4], axis=-1),
        np.linalg.norm(a[:, None, 2:4] - b[None, :, 0:2], axis=-1),
    )
    return np.minimum(d_same, d_swap)


def segment_match_fraction(a, b, tol=0.5):
    """Fraction of segments of `a` (N, 4) with a segment of `b` whose both
    endpoints lie within `tol` px (either endpoint order)."""
    if len(a) == 0:
        return 1.0
    if len(b) == 0:
        return 0.0
    return float((segment_distances(a, b).min(axis=1) < tol).mean())
