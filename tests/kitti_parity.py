"""Helpers of the port's parity tests for the KITTI driver: one short
synthetic drive written in the KITTI odometry layout, read by both packages'
`run_kitti_slam`, and the three driver modes.

The drive is the KITTI world of chip_smoke.py's kitti_path at 240x320 and 8
frames, seed 6, three objects, with the first pose (the written ground
truth) tilted by 0.4 deg roll / 0.7 deg pitch: an exactly level camera puts
the vertical vanishing point at infinity, where the proposal engine's
support-edge choice is a coin toss in both packages (ROADMAP queue 3 entry
2).  The interleaved modes feed each frame's pose back into the next
frame's proposals, so a single flipped tie anywhere (queue 3 entries 3, 6
and 7) moves the rest of the drive; on seed 6 none flips in these 8 frames,
on seeds 4 and 5 one does (the LBD line-track weight at frame 4, a ZNCC
argmax at frame 7).

2D box edges (weight 0.005) keep a landmark seen once off its measurement:
with the 3D edge alone LM pins it there exactly and the JAX package's next
linearization takes the degenerate half-turn front face (queue 3 entry 1),
which the port avoids by design.
"""

import numpy as np

from cube_slam_wu_tpu_torch.utils import hostsync
from cube_slam_wu_tpu_torch.utils import synth as tsynth
from tum_parity import tilt

N_FRAMES, SIZE, N_OBJECTS, SEED = 8, (240, 320), 3, 6
WORLD = dict(n_frames=N_FRAMES, n_objects=N_OBJECTS, size=SIZE, speed=0.5, curve=0.002,
             noise_px=0.8, seed=SEED, ground_texture=4.0)
COMMON = dict(max_objects=4, max_detections=3, window=4, bbox_edge_weight=0.005)
MODES = {
    "points": dict(pose_feedback=True, point_weight=0.3, n_points=32),
    "lines": dict(pose_feedback=True),  # auto line-track weight 0.5
    "two_phase": dict(pose_feedback=False),
}
# the resume tests: the points mode checkpointed every 4 frames, stopped at
# frame CRASH_AT
RESUME_KW = dict(COMMON, **MODES["points"], checkpoint_every=4)
CRASH_AT = 6


class Crash(RuntimeError):
    """Raised where a killed run would have stopped."""


def port_run_f64(drive, mode):
    """The port's uninterrupted `run_kitti_slam` in float64 over the drive in
    one mode (in the points mode: the resume tests' settings without the
    checkpoints)."""
    import torch

    from cube_slam_wu_tpu_torch.slam import pipeline as tpipe

    seq_dir, det_dir, poses, _ = drive
    kw = dict(COMMON, **MODES[mode])
    return tpipe.run_kitti_slam(seq_dir, det_dir, poses, dtype=torch.float64, device="cpu", **kw)


# what the pinning tests hold a drive to, for each stage label it booked
BOOKED_KEYS = ("entries", "syncs", "h2d_bytes", "d2h_bytes")


def booked(before, after) -> dict:
    """What a drive booked between two `hostsync.snapshot()`s: for every
    stage label (the benchmark's per-layer metrics read the drivers' labels),
    the tuple of its BOOKED_KEYS counts."""
    stages = hostsync.delta(before, after)["by_stage"]
    return {label: tuple(int(c[k]) for k in BOOKED_KEYS) for label, c in stages.items()}


def port_run_booked(drive, mode):
    """`port_run_f64(drive, mode)` and what it booked (`booked`)."""
    before = hostsync.snapshot()
    out = port_run_f64(drive, mode)
    return out, booked(before, hostsync.snapshot())


def write_drive(root):
    """The drive in KITTI layout under `root`: (seq_dir, detections_dir,
    poses_path, the in-memory sequence)."""
    seq = tsynth.make_sequence(**WORLD)
    seq = seq._replace(T_wc=tilt(seq.T_wc))
    out, det_dir, poses = tsynth.write_kitti_sequence(seq, root)
    return out, det_dir, poses, seq


def jax_run_f64(drive, mode):
    """The JAX package's `run_kitti_slam` in float64 over the drive in one
    mode (committed: jax_runs)."""
    import jax.numpy as jnp

    import jax_runs
    from cube_slam_wu_tpu.slam import pipeline as jpipe

    seq_dir, det_dir, poses, _ = drive
    kw = dict(COMMON, **MODES[mode])
    return jax_runs.run(f"kitti_{mode}_f64",
                        lambda: jpipe.run_kitti_slam(seq_dir, det_dir, poses, dtype=jnp.float64, **kw))


def check_mode_f64(drive, mode, port=None):
    """Both packages' `run_kitti_slam` in float64 over the drive in one mode:
    trajectory to 1e-5 m, landmarks and history to 1e-4 m, per-frame chi2 to
    1e-4 relative, validity and every counter exactly.  `port` is the port's
    `port_run_f64(drive, mode)` where the caller has made it already."""
    j = jax_run_f64(drive, mode)
    p = port_run_f64(drive, mode) if port is None else port
    assert_outputs_agree(j, p, traj_tol=1e-5, chi2_rtol=1e-4)
    assert p.cube_valid.sum() >= 2, "the drive confirms landmarks"
    assert len(p.chi2) == N_FRAMES and np.isfinite(p.traj_Twc_xyzq).all()
    if mode == "points":
        assert p.point_valid is not None and p.point_valid.any()
        assert p.prior_valid is not None and p.prior_valid.any(), "frames 4-7 absorb"
    else:
        assert p.point_valid is None


def assert_outputs_agree(j, p, traj_tol, chi2_rtol):
    """JAX SlamOutput against the port's: trajectory, landmarks, per-frame
    chi2 and landmark history at the tolerance; validity and every report
    counter exactly."""
    np.testing.assert_array_equal(j.cube_valid, p.cube_valid)
    assert j.frontend_report._asdict() == p.frontend_report._asdict()
    np.testing.assert_allclose(j.traj_Twc_xyzq, p.traj_Twc_xyzq, atol=traj_tol)
    v = p.cube_valid
    np.testing.assert_allclose(j.cubes_minimal[v], p.cubes_minimal[v], atol=10 * traj_tol)
    np.testing.assert_allclose(j.chi2, p.chi2, rtol=chi2_rtol, atol=1e-9)
    np.testing.assert_allclose(j.cube_history, p.cube_history, atol=10 * traj_tol)
    np.testing.assert_allclose(j.timestamps, p.timestamps)
