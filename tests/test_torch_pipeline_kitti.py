"""Port parity: the KITTI driver (`run_kitti_slam`) interleaved with point
landmarks (the production mode) against the JAX package's, both reading the
same KITTI-layout files of a short synthetic drive (tests/kitti_parity.py);
the driver's checkpoint pair across the two packages, both ways; the entry
points' device rule and the detector options (the yaw prior of the
single-track front end is held against JAX in
tests/test_torch_pipeline_tum.py).

The port's uninterrupted float64 run of that mode is made once, by the
module fixture `port_full`: the parity test holds it against the JAX
package's run, and the resume tests hold the resumed runs against it.

- From the port to the JAX package: a port run interrupted after its frame-4
  checkpoint (the state `.npz`, then the carry `(graph, CubePrior,
  PointState)` in `.carry.npz`) resumes in the JAX package and ends where the
  port's uninterrupted run ends; a torn pair (state without carry) starts
  fresh.
- From the JAX package to the port: a JAX run interrupted after its frame-4
  checkpoint resumes in the port and ends where the port's uninterrupted run
  ends.

Tolerances: float64 1e-5 m on the trajectory (the ZNCC tracker runs in
float32 in both packages; its positions agree to 2e-5 px), 1e-4 m on
landmarks and their history, 1e-4 relative on per-frame chi2 (kitti_parity.
check_mode_f64); 1e-3 m on point landmarks after a resume (weakly
constrained, 5-6 m away); landmark validity and every front-end counter
exactly.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread)
from kitti_parity import (
    CRASH_AT, N_FRAMES, RESUME_KW, Crash, assert_outputs_agree, check_mode_f64, port_run_f64,
    write_drive,
)

import jax.numpy as jnp

from cube_slam_wu_tpu.slam import pipeline as jpipe
from cube_slam_wu_tpu_torch.slam import pipeline as tpipe
from cube_slam_wu_tpu_torch.utils import io as uio
from cube_slam_wu_tpu_torch.utils import kitti as ukitti


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return write_drive(tmp_path_factory.mktemp("kitti") / "seq")


@pytest.fixture(scope="module")
def port_full(drive):
    return port_run_f64(drive, "points")


@pytest.mark.parametrize("mode", ["points"])
def test_run_kitti_slam_matches_jax_f64(drive, port_full, mode):
    check_mode_f64(drive, mode, port=port_full)


def test_entry_points_need_the_card_unless_told():
    """`device=None` means the card; without one the entry points raise
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_kitti_frames([(None, None)], np.eye(3), np.eye(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_kitti_slam("/nonexistent", "/nonexistent")


def test_unported_options_raise(drive):
    """`short_recovery`, refused before it was ported, is ignored by the
    interleaved KITTI loop as by the JAX package's (its plain
    `detect_line_segments`, JAX pipeline.py:1302): the outputs equal those
    with it off.  Point landmarks without the interleaved mode are refused."""
    from cube_slam_wu_tpu_torch.ops.detect import DetectConfig
    from kitti_parity import COMMON

    seq = drive[3]
    frames = [(seq.images[i], seq.detections[i]) for i in range(2)]
    runs = [
        tpipe.run_kitti_frames(frames, seq.K, seq.T_wc[0], device="cpu", pose_feedback=True,
                               detect_cfg=DetectConfig(short_recovery=flag), **COMMON)
        for flag in (True, False)
    ]
    for what in ("traj_Twc_xyzq", "cubes_minimal", "cube_valid", "chi2"):
        np.testing.assert_array_equal(getattr(runs[0], what), getattr(runs[1], what))
    assert runs[0].frontend_report == runs[1].frontend_report
    assert np.isfinite(runs[0].traj_Twc_xyzq).all()
    with pytest.raises(ValueError, match="interleaved"):
        tpipe.run_kitti_frames([(None, None)], np.eye(3), np.eye(4), device="cpu", point_weight=0.3)


class CrashingFrames:
    """The drive's frames as the file reader decodes them; frame CRASH_AT
    raises, as a killed run would stop there."""

    def __init__(self, seq_dir, det_dir):
        self.ks = ukitti.load_sequence(seq_dir)
        self.det_dir = det_dir

    def __len__(self):
        return N_FRAMES

    def __getitem__(self, i):
        if i == CRASH_AT:
            raise Crash(f"stopped at frame {i}")
        return (uio.load_image_gray(self.ks.image_paths[i]).astype(np.uint8),
                uio.read_number_txt(ukitti.detection_txt_path(self.det_dir, i)))


def test_port_checkpoint_resumes_in_jax(drive, port_full, tmp_path):
    seq_dir, det_dir, poses, _ = drive
    ck = tmp_path / "ck.npz"
    ks = ukitti.load_sequence(seq_dir, poses)
    with pytest.raises(Crash):
        tpipe.run_kitti_frames(CrashingFrames(seq_dir, det_dir), ks.K, ks.poses_T_wc[0],
                               timestamps=ks.timestamps, dtype=torch.float64, device="cpu",
                               checkpoint_path=ck, **RESUME_KW)
    state = np.load(ck)
    assert int(state["i_next"]) == 4 and (tmp_path / "ck.npz.carry.npz").exists()
    carry = np.load(tmp_path / "ck.npz.carry.npz")
    assert "2/points" in carry and "1/H" in carry and "0/cam_Tcw/quat" in carry
    j = jpipe.run_kitti_slam(seq_dir, det_dir, poses, dtype=jnp.float64, checkpoint_path=ck,
                             **RESUME_KW)
    assert_outputs_agree(j, port_full, traj_tol=1e-5, chi2_rtol=1e-4)
    assert int(np.load(ck)["i_next"]) == N_FRAMES


def test_torn_checkpoint_starts_fresh(drive, port_full, tmp_path, capsys):
    """A state file without its carry reads as "start fresh": the result is
    the uninterrupted run's, bit for bit."""
    seq_dir, det_dir, poses, _ = drive
    ck = tmp_path / "torn.npz"
    np.savez_compressed(ck, i_next=np.asarray(5), chi2s=np.zeros(N_FRAMES))
    p = tpipe.run_kitti_slam(seq_dir, det_dir, poses, dtype=torch.float64, device="cpu",
                             checkpoint_path=ck, **RESUME_KW)
    assert "starting fresh" in capsys.readouterr().out
    for f in ("traj_Twc_xyzq", "cubes_minimal", "cube_valid", "chi2", "points", "point_valid"):
        np.testing.assert_array_equal(getattr(p, f), getattr(port_full, f), err_msg=f)


def test_jax_checkpoint_resumes_in_port(drive, port_full, tmp_path, monkeypatch):
    seq_dir, det_dir, poses, _ = drive
    ck = tmp_path / "ck.npz"
    from cube_slam_wu_tpu.utils import io as jio

    load = jio.load_image_gray

    def crashing(path):
        if str(path).endswith(f"{CRASH_AT:06d}.png"):
            raise Crash("stopped")
        return load(path)

    monkeypatch.setattr(jio, "load_image_gray", crashing)
    with pytest.raises(Crash):
        jpipe.run_kitti_slam(seq_dir, det_dir, poses, dtype=jnp.float64, checkpoint_path=ck,
                             **RESUME_KW)
    monkeypatch.setattr(jio, "load_image_gray", load)
    assert int(np.load(ck)["i_next"]) == 4
    p = tpipe.run_kitti_slam(seq_dir, det_dir, poses, dtype=torch.float64, device="cpu",
                             checkpoint_path=ck, **RESUME_KW)
    assert_outputs_agree(p, port_full, traj_tol=1e-5, chi2_rtol=1e-4)
    np.testing.assert_allclose(p.points[p.point_valid], port_full.points[p.point_valid], atol=1e-3)
