"""Port parity: the KITTI driver's checkpoint pair, from the port to the
JAX package.

A port run interrupted after its frame-4 checkpoint (the state `.npz`, then
the carry `(graph, CubePrior, PointState)` in `.carry.npz`) resumes in the
JAX package and ends where the port's uninterrupted run ends; a torn pair
(state without carry) starts fresh.  The other direction is in
test_torch_pipeline_kitti_resume_jax.py.

Tolerances: float64 1e-5 m on trajectories (as test_torch_pipeline_kitti.py),
landmark validity and counters exactly.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread)
from kitti_parity import (
    CRASH_AT, RESUME_KW, N_FRAMES, Crash, assert_outputs_agree, port_full_run, write_drive,
)

import jax.numpy as jnp

from cube_slam_wu_tpu.slam import pipeline as jpipe
from cube_slam_wu_tpu_torch.slam import pipeline as tpipe
from cube_slam_wu_tpu_torch.utils import io as uio
from cube_slam_wu_tpu_torch.utils import kitti as ukitti

@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return write_drive(tmp_path_factory.mktemp("kitti_resume") / "seq")


@pytest.fixture(scope="module")
def port_full(drive):
    return port_full_run(drive)


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
