"""Port parity: the KITTI driver (`run_kitti_slam`) interleaved with point
landmarks (the production mode) against the JAX package's, both reading the
same KITTI-layout files of a short synthetic drive (tests/kitti_parity.py);
the entry points' device rule and the detector options (the yaw prior
of the single-track front end is held against JAX in
tests/test_torch_pipeline_tum.py).

Tolerances: float64 1e-5 m on the trajectory (the ZNCC tracker runs in
float32 in both packages; its positions agree to 2e-5 px), 1e-4 m on
landmarks and their history, 1e-4 relative on per-frame chi2 (kitti_parity.
check_mode_f64); landmark validity and every front-end counter exactly.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread)
from kitti_parity import check_mode_f64, write_drive

from cube_slam_wu_tpu_torch.slam import pipeline as tpipe


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return write_drive(tmp_path_factory.mktemp("kitti") / "seq")


@pytest.mark.parametrize("mode", ["points"])
def test_run_kitti_slam_matches_jax_f64(drive, mode):
    check_mode_f64(drive, mode)


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
