"""The port's in-memory KITTI driver (`run_kitti_frames`) against its file
reader (`run_kitti_slam`) on the short synthetic drive of
tests/kitti_parity.py: the same result bit for bit, and the same report of
missing frames.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread)
from kitti_parity import COMMON, MODES, N_FRAMES, write_drive

from cube_slam_wu_tpu_torch.slam import pipeline as tpipe


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return write_drive(tmp_path_factory.mktemp("kitti") / "seq")


def test_run_kitti_frames_in_memory_equals_file_reader(drive):
    """The in-memory driver over the decoded frames and the parsed first pose
    gives the file reader's result bit for bit; a missing image and a missing
    detections file are reported as the file reader reports them."""
    from cube_slam_wu_tpu_torch.utils import io as uio
    from cube_slam_wu_tpu_torch.utils import kitti as ukitti

    seq_dir, det_dir, poses, _ = drive
    kw = dict(COMMON, **MODES["two_phase"])
    ks = ukitti.load_sequence(seq_dir, poses)
    frames = [
        (uio.load_image_gray(ks.image_paths[i]).astype(np.uint8),
         uio.read_number_txt(ukitti.detection_txt_path(det_dir, i)))
        for i in range(N_FRAMES)
    ]
    a = tpipe.run_kitti_slam(seq_dir, det_dir, poses, dtype=torch.float64, device="cpu", **kw)
    b = tpipe.run_kitti_frames(frames, ks.K, ks.poses_T_wc[0], timestamps=ks.timestamps,
                               dtype=torch.float64, device="cpu", **kw)
    for f in ("traj_Twc_xyzq", "cubes_minimal", "cube_valid", "chi2", "cube_history"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    frames[3] = (None, frames[3][1])
    frames[5] = (frames[5][0], None)
    c = tpipe.run_kitti_frames(frames, ks.K, ks.poses_T_wc[0], dtype=torch.float64, device="cpu", **kw)
    assert c.frontend_report.missing_image == [3]
    assert c.frontend_report.missing_detections == [5]
