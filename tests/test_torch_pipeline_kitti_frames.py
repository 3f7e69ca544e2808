"""The port's in-memory KITTI driver (`run_kitti_frames`) against its file
reader (`run_kitti_slam`) on the short synthetic drive of
tests/kitti_parity.py: the same result bit for bit, and the same report of
missing frames.  Caps of the proposal engine that bind are rerun with the
caps off in both frame loops: the same result as a run without caps.
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


@pytest.fixture(scope="module")
def decoded(drive):
    """The drive's frames decoded, and its sequence (K, poses, timestamps)."""
    from cube_slam_wu_tpu_torch.utils import io as uio
    from cube_slam_wu_tpu_torch.utils import kitti as ukitti

    seq_dir, det_dir, poses, _ = drive
    ks = ukitti.load_sequence(seq_dir, poses)
    frames = [
        (uio.load_image_gray(ks.image_paths[i]).astype(np.uint8),
         uio.read_number_txt(ukitti.detection_txt_path(det_dir, i)))
        for i in range(N_FRAMES)
    ]
    return frames, ks


def test_run_kitti_frames_in_memory_equals_file_reader(drive, decoded):
    """The in-memory driver over the decoded frames and the parsed first pose
    gives the file reader's result bit for bit; a missing image and a missing
    detections file are reported as the file reader reports them."""
    seq_dir, det_dir, poses, _ = drive
    kw = dict(COMMON, **MODES["two_phase"])
    frames, ks = list(decoded[0]), decoded[1]
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


@pytest.mark.parametrize("mode", ["two_phase", "lines"])
def test_binding_caps_are_rerun_without_caps(decoded, mode):
    """Caps small enough to bind: every frame they bind on is proposed again
    with the caps off (`ops.proposal.caps_off`), so the run equals one that
    never had caps, bit for bit, and the report counts each rerun."""
    frames, ks = decoded
    kw = dict(COMMON, **MODES[mode], n_frames=3, dtype=torch.float64, device="cpu")
    tiny = dict(dist_gather_cap=200, dist_gather_cap2=60, merge_cap=4)
    none = dict(dist_gather_cap=0, dist_gather_cap2=0, merge_cap=0)
    a = tpipe.run_kitti_frames(frames, ks.K, ks.poses_T_wc[0], proposal_overrides=tiny, **kw)
    b = tpipe.run_kitti_frames(frames, ks.K, ks.poses_T_wc[0], proposal_overrides=none, **kw)
    ra, rb = a.frontend_report, b.frontend_report
    assert ra.cap_fallbacks == ra.cap_overflow_frames >= 2 and rb.cap_fallbacks == 0
    assert ra._replace(cap_fallbacks=0, cap_overflow_frames=0) == rb
    for f in ("traj_Twc_xyzq", "cubes_minimal", "cube_valid", "chi2", "cube_history"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
