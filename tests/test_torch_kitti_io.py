"""Port parity: the KITTI odometry layout (utils/kitti.py) and its synthetic
writer (utils/synth.write_kitti_sequence) against the JAX package's.

Exact: the writers produce the same bytes; the readers the same arrays
(float64 parsing of the same text)."""

import filecmp

import numpy as np
import pytest

from cube_slam_wu_tpu.utils import kitti as jkitti
from cube_slam_wu_tpu.utils import synth as jsynth
from cube_slam_wu_tpu_torch.utils import kitti as tkitti
from cube_slam_wu_tpu_torch.utils import synth as tsynth

WORLD = dict(n_frames=4, n_objects=2, size=(120, 160), speed=0.5, curve=0.002,
             noise_px=0.8, dropout=0.05, seed=4, ground_texture=4.0)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_io")
    tseq = tsynth.make_sequence(**WORLD)
    jseq = jsynth.make_sequence(**WORLD)
    return tseq, tsynth.write_kitti_sequence(tseq, root / "port"), jsynth.write_kitti_sequence(jseq, root / "jax")


def test_constants():
    np.testing.assert_array_equal(tkitti.KITTI_TO_ZUP, jkitti.KITTI_TO_ZUP)
    assert tkitti.CAMERA_HEIGHT_M == jkitti.CAMERA_HEIGHT_M
    np.testing.assert_array_equal(tsynth.KITTI_TO_ZUP, jkitti.KITTI_TO_ZUP)


def test_writer_writes_the_same_files(written):
    _, (tout, tdet, tposes), (jout, jdet, jposes) = written
    for name in ("calib.txt", "times.txt", "poses.txt"):
        assert filecmp.cmp(tout / name, jout / name, shallow=False), name
    for i in range(WORLD["n_frames"]):
        assert filecmp.cmp(tdet / f"{i:06d}.txt", jdet / f"{i:06d}.txt", shallow=False)
        assert filecmp.cmp(tout / "image_0" / f"{i:06d}.png", jout / "image_0" / f"{i:06d}.png",
                           shallow=False)
    assert tdet.name == jdet.name == "detections"


def test_parse_calib_and_poses(written):
    seq, (out, _, poses), _ = written
    np.testing.assert_array_equal(tkitti.parse_calib(out / "calib.txt"),
                                  jkitti.parse_calib(out / "calib.txt"))
    np.testing.assert_allclose(tkitti.parse_calib(out / "calib.txt"), seq.K, atol=1e-5)
    tp, jp = tkitti.parse_poses(poses), jkitti.parse_poses(poses)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(tp, seq.T_wc, atol=1e-8)  # z-up, camera 1.65 m up
    assert tp.shape == (WORLD["n_frames"], 4, 4)


def test_parse_single_pose_row_and_missing_p0(tmp_path):
    row = np.arange(12, dtype=float)[None]
    np.savetxt(tmp_path / "one.txt", row)
    np.testing.assert_array_equal(tkitti.parse_poses(tmp_path / "one.txt"),
                                  jkitti.parse_poses(tmp_path / "one.txt"))
    (tmp_path / "calib.txt").write_text("P1: 1 2 3\n")
    with pytest.raises(ValueError, match="no P0 row"):
        tkitti.parse_calib(tmp_path / "calib.txt")


@pytest.mark.parametrize("with_poses", [True, False])
def test_load_sequence(written, with_poses):
    _, (out, det, poses), _ = written
    p = poses if with_poses else None
    t, j = tkitti.load_sequence(out, p), jkitti.load_sequence(out, p)
    np.testing.assert_array_equal(t.K, j.K)
    np.testing.assert_array_equal(t.timestamps, j.timestamps)
    assert [str(a) for a in t.image_paths] == [str(a) for a in j.image_paths]
    assert t.seq_dir == j.seq_dir
    if with_poses:
        np.testing.assert_array_equal(t.poses_T_wc, j.poses_T_wc)
    else:
        assert t.poses_T_wc is None and j.poses_T_wc is None
    assert tkitti.detection_txt_path(det, 7) == jkitti.detection_txt_path(det, 7)


def test_load_sequence_without_times_or_images(tmp_path):
    (tmp_path / "calib.txt").write_text("P0: " + " ".join(["1.0"] * 12) + "\n")
    t, j = tkitti.load_sequence(tmp_path), jkitti.load_sequence(tmp_path)
    assert t.image_paths == j.image_paths == []
    np.testing.assert_array_equal(t.timestamps, j.timestamps)
