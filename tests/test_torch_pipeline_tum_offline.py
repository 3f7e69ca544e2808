"""Port parity: the offline replay and the joint point polish of the TUM
drivers (slam/pipeline.py) against the JAX package's, in float64 on
tests/tum_parity.py's world (its offline files: object 0's ground cuboid and
the truth poses with seeded noise; two 16-bit depth images for --save-cloud).

- `run_offline_slam`: trajectory, object 0's history and final cuboid within
  1e-6 m, chi2 within 1e-6 relative; `build_offline_frames` within 1e-9.
- `cli offline --save-cloud 2` through both packages' `cli.main` (the port's
  with --float64 --device cpu): every file byte-equal.  The JAX command
  writes from the JAX driver's run of the first test (`jax_driver_memo`),
  the port's command runs its driver.
- `_point_refinement`, the polish of `refine_with_points` (Harris + ZNCC
  tracks, DLT triangulation from the incremental trajectory, the 3 px
  reprojection gate, tracks of at least 3 observations, one Schur LM of 8
  iterations), on each package's own incremental graph of the offline replay
  (they agree to 1e-6 m) with the world's intrinsics: trajectory within
  1e-5 m, cuboids within 1e-4 m.  It runs with 48 corners: the JAX package's
  float64 tracker costs about 30 s per frame on the CPU at the driver's 192.
  That `run_online_slam(refine_with_points=True)` runs this polish is held in
  the port alone.  (Seed 1: no ZNCC tie flips between the packages.)
  Each package's polish starts from the graph of its own offline driver's
  run above.
- tests/tum_parity.py, which chip_smoke.py imports, imports nothing of JAX.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from torch_parity import (  # one intra-op thread
    TUM_FILES, assert_same_files, jax_driver_memo, run_cli_both, to_np,
)
from tum_parity import N_FRAMES, write_world

from cube_slam_wu_tpu.slam import pipeline as jpipe
from cube_slam_wu_tpu.slam import tracker as jtracker
from cube_slam_wu_tpu_torch.slam import pipeline as tpipe
from cube_slam_wu_tpu_torch.slam import tracker as ttracker


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    folder, seq = write_world(tmp_path_factory.mktemp("tum") / "data")
    rng = np.random.default_rng(0)
    (folder / "depth_imgs").mkdir()
    for i in (0, 2):  # metres = value / 5000: 0.2-2.5 m
        depth = rng.integers(1000, 12500, seq.images[i].shape).astype(np.uint16)
        Image.fromarray(depth).save(folder / "depth_imgs" / f"{i:04d}_depth_raw.png")
    return folder, seq


@pytest.fixture(scope="module")
def folder(world):
    return world[0]


def _with_graph(pipe, tracker, folder, **kw):
    """`pipe.run_offline_slam(folder, **kw)` and the incremental graph it
    ends with (kept from its call of `tracker.run_incremental`)."""
    graphs = []
    run_incremental = tracker.run_incremental

    def keep(*a, **k):
        out = run_incremental(*a, **k)
        graphs.append(out[0])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracker, "run_incremental", keep)
        out = pipe.run_offline_slam(folder, **kw)
    return out, graphs[0]


@pytest.fixture(scope="module")
def offline_runs(folder):
    """Both packages' offline replay in float64, each with its graph."""
    return (_with_graph(jpipe, jtracker, folder, dtype=jnp.float64),
            _with_graph(tpipe, ttracker, folder, dtype=torch.float64, device="cpu"))


def test_run_offline_slam_matches_jax_f64(offline_runs):
    (j, _), (p, _) = offline_runs
    np.testing.assert_allclose(j.traj_Twc_xyzq, p.traj_Twc_xyzq, atol=1e-6)
    np.testing.assert_allclose(j.cube_history, p.cube_history, atol=1e-6)
    np.testing.assert_allclose(j.cube_minimal, p.cube_minimal, atol=1e-6)
    np.testing.assert_allclose(j.chi2, p.chi2, rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(j.timestamps, p.timestamps)
    assert p.cubes_minimal is None and p.cube_history.shape == (N_FRAMES, 1, 9)


def test_offline_frames_match_jax(folder):
    """The measurements the offline replay builds: the saved cuboids in the
    camera frame of their pop poses, quality (1 - err + 0.5) / 2."""
    data = tpipe.load_offline_dataset(folder)
    j = jpipe.build_offline_frames(jpipe.load_offline_dataset(folder), jnp.float64)
    p = tpipe.build_offline_frames(data, torch.float64, "cpu")
    np.testing.assert_array_equal(np.asarray(j.has_meas), p.has_meas.numpy())
    np.testing.assert_allclose(np.asarray(j.quality), p.quality.numpy(), atol=1e-12)
    np.testing.assert_allclose(np.asarray(j.meas.to_minimal()), p.meas.to_minimal().numpy(),
                               atol=1e-9)
    assert p.has_meas.sum() < N_FRAMES  # some frames have no saved cuboid


def test_point_refinement_matches_jax_f64(world, offline_runs):
    """With the world's own intrinsics, so that the offline trajectory
    reprojects the tracks within the gate and points enter the polish."""
    folder, seq = world
    (_, jg), (_, tg) = offline_runs
    K = seq.K
    jr = jpipe._point_refinement(jg, folder, N_FRAMES, jnp.asarray(K), jnp.float64, max_corners=48)
    tr = tpipe._point_refinement(tg, folder, N_FRAMES, torch.as_tensor(K), torch.float64,
                                 max_corners=48)
    before = to_np(tg.cam_Twc().to_xyzq())
    after = to_np(tr.cam_Twc().to_xyzq())
    np.testing.assert_allclose(to_np(jr.cam_Twc().to_xyzq()), after, atol=1e-5)
    np.testing.assert_allclose(to_np(jr.cube.to_minimal()), to_np(tr.cube.to_minimal()),
                               atol=1e-4)
    assert np.abs(after - before).max() > 1e-6  # the polish moves the trajectory


def test_refine_with_points_runs_the_polish(folder, tmp_path):
    """`run_online_slam(refine_with_points=True)` polishes the trajectory of
    the plain run (both over the same saved front end)."""
    ck = tmp_path / "front.npz"
    a = tpipe.run_online_slam(folder, n_frames=4, dtype=torch.float64, device="cpu",
                              checkpoint_path=ck)
    b = tpipe.run_online_slam(folder, n_frames=4, dtype=torch.float64, device="cpu",
                              checkpoint_path=ck, refine_with_points=True)
    assert np.abs(a.traj_Twc_xyzq - b.traj_Twc_xyzq).max() > 1e-6
    np.testing.assert_array_equal(a.chi2, b.chi2)  # the incremental pass is the same


def test_cli_offline_writes_what_jax_writes(folder, offline_runs, tmp_path, capsys, monkeypatch):
    jax_driver_memo(monkeypatch, "run_offline_slam", offline_runs[0][0], folder)
    (j, _), (p, ptext) = run_cli_both(
        tmp_path, capsys, ["offline", "--base", str(folder), "--save-cloud", "2"]
    )
    assert_same_files(j, p, TUM_FILES + ("map_cloud.ply",))
    # object 0's per-frame history, one row per frame
    assert np.loadtxt(p / "output_obj_poses.txt").shape == (N_FRAMES, 9)
    assert "ATE RMSE vs truth" in ptext and "point cloud" in ptext


def test_tum_parity_imports_no_jax():
    """chip_smoke.py imports tests/tum_parity.py on the card, where nothing
    of JAX may be imported."""
    code = ("import sys; import tum_parity; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'cube_slam_wu_tpu')); "
            "assert not bad, bad")
    tests = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tests), str(tests.parent)]))
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)


def test_pose_graph_parity_imports_no_jax():
    """chip_smoke.py and tests/test_torch_cuda.py import
    tests/pose_graph_parity.py on the card, where nothing of JAX may be
    imported."""
    code = ("import sys; import pose_graph_parity; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'cube_slam_wu_tpu')); "
            "assert not bad, bad")
    tests = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tests), str(tests.parent)]))
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
