"""Port parity: the KITTI driver in float32, the production dtype, in the
production mode (interleaved with point landmarks), against the JAX package
on the short synthetic drive of tests/kitti_parity.py.

Tolerances: 3e-3 m on the trajectory, 3e-2 on landmarks, 1e-2 relative on
per-frame chi2; landmark validity and every front-end counter exactly.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread)
from kitti_parity import COMMON, MODES, write_drive

import jax.numpy as jnp

from cube_slam_wu_tpu.slam import pipeline as jpipe
from cube_slam_wu_tpu_torch.slam import pipeline as tpipe


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return write_drive(tmp_path_factory.mktemp("kitti") / "seq")


def test_run_kitti_slam_points_matches_jax_f32(drive):
    """The production dtype on the production mode."""
    seq_dir, det_dir, poses, _ = drive
    kw = dict(COMMON, **MODES["points"])
    j = jpipe.run_kitti_slam(seq_dir, det_dir, poses, dtype=jnp.float32, **kw)
    p = tpipe.run_kitti_slam(seq_dir, det_dir, poses, dtype=torch.float32, device="cpu", **kw)
    np.testing.assert_array_equal(j.cube_valid, p.cube_valid)
    assert j.frontend_report._asdict() == p.frontend_report._asdict()
    np.testing.assert_allclose(j.traj_Twc_xyzq, p.traj_Twc_xyzq, atol=3e-3)
    v = p.cube_valid
    np.testing.assert_allclose(j.cubes_minimal[v], p.cubes_minimal[v], atol=3e-2)
    np.testing.assert_allclose(j.chi2, p.chi2, rtol=1e-2, atol=1e-6)
