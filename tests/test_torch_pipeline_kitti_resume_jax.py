"""Port parity: the KITTI driver's checkpoint pair, from the JAX package to
the port: a JAX run interrupted after its frame-4 checkpoint resumes in the
port and ends where the port's uninterrupted run ends.

Tolerances: float64 1e-5 m on trajectories (as test_torch_pipeline_kitti.py),
1e-3 m on point landmarks (weakly constrained, 5-6 m away), landmark
validity and counters exactly.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread)
from kitti_parity import (
    CRASH_AT, RESUME_KW, Crash, assert_outputs_agree, port_full_run, write_drive,
)

import jax.numpy as jnp

from cube_slam_wu_tpu.slam import pipeline as jpipe
from cube_slam_wu_tpu_torch.slam import pipeline as tpipe

@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return write_drive(tmp_path_factory.mktemp("kitti_resume_jax") / "seq")


@pytest.fixture(scope="module")
def port_full(drive):
    return port_full_run(drive)


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
