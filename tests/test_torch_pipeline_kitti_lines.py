"""Port parity: the KITTI driver (`run_kitti_slam`) interleaved without
points, with the LBD line-track weight (auto: 0.5), against the JAX
package's, both reading the same KITTI-layout files of a short synthetic
drive (tests/kitti_parity.py).

Tolerances: float64 1e-5 m on the trajectory (the ZNCC tracker runs in
float32 in both packages; its positions agree to 2e-5 px), 1e-4 m on
landmarks and their history, 1e-4 relative on per-frame chi2 (kitti_parity.
check_mode_f64); landmark validity and every front-end counter exactly.
"""

import pytest

import torch_parity  # noqa: F401  (one intra-op thread)
from kitti_parity import check_mode_f64, write_drive


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return write_drive(tmp_path_factory.mktemp("kitti") / "seq")


@pytest.mark.parametrize("mode", ["lines"])
def test_run_kitti_slam_matches_jax_f64(drive, mode):
    check_mode_f64(drive, mode)
