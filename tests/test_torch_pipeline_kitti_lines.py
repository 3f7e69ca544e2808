"""Port parity: the KITTI driver (`run_kitti_slam`) interleaved without
points, with the LBD line-track weight (auto: 0.5), against the JAX
package's, both reading the same KITTI-layout files of a short synthetic
drive (tests/kitti_parity.py).

Tolerances: float64 1e-5 m on the trajectory (the ZNCC tracker runs in
float32 in both packages; its positions agree to 2e-5 px), 1e-4 m on
landmarks and their history, 1e-4 relative on per-frame chi2 (kitti_parity.
check_mode_f64); landmark validity and every front-end counter exactly.

The port's run is made once, by the module fixture `port`; the entries,
reads and bytes it books by stage label are held to `BOOKED`.
"""

import pytest

import torch_parity  # noqa: F401  (one intra-op thread)
from kitti_parity import check_mode_f64, port_run_booked, write_drive

# What the drive books by stage label: (entries, syncs, h2d_bytes, d2h_bytes)
# (kitti_parity.booked), recorded from the driver at commit a9456dc, before its
# two frame loops shared one front end.  The benchmark's per-layer metrics read
# these labels; a change that alters the reads on purpose updates the literals.
BOOKED = {
    "kitti/associate": (8, 0, 3616, 0),
    "kitti/detect_lines": (8, 0, 0, 0),
    "kitti/lbd": (8, 0, 0, 0),
    "kitti/proposals": (8, 0, 0, 0),
    "kitti/step": (8, 0, 0, 0),
    "lines/hough": (8, 0, 0, 0),
    "lines/merge": (8, 18, 0, 18),
    "lines/runs": (8, 0, 0, 0),
    "other": (0, 17, 616216, 34880),
    "proposals/canny": (8, 41, 0, 41),
    "proposals/edt": (8, 0, 0, 0),
    "proposals/grid": (16, 0, 0, 0),
    "proposals/merge": (8, 12, 0, 12),
    "proposals/rank": (8, 0, 0, 0),
    "proposals/score": (8, 0, 0, 0),
}


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return write_drive(tmp_path_factory.mktemp("kitti") / "seq")


@pytest.fixture(scope="module")
def port(drive):
    return port_run_booked(drive, "lines")


@pytest.mark.parametrize("mode", ["lines"])
def test_run_kitti_slam_matches_jax_f64(drive, port, mode):
    check_mode_f64(drive, mode, port=port[0])


def test_drive_books_the_same_stages_reads_and_bytes(port):
    assert port[1] == BOOKED
