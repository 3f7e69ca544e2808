"""Port parity: `cli kitti --device cpu --float64` writes the files the JAX
package's `cli kitti` writes, with the same numbers, on the short synthetic
drive of tests/kitti_parity.py.  The JAX command writes from the JAX
driver's committed two-phase run (`kitti_parity.jax_run_f64`,
`jax_driver_memo`), the port's command runs its driver.

Tolerances: 1e-5 on the written poses, 1e-4 on the cuboids and the ATE; the
front-end summary line exactly.
"""

import numpy as np
import pytest

from kitti_parity import COMMON, MODES, jax_run_f64, write_drive
from torch_parity import jax_driver_memo  # one intra-op thread


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return write_drive(tmp_path_factory.mktemp("kitti_cli") / "seq")


def test_cli_kitti_writes_the_jax_files(drive, tmp_path, capsys, monkeypatch):
    from cube_slam_wu_tpu import cli as jcli
    from cube_slam_wu_tpu_torch import cli as tcli

    seq_dir, det_dir, poses, _ = drive
    jax_driver_memo(monkeypatch, "run_kitti_slam", jax_run_f64(drive, "two_phase"),
                    seq_dir, det_dir, poses, **COMMON, **MODES["two_phase"])
    args = ["kitti", "--seq", str(seq_dir), "--detections", str(det_dir), "--poses", str(poses),
            "--window", "4", "--max-objects", "4", "--max-detections", "3",
            "--bbox-edge-weight", "0.005"]
    jcli.main(args + ["--out", str(tmp_path / "jax")])
    jout = capsys.readouterr().out
    tcli.main(args + ["--out", str(tmp_path / "port"), "--float64", "--device", "cpu"])
    tout = capsys.readouterr().out
    jfiles = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert jfiles == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert jfiles == ["output_cam_poses.txt", "output_obj_poses.txt", "trajectory_kitti.txt"]
    for name, tol in (("output_cam_poses.txt", 1e-5), ("trajectory_kitti.txt", 1e-5),
                      ("output_obj_poses.txt", 1e-4)):
        a = np.loadtxt(tmp_path / "jax" / name, ndmin=2)
        b = np.loadtxt(tmp_path / "port" / name, ndmin=2)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=tol, err_msg=name)
    line = lambda out, key: [ln for ln in out.splitlines() if ln.startswith(key)]
    assert line(jout, "frontend:") == line(tout, "frontend:")
    ate = lambda out: float(line(out, "ATE RMSE")[0].split(":")[1].split()[0])
    assert abs(ate(jout) - ate(tout)) < 1e-4
