"""ATE of the JAX package's KITTI driver, on the CPU, on the synthetic world
that chip_smoke.py drives the port's KITTI path on.  Quality, not time: it
gives the bound that chip_smoke.py holds the port's KITTI ATE to.

    JAX_PLATFORMS=cpu python tests/reference_ate_jax_kitti.py [n_frames] [f32|f64]

The world is the one of artifacts/kitti_synth_300 at KITTI's frame size
(375x1242, 6 objects, seed 4), written in the KITTI odometry layout and run
through `run_kitti_slam(pose_feedback=True, window=16, point_weight=0.3,
n_points=96, max_objects=8, max_detections=4)`, the `cli kitti
--pose-feedback --point-weight 0.3` configuration.  Prints one JSON line with
the ATE (direct, unaligned RMSE against the world's own T_wc), the front-end
report, cube_valid and the last chi2.  Run it once per dtype: the gap between
the float32 and float64 figures measures how far a numeric perturbation moves
a single draw of this monocular benchmark.
"""

import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
F64 = len(sys.argv) > 2 and sys.argv[2] == "f64"
if F64:
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from cube_slam_wu_tpu.slam import pipeline  # noqa: E402
from cube_slam_wu_tpu.utils import synth  # noqa: E402
from cube_slam_wu_tpu.utils.metrics import ate_rmse  # noqa: E402

# the world and the driver settings of chip_smoke.py's kitti_path
WORLD = dict(n_objects=6, size=(375, 1242), speed=0.5, curve=0.002, noise_px=0.8,
             dropout=0.05, seed=4, ground_texture=4.0)
SETTINGS = dict(pose_feedback=True, window=16, point_weight=0.3, n_points=96,
                max_objects=8, max_detections=4)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    seq = synth.make_sequence(n_frames=n, **WORLD)
    with tempfile.TemporaryDirectory() as tmp:
        out, det_dir, poses_path = synth.write_kitti_sequence(seq, os.path.join(tmp, "seq"))
        t0 = time.perf_counter()
        res = pipeline.run_kitti_slam(
            out, det_dir, poses_path,
            dtype=jnp.float64 if F64 else jnp.float32, **SETTINGS,
        )
        seconds = time.perf_counter() - t0
    truth = seq.T_wc[:, :3, 3]
    rep = res.frontend_report
    print(json.dumps({
        "backend": "jax-cpu", "dtype": "f64" if F64 else "f32", "n_frames": n,
        "world": {k: list(v) if isinstance(v, tuple) else v for k, v in WORLD.items()},
        "settings": SETTINGS,
        "ate_m": ate_rmse(res.traj_Twc_xyzq[:n, :3], truth),
        "report": {"no_valid_proposal": len(rep.no_valid_proposal),
                   "empty_detections": len(rep.empty_detections),
                   "dropped": rep.dropped_detections, "far_spawns": rep.far_spawns,
                   "cap_overflow_frames": rep.cap_overflow_frames},
        "cube_valid": res.cube_valid.tolist(),
        "chi2_last": float(res.chi2[-1]),
        "seconds": seconds,
    }))


if __name__ == "__main__":
    main()
