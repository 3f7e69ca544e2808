"""The JAX package's loop-closure correction, on the CPU, on the problem that
chip_smoke.py's `pose_graph` phase solves with the port
(tests/pose_graph_parity.py: a circle of n keyframes whose odometry drifts in
scale, one Sim3 loop edge).  Quality, not time: it gives the mean
camera-centre error that chip_smoke.py holds the port's float64 result to.

    JAX_PLATFORMS=cpu python tests/reference_pose_graph_jax.py [n] [iterations]

Defaults: 256 keyframes, 25 iterations, float64.  Prints one JSON line: the
mean camera-centre error before and after, the final chi2 and lambda, and
the loop's optimised scale ratio against k^-(n-1).
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pose_graph_parity import DRIFT_PER_STEP, loop_problem, mean_center_error  # noqa: E402

from cube_slam_wu_tpu.core.se3 import SE3  # noqa: E402
from cube_slam_wu_tpu.core.sim3 import Sim3  # noqa: E402
from cube_slam_wu_tpu.slam import pose_graph as pg  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    iterations = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    k = DRIFT_PER_STEP
    p = {key: jnp.asarray(v) for key, v in loop_problem(n, k).items()}
    drift = Sim3(p["drift_quat"], p["drift_trans"], jnp.ones((n - 1,)))
    start = Sim3(p["start_quat"], p["start_trans"], jnp.ones(()))
    drifted = pg.chain_odometry(drift, start)
    loop = Sim3(p["loop_quat"], p["loop_trans"], p["loop_scale"])
    res = pg.correct_scale_drift(SE3(drifted.quat, drifted.trans), drifted.scale, n - 1, 0, loop,
                                 iterations=iterations)
    truth = np.asarray(p["true_centers"])
    rel = pg._take(res.poses, jnp.asarray([0])).compose(pg._take(res.poses, jnp.asarray([n - 1])).inverse())
    print(json.dumps({
        "n": n, "iterations": iterations, "drift_per_step": k, "dtype": "float64",
        "mean_center_error_before_m": mean_center_error(drifted.inverse().trans, truth),
        "mean_center_error_after_m": mean_center_error(res.poses.inverse().trans, truth),
        "chi2": float(res.chi2), "lambda_final": float(res.lambda_final),
        "loop_scale_ratio": float(rel.scale[0]), "loop_scale_target": k ** -(n - 1),
        "jax": jax.__version__,
    }))


if __name__ == "__main__":
    main()
