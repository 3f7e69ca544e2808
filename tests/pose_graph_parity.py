"""The loop-closure problem of tests/test_pose_graph.py::
test_scale_drift_corrected_at_loop_closure, at any size, in numpy only:
chip_smoke.py builds the port's problem from it and
tests/reference_pose_graph_jax.py the JAX package's, from the same arrays.

A camera goes once around a circle of radius 10 m with n keyframes; the
front end's odometry keeps the true relative rotation but measures each
step's translation at a scale that drifts by `k` per step, believing scale
1; chained from the true first pose, the trajectory spirals.  The loop
edge last -> first carries the true relative similarity between the
drift-aware frames, scale ratio k^-(n-1) included.  The defaults are
chip_smoke.py's TUM-class loop: 256 keyframes and a per-step drift of
1.02 ** (39 / 255), so that the loop accumulates the test's 1.02 ** 39 =
2.16x.
"""

import numpy as np

N_KEYFRAMES = 256
DRIFT_PER_STEP = 1.02 ** (39 / 255)
RADIUS_M = 10.0


def _yaw_quat(a):
    """wxyz of a rotation by `a` about z, with w >= 0."""
    q = np.stack([np.cos(a / 2), np.zeros_like(a), np.zeros_like(a), np.sin(a / 2)], axis=-1)
    return np.where(q[..., :1] < 0, -q, q)


def _yaw_rot(a):
    c, s = np.cos(a), np.sin(a)
    R = np.zeros(a.shape + (3, 3))
    R[..., 0, 0], R[..., 0, 1], R[..., 1, 0], R[..., 1, 1], R[..., 2, 2] = c, -s, s, c, 1.0
    return R


def loop_problem(n=N_KEYFRAMES, k=DRIFT_PER_STEP):
    """dict of float64 arrays: `drift_quat` (n-1, 4) wxyz and `drift_trans`
    (n-1, 3), the drifted odometry S_{i+1,i} at believed scale 1; `start_quat`,
    `start_trans`, the true first pose T_0w; `loop_quat`, `loop_trans`,
    `loop_scale`, the loop measurement S_{0,n-1}; `true_centers` (n, 3), the
    true camera centres."""
    ang = 2.0 * np.pi * np.arange(n) / n
    yaw = ang + np.pi / 2
    centers = np.stack([RADIUS_M * np.cos(ang), RADIUS_M * np.sin(ang), np.zeros(n)], axis=-1)
    R = _yaw_rot(yaw)
    t = -np.einsum("nij,nj->ni", R, centers)  # T_iw: p_frame = R p_world + t
    # relative S_{i+1,i} = T_{i+1} T_i^-1: rotation by the yaw step
    R_rel = R[1:] @ np.swapaxes(R[:-1], -1, -2)
    t_rel = t[1:] - np.einsum("nij,nj->ni", R_rel, t[:-1])
    steps = np.arange(1, n)
    # the loop measurement between the drift-aware frames
    # S_i = (R_i, k^i t_i, k^i): S_0 S_{n-1}^-1 = (R_0 R_{n-1}^T,
    # t_0 - R_0 R_{n-1}^T t_{n-1}, k^-(n-1))
    s_last = k ** (n - 1)
    R_loop = R[0] @ R[-1].T
    t_loop = t[0] - R_loop @ t[-1]
    return {
        "drift_quat": _yaw_quat(yaw[1:] - yaw[:-1]),
        "drift_trans": t_rel * (k ** steps)[:, None],
        "start_quat": _yaw_quat(yaw[:1])[0],
        "start_trans": t[0],
        "loop_quat": _yaw_quat(np.asarray(yaw[0] - yaw[-1])),
        "loop_trans": t_loop,
        "loop_scale": np.asarray(1.0 / s_last),
        "true_centers": centers,
    }


def mean_center_error(centers, true_centers) -> float:
    return float(np.linalg.norm(np.asarray(centers) - true_centers, axis=-1).mean())
