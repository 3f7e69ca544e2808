"""Port parity: slam/propagate.py (spanning-tree initial-estimate
propagation) against the JAX package on the random graph of
test_torch_backend.py with its estimates wiped.

Tolerances: path costs exact; propagated poses and landmarks 1e-9 absolute
in float64 and 1e-4 in float32 (chains of up to 7 SE3 composes).
"""

import numpy as np
import pytest
import torch

from torch_parity import DTYPES, assert_tree_close, jax_tree_to_numpy, to_j, to_np, to_t, tree_np

from test_torch_backend import GRAPH, _graphs
from cube_slam_wu_tpu.slam import propagate as jprop
from cube_slam_wu_tpu_torch.slam import propagate as tprop


def _wiped(tree, break_odom_at=None, drop_meas=()):
    """The graph with every estimate but frame 0's reset to identity / zero,
    optionally with one odometry edge cut and some measurements dropped."""
    t = {k: v for k, v in tree.items()}
    cam = {k: v.copy() for k, v in tree["cam_Tcw"].items()}
    cam["quat"][1:] = [1.0, 0, 0, 0]
    cam["trans"][1:] = 0.0
    t["cam_Tcw"] = cam
    t["cube"] = {
        "pose": {"quat": np.tile([1.0, 0, 0, 0], (2, 1)), "trans": np.zeros((2, 3))},
        "scale": np.zeros((2, 3)),
    }
    t["cube_valid"] = np.zeros(2, bool)
    if break_odom_at is not None:
        om = tree["odom_mask"].copy()
        om[break_odom_at] = False
        t["odom_mask"] = om
    if drop_meas:
        mm = tree["cube_meas_mask"].copy()
        for f, o in drop_meas:
            mm[f, o] = False
        t["cube_meas_mask"] = mm
    return t


def _compare(tree, dt, **kw):
    jg, tg = _graphs(tree, dt)
    jkw, tkw = dict(kw), dict(kw)
    if "fixed_frames" in kw:
        jkw["fixed_frames"] = to_j(kw["fixed_frames"])
        tkw["fixed_frames"] = to_t(kw["fixed_frames"])
    jr = jprop.propagate_estimates(jg, **jkw)
    tr = tprop.propagate_estimates(tg, **tkw)
    np.testing.assert_array_equal(to_np(jr.frame_dist), to_np(tr.frame_dist))
    np.testing.assert_array_equal(to_np(jr.cube_dist), to_np(tr.cube_dist))
    assert_tree_close(
        jax_tree_to_numpy(jr.graph), tree_np(tr.graph), atol=1e-9 if dt == "f64" else 1e-4
    )
    return tr


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_propagate_along_odometry(dt):
    tr = _compare(_wiped(GRAPH), dt)
    dist = to_np(tr.frame_dist)
    np.testing.assert_array_equal(dist[:6], np.arange(6))
    assert np.isinf(dist[6:]).all(), "inactive slots stay unreached"
    assert np.isfinite(to_np(tr.cube_dist)).all()
    # the propagated poses are the odometry chain from frame 0: the composed
    # measurement error is a few centimetres
    truth = GRAPH["cam_Tcw"]["trans"][:6]
    assert np.abs(to_np(tr.graph.cam_Tcw.trans)[:6] - truth).max() < 0.2
    assert to_np(tr.graph.cam_Tcw.trans)[1:6].any()


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_propagate_bridges_an_odometry_break_through_a_landmark(dt):
    """With the edge 2 -> 3 cut, frames 3.. are reached by hopping over a
    cuboid: frame -> object -> frame, at two landmark costs."""
    F = GRAPH["frame_mask"].shape[0]
    tr = _compare(_wiped(GRAPH, break_odom_at=3), dt)
    dist = to_np(tr.frame_dist)
    cube_cost = F * 1.0 + 1.0
    assert dist[2] == 2.0 and dist[3] >= 2 * cube_cost
    assert np.isfinite(dist[:6]).all()


def test_propagate_options_f64():
    fixed = np.zeros(8, bool)
    fixed[4] = True
    tr = _compare(_wiped(GRAPH), "f64", fixed_frames=fixed, odom_cost=2.0, cube_cost=0.5, rounds=3)
    dist = to_np(tr.frame_dist)
    assert dist[4] == 0.0 and dist[3] > 0 and dist[5] > 0
    # too few rounds leave far frames unreached by odometry alone
    tr1 = _compare(_wiped(GRAPH, drop_meas=[(f, o) for f in range(8) for o in range(2)]),
                   "f64", rounds=2)
    assert np.isinf(to_np(tr1.frame_dist)[3:]).all() and np.isinf(to_np(tr1.cube_dist)).all()


def test_propagate_result_is_a_new_graph():
    _, tg = _graphs(_wiped(GRAPH), "f64")
    before = tree_np(tg)
    tprop.propagate_estimates(tg)
    assert_tree_close(before, tree_np(tg), atol=0.0)
