"""Port parity: the functions of the fixed-lag smoother (slam/window.py)
against the JAX package, on the random graph of test_torch_backend.py through
both packages.  (The step built from them is in test_torch_windowed_step.py.)

Tolerances: float64 1e-8 absolute on residuals and on the prior's blocks;
float32 1e-4 on residuals and 1e-4 relative on the prior's blocks (against
each block's own scale).
"""

import numpy as np
import pytest
import torch

from torch_parity import DTYPES, assert_tree_close, jax_tree_to_numpy, to_j, to_np, to_t, tree_np
from torch_window_parity import (
    absorb_args, jcuboid, jprior, prior_tree_from_graph, tcuboid, tprior,
)

import jax.numpy as jnp

from test_torch_backend import GRAPH, _graphs
from cube_slam_wu_tpu.slam import window as jwindow
from cube_slam_wu_tpu_torch.slam import ba as tba
from cube_slam_wu_tpu_torch.slam import window as twindow

PRIOR = prior_tree_from_graph(GRAPH)


def assert_prior_close(jp, tp, dt, rel32=1e-4):
    """Prior blocks: absolute 1e-8 in float64; in float32 relative `rel32` of
    each block's own largest entry."""
    jt, tt = jax_tree_to_numpy(jp), tree_np(tp)
    np.testing.assert_array_equal(jt["valid"], tt["valid"])
    assert_tree_close(jt["lin"], tt["lin"], atol=1e-8 if dt == "f64" else 1e-5)
    for k in ("H", "b", "S", "c_vec"):
        a, b = jt[k], tt[k]
        assert np.isfinite(b).all(), k
        if dt == "f64":
            np.testing.assert_allclose(a, b, atol=1e-8, rtol=1e-9, err_msg=k)
        else:
            scale = np.abs(a).reshape(a.shape[0], -1).max(axis=1)
            scale = scale.reshape((-1,) + (1,) * (a.ndim - 1))
            assert np.all(np.abs(a - b) <= rel32 * scale + 1e-7), (k, np.abs(a - b).max())


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_prior_residuals(dt):
    jd, td, nd = DTYPES[dt]
    rng = np.random.default_rng(2)
    cube = jax_tree_to_numpy(
        jcuboid(GRAPH["cube"], jnp.float64).exp_update(to_j(rng.normal(0, 0.05, (2, 9))))
    )
    jr = jwindow.prior_residuals(jprior(PRIOR, jd), jcuboid(cube, jd))
    tr = twindow.prior_residuals(tprior(PRIOR, td), tcuboid(cube, td))
    assert np.abs(to_np(tr)).max() > 1e-3
    np.testing.assert_allclose(to_np(jr), to_np(tr), atol=1e-8 if dt == "f64" else 1e-4)
    # an object the prior does not hold has zero rows
    tp = tprior(PRIOR, td)._replace(valid=torch.tensor([True, False]))
    assert float(twindow.prior_residuals(tp, tcuboid(cube, td))[1].abs().max()) == 0.0


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_absorb_frame_first_and_repeated(dt):
    """First absorption into an empty prior (the landmark estimate becomes
    the linearisation point), then a second frame onto it (the point stays)."""
    jargs, targs = absorb_args(GRAPH, 0, dt)
    jp1 = jwindow.absorb_frame(*jargs)
    tp1 = twindow.absorb_frame(*targs)
    assert to_np(tp1.valid).any()
    assert_prior_close(jp1, tp1, dt)
    # the second absorption sees moved landmark estimates and keeps `lin`
    moved = jax_tree_to_numpy(
        jcuboid(GRAPH["cube"], jnp.float64).exp_update(jnp.full((2, 9), 0.01))
    )
    p1 = jax_tree_to_numpy(jp1)
    jargs, targs = absorb_args(GRAPH, 1, dt, prior_tree=p1, cube_tree=moved)
    jp2 = jwindow.absorb_frame(*jargs)
    tp2 = twindow.absorb_frame(*targs)
    assert_prior_close(jp2, tp2, dt)
    both = to_np(tp1.valid) & GRAPH["cube_meas_mask"][1]
    assert both.any()
    np.testing.assert_array_equal(to_np(tp2.lin.scale)[both], to_np(tp1.lin.scale)[both])
    assert float((tp2.H - tp1.H).abs().max()) > 0


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_absorb_frame_gated_and_capped(dt):
    """An edge whose innovation is above the gate is not absorbed, and an
    edge whose Jacobian is above sqrt(info_cap) is shrunk to the cap.

    The capped edge is also the float32 corner of the Cholesky: H's diagonal
    reaches info_cap = 1e4, where the 1e-9 regulariser is far below one ulp
    (about 1e-3), so H + 1e-9*I == H in float32.  The factor exists all the
    same, in both packages, because H = J^T J of a full-rank 9x9 J is positive
    definite by itself; the regulariser only matters for objects whose H is
    all zero (L = sqrt(1e-9)*I there, and S is zeroed by `valid`)."""
    jd, td, _ = DTYPES[dt]
    tree = {k: v for k, v in GRAPH.items()}
    w = GRAPH["cube_meas_weight"].copy()
    w[0, 0] = 300.0  # |J| ~ weight: above sqrt(1e4), capped
    tree["cube_meas_weight"] = w
    meas = {"pose": {k: v.copy() for k, v in GRAPH["cube_meas"]["pose"].items()},
            "scale": GRAPH["cube_meas"]["scale"].copy()}
    meas["pose"]["trans"][0, 1] += 5.0  # innovation ~5 m: above the gate of 3
    tree["cube_meas"] = meas
    mask = GRAPH["cube_meas_mask"].copy()
    mask[0] = True
    tree["cube_meas_mask"] = mask
    jargs, targs = absorb_args(tree, 0, dt)
    jp = jwindow.absorb_frame(*jargs)
    tp = twindow.absorb_frame(*targs)
    np.testing.assert_array_equal(to_np(tp.valid), [True, False])
    assert_prior_close(jp, tp, dt)
    diag = to_np(torch.diagonal(tp.H[0]))
    assert 0.5e4 < diag.max() <= 9.0e4 + 1, diag  # at most 9 rows of cap each
    assert float(tp.H[1].abs().max()) == 0.0 and float(tp.S[1].abs().max()) == 0.0
    # S^T S = H + 1e-9 I and S^T c = b on the absorbed object
    S, H = tp.S[0].double(), tp.H[0].double()
    np.testing.assert_allclose(to_np(S.T @ S), to_np(H), rtol=1e-9 if dt == "f64" else 1e-5,
                               atol=1e-6 if dt == "f64" else 1e-1)
    # a smaller cap shrinks harder
    tp_small = twindow.absorb_frame(*targs, info_cap=1.0)
    assert float(torch.diagonal(tp_small.H[0]).max()) <= 9.0 + 1e-3


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_window_slice_and_scatter(dt):
    jg, tg = _graphs(GRAPH, dt)
    start, W = 2, 4
    jw = jwindow.window_slice(jg, start, W)
    tw = twindow.window_slice(tg, start, W)
    assert tw.capacity == W and not bool(tw.odom_mask[0]) and bool(tg.odom_mask[start])
    assert_tree_close(jax_tree_to_numpy(jw), tree_np(tw), atol=0.0)
    # scatter other poses back
    jd, td, nd = DTYPES[dt]
    delta = np.random.default_rng(4).normal(0, 0.1, (W, 6)).astype(nd)
    from cube_slam_wu_tpu.core.se3 import SE3 as JSE3
    from cube_slam_wu_tpu_torch.core.se3 import SE3 as TSE3
    jcam = JSE3.exp(jnp.asarray(delta)).compose(jw.cam_Tcw)
    tcam = TSE3.exp(torch.from_numpy(delta)).compose(tw.cam_Tcw)
    js = jwindow.window_scatter(jg, jcam, start)
    ts = twindow.window_scatter(tg, tcam, start)
    assert_tree_close(jax_tree_to_numpy(js), tree_np(ts), atol=1e-12 if dt == "f64" else 1e-6)
    np.testing.assert_array_equal(to_np(ts.cam_Tcw.trans[:start]), to_np(tg.cam_Tcw.trans[:start]))
    np.testing.assert_array_equal(to_np(ts.cam_Tcw.trans[start + W :]), to_np(tg.cam_Tcw.trans[start + W :]))
    np.testing.assert_array_equal(to_np(ts.cam_Tcw.quat[start : start + W]), to_np(tcam.quat))


def test_window_slice_does_not_alias_the_full_graph():
    """A slice of a tensor is a view: clearing the window's first odometry
    edge, optimising the window and scattering back must leave every tensor
    of the full graph bit-identical."""
    _, tg = _graphs(GRAPH, "f64")
    before = tree_np(tg)  # numpy copies
    win = twindow.window_slice(tg, 2, 4)
    res = tba.optimize(win, iterations=2, prior=tprior(PRIOR, torch.float64))
    out = twindow.window_scatter(tg, res.cam_Tcw, 2)
    assert_tree_close(before, tree_np(tg), atol=0.0)
    assert before["odom_mask"][2] and bool(tg.odom_mask[2])
    # the result differs from the input only in the window's poses
    after = tree_np(out)
    assert np.abs(after["cam_Tcw"]["trans"][2:6] - before["cam_Tcw"]["trans"][2:6]).max() > 0
    after["cam_Tcw"], b2 = None, dict(before, cam_Tcw=None)
    assert_tree_close(b2, after, atol=0.0)
    # even a write into the window's mask does not reach the graph
    w2 = twindow.window_slice(tg, 0, 4)
    w2.odom_mask[1] = False
    assert bool(tg.odom_mask[1]), "window.odom_mask must own its memory"
