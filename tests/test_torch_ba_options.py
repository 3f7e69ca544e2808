"""Port parity: the step rules of the bundle adjuster (slam/ba.py) beyond
plain Levenberg-Marquardt — the Huber kernel, Gauss-Newton, Powell's dogleg —
against the JAX package on the random graph of test_torch_backend.py.  (The
prior and the marginal covariances are in test_torch_ba_prior.py, the hard
innovation gate in test_torch_tracker.py.)

Tolerances: float64 1e-6 on poses after a run and 1e-6 relative on chi2 and
on the damping or radius; float32 1e-3 on poses after a run (five solves of a
float32 system with a different LU each) and 5e-3 relative on the scalars.
"""

import numpy as np
import pytest

from torch_parity import assert_tree_close, to_np, tree_np

from test_torch_backend import GRAPH, _graphs
from cube_slam_wu_tpu.slam import ba as jba
from cube_slam_wu_tpu_torch.slam import ba as tba


def assert_results_agree(jr, tr, dt):
    pose_tol = 1e-6 if dt == "f64" else 1e-3
    rel = 1e-6 if dt == "f64" else 5e-3
    assert_tree_close(tree_np(jr.cam_Tcw), tree_np(tr.cam_Tcw), atol=pose_tol)
    assert_tree_close(tree_np(jr.cube), tree_np(tr.cube), atol=pose_tol)
    np.testing.assert_allclose(float(jr.chi2), float(tr.chi2), rtol=rel)
    np.testing.assert_allclose(float(jr.lambda_final), float(tr.lambda_final), rtol=rel, atol=1e-12)
    assert np.isfinite(to_np(tr.cam_Tcw.trans)).all()


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_optimize_huber(dt):
    jg, tg = _graphs(GRAPH, dt)
    jr = jba.optimize(jg, iterations=5, robust_delta=0.3)
    tr = tba.optimize(tg, iterations=5, robust_delta=0.3)
    assert_results_agree(jr, tr, dt)
    plain = tba.optimize(tg, iterations=5)
    assert abs(float(tr.chi2) - float(plain.chi2)) > 1e-7, "the Huber kernel must bite"


@pytest.mark.parametrize("dt", ["f64"])
def test_optimize_gauss_newton(dt):
    jg, tg = _graphs(GRAPH, dt)
    jr = jba.optimize(jg, iterations=4, algorithm="gn")
    tr = tba.optimize(tg, iterations=4, algorithm="gn")
    assert_results_agree(jr, tr, dt)
    assert float(tr.lambda_final) == 0.0


@pytest.mark.parametrize("dt,iters", [("f64", 5), ("f32", 5)])
def test_optimize_dogleg(dt, iters):
    """`lambda_final` is the final trust radius (it starts at 1e4 and grows or
    shrinks by the gain ratio)."""
    jg, tg = _graphs(GRAPH, dt)
    jr = jba.optimize(jg, iterations=iters, algorithm="dogleg")
    tr = tba.optimize(tg, iterations=iters, algorithm="dogleg")
    assert_results_agree(jr, tr, dt)
    assert float(tr.lambda_final) > 0


def test_dogleg_small_radius_branches_f64():
    """Dogleg's three step choices: with the graph's estimates far off the
    first steps leave the Gauss-Newton branch (the radius shrinks below its
    start), and the port still follows the JAX package."""
    rng = np.random.default_rng(7)
    tree = {k: v for k, v in GRAPH.items()}
    cam = {k: v.copy() for k, v in GRAPH["cam_Tcw"].items()}
    cam["trans"] = cam["trans"] + rng.normal(0, 1.5, cam["trans"].shape)
    tree["cam_Tcw"] = cam
    jg, tg = _graphs(tree, "f64")
    radii = []
    for iters in (2, 6):
        jr = jba.optimize(jg, iterations=iters, algorithm="dogleg")
        tr = tba.optimize(tg, iterations=iters, algorithm="dogleg")
        np.testing.assert_allclose(float(jr.lambda_final), float(tr.lambda_final), rtol=1e-6)
        np.testing.assert_allclose(float(jr.chi2), float(tr.chi2), rtol=1e-6)
        radii.append(float(tr.lambda_final))
    assert min(radii) < 1e4, f"the radius never shrank: {radii}"


def test_unknown_algorithm_still_value_error():
    _, tg = _graphs(GRAPH, "f64")
    with pytest.raises(ValueError, match="unknown algorithm"):
        tba.optimize(tg, algorithm="newton")
