"""Port parity: the bundle adjuster with the fixed-lag prior (its rows in
the residual vector, LM with it) and the marginal covariances, against the
JAX package on the random graph of torch_window_parity.py.

Tolerances: float64 1e-8 absolute on residuals, 1e-6 on poses after a run,
1e-8 relative on covariance blocks against their own scale; float32 2e-4 on
residuals, 1e-3 on poses after a run, 1e-4 relative on covariance blocks.
"""

import numpy as np
import pytest
import torch

import jax_runs
from torch_parity import DTYPES, to_np
from torch_window_parity import graph, graphs, jprior, prior, tprior

import jax.numpy as jnp

from test_torch_ba_options import assert_results_agree
from cube_slam_wu_tpu.slam import ba as jba
from cube_slam_wu_tpu_torch.slam import ba as tba

@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_residual_vector_huber_and_prior(dt):
    """The stacked residual vector at a non-zero increment, with the Huber
    kernel on and the prior's rows appended (never Huber-scaled)."""
    jd, td, nd = DTYPES[dt]
    jg, tg = graphs(graph(), dt)
    n = jg.capacity * 6 + jg.n_objects * 9
    dx = np.random.default_rng(3).normal(0, 0.02, n).astype(nd)
    jr = jax_runs.run(f"ba_prior_residuals_{dt}", lambda: jba._residual_vector(
        jg, jnp.asarray(dx), True, 0.3, jprior(prior(), jd)))
    tr = tba._residual_vector(tg, torch.from_numpy(dx), True, None, 0.3, tprior(prior(), td))
    plain = tba._residual_vector(tg, torch.from_numpy(dx), True)
    assert tr.shape[0] == plain.shape[0] + 9 * jg.n_objects
    assert float((tr[: plain.shape[0]] - plain).abs().max()) > 1e-3, "Huber must bite"
    assert float(tr[plain.shape[0] :].abs().max()) > 0
    np.testing.assert_allclose(to_np(jr), to_np(tr), atol=1e-8 if dt == "f64" else 2e-4)


@pytest.mark.parametrize("dt,iters", [("f64", 3), ("f32", 2)])
def test_optimize_with_prior(dt, iters):
    """LM with the fixed-lag prior: its rows are in H, so lambda_0 (seeded from
    max diag H) and with it `lambda_final` see the prior.  The iteration
    counts stop short of convergence: once chi2 moves by rounding only, the
    gain ratio that steers lambda is noise in both packages."""
    jd, td, _ = DTYPES[dt]
    jg, tg = graphs(graph(), dt)
    jr = jax_runs.run(f"ba_prior_lm_{dt}_{iters}",
                      lambda: jba.optimize(jg, iterations=iters, prior=jprior(prior(), jd)))
    tr = tba.optimize(tg, iterations=iters, prior=tprior(prior(), td))
    assert_results_agree(jr, tr, dt)
    no_prior = tba.optimize(tg, iterations=iters)
    assert float((tr.cube.pose.trans - no_prior.cube.pose.trans).abs().max()) > 1e-6


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_marginal_covariance(dt):
    jg, tg = graphs(graph(), dt)
    jm = jax_runs.run(f"ba_marginals_{dt}", lambda: jba.marginal_covariance(jg))
    tm = tba.marginal_covariance(tg)
    np.testing.assert_array_equal(to_np(jm.cam_valid), to_np(tm.cam_valid))
    np.testing.assert_array_equal(to_np(jm.cube_valid), to_np(tm.cube_valid))
    assert not to_np(tm.cam_valid)[0] and to_np(tm.cam_valid)[1:6].all()
    rel = 1e-8 if dt == "f64" else 1e-4
    for a, b in ((jm.cam, tm.cam), (jm.cube, tm.cube)):
        a, b = to_np(a), to_np(b)
        scale = np.abs(a).max(axis=(-2, -1), keepdims=True)
        assert np.all(np.abs(a - b) <= rel * scale), np.abs(a - b).max()
        assert np.abs(b).max() > 0
    # inactive blocks are reported as zero
    assert float(tm.cam[0].abs().max()) == 0.0 and float(tm.cam[7].abs().max()) == 0.0


def test_marginal_covariance_with_huber_f64():
    jg, tg = graphs(graph(), "f64")
    jm = jax_runs.run("ba_marginals_huber_f64",
                      lambda: jba.marginal_covariance(jg, robust_delta=0.3))
    tm = tba.marginal_covariance(tg, robust_delta=0.3)
    np.testing.assert_allclose(to_np(jm.cube), to_np(tm.cube), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(to_np(jm.cam), to_np(tm.cam), rtol=1e-6, atol=1e-12)
