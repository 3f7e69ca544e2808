"""Port parity: the joint camera-object-point bundle adjuster
(slam/point_ba.py) against the JAX package, on the random graph of
test_torch_backend.py with point landmarks seen by its cameras.

The port writes the per-observation Jacobians out in closed form where the
JAX package takes `jax.jacfwd` of the single-observation residual; the two
are compared directly, then through whole LM runs with the Schur reduction
(here with stereo rows and with `fix_first=False`; with the robust kernels and
the prior in test_torch_point_ba_optimize.py, in float32 in
test_torch_point_ba_f32.py).

Tolerances: float64 1e-9 on projections and Jacobians, 1e-7 on poses and
points after a run and 1e-7 relative on chi2 and lambda; float32 1e-3 px /
1e-3 on Jacobians (pixel-scale values), 2e-3 on poses, 2e-2 on points after
a run (five solves of a float32 system with a different LU each), 5e-3
relative on chi2.
"""

import numpy as np
import pytest
import torch

from torch_parity import DTYPES, assert_tree_close, to_j, to_np, to_t, tree_np

import jax
import jax.numpy as jnp

from test_torch_backend import GRAPH, _graphs
from cube_slam_wu_tpu.core.se3 import SE3 as JSE3
from cube_slam_wu_tpu.slam import point_ba as jpb
from cube_slam_wu_tpu_torch.core.se3 import SE3 as TSE3
from cube_slam_wu_tpu_torch.slam import point_ba as tpb

P = 24


def _points_np(rng, graph=GRAPH, n=P, dropout=0.2, noise_px=0.5):
    """World points ahead of the cameras, their noisy projections in every
    active frame (some dropped), and perturbed initial estimates."""
    F = graph["frame_mask"].shape[0]
    X = np.column_stack([rng.uniform(-3, 3, n), rng.uniform(3, 12, n), rng.uniform(0, 2.5, n)])
    jT = JSE3(jnp.asarray(graph["cam_Tcw"]["quat"]), jnp.asarray(graph["cam_Tcw"]["trans"]))
    K = jnp.asarray(graph["K"])
    uv = np.asarray(jax.vmap(lambda T: jax.vmap(lambda x: jpb.project_point(T, x, K))(jnp.asarray(X)))(jT))
    uv = uv + rng.normal(0, noise_px, uv.shape)
    mask = (rng.uniform(size=(F, n)) > dropout) & graph["frame_mask"][:, None]
    X0 = X + rng.normal(0, 0.1, X.shape)
    ur = uv[..., 0] - 40.0 / np.maximum(X[None, :, 1], 1.0) + rng.normal(0, 0.3, (F, n))
    return dict(points=X0, point_mask=np.ones(n, bool), obs_uv=uv, obs_mask=mask,
                obs_weight=np.full((F, n), 0.3), obs_ur=ur)


PTS = _points_np(np.random.default_rng(1))


def _factors(tree, dt, stereo=False):
    jd, td, _ = DTYPES[dt]
    keys = ("points", "point_mask", "obs_uv", "obs_mask", "obs_weight")
    cast_j = lambda a: to_j(a, jd) if np.asarray(a).dtype.kind == "f" else to_j(a)
    cast_t = lambda a: to_t(a, td) if np.asarray(a).dtype.kind == "f" else to_t(a)
    extra_j, extra_t = {}, {}
    if stereo:
        extra_j = dict(obs_ur=cast_j(tree["obs_ur"]), baseline=40.0)
        extra_t = dict(obs_ur=cast_t(tree["obs_ur"]), baseline=40.0)
    return (
        jpb.PointFactors(*(cast_j(tree[k]) for k in keys), **extra_j),
        tpb.PointFactors(*(cast_t(tree[k]) for k in keys), **extra_t),
    )


@pytest.mark.parametrize("dt,tol", [("f64", 1e-9), ("f32", 1e-3)])
def test_project_point_and_stereo(dt, tol):
    jg, tg = _graphs(GRAPH, dt)
    jd, td, _ = DTYPES[dt]
    X = PTS["points"]
    jp = jax.vmap(lambda T: jpb.project_point(T, to_j(X, jd), jg.K))(jg.cam_Tcw)
    tp = tpb.project_point(tg.cam_Tcw[:, None], to_t(X, td)[None], tg.K)
    np.testing.assert_allclose(to_np(jp), to_np(tp), atol=tol, rtol=tol)
    js = jax.vmap(lambda T: jpb.project_point_stereo(T, to_j(X, jd), jg.K, 40.0))(jg.cam_Tcw)
    ts = tpb.project_point_stereo(tg.cam_Tcw[:, None], to_t(X, td)[None], tg.K, 40.0)
    np.testing.assert_allclose(to_np(js), to_np(ts), atol=tol, rtol=tol)
    assert to_np(ts).shape == (GRAPH["frame_mask"].shape[0], P, 3)


@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("dt,tol", [("f64", 1e-9), ("f32", 2e-3)])
def test_obs_jacobians_match_jacfwd(dt, tol, stereo):
    """The closed-form (F, P) Jacobians against `jax.jacfwd` of JAX's
    `_obs_residual[_stereo]` at zero increments, observation by observation,
    and (float64) against the port's own residual function differentiated by
    `torch.func.jacfwd`."""
    jg, tg = _graphs(GRAPH, dt)
    jd, td, _ = DTYPES[dt]
    X = PTS["points"]
    F = GRAPH["frame_mask"].shape[0]
    uv, ur = PTS["obs_uv"], PTS["obs_ur"]
    z6, z3 = jnp.zeros(6, jd), jnp.zeros(3, jd)

    def jres(T, x, o, r):
        if stereo:
            obs = jnp.concatenate([o, r[None]])
            return lambda dp, dx: jpb._obs_residual_stereo(dp, dx, T, x, obs, jg.K, 40.0)
        return lambda dp, dx: jpb._obs_residual(dp, dx, T, x, o, jg.K)

    def per(T, x, o, r):
        f = jres(T, x, o, r)
        return f(z6, z3), jax.jacfwd(lambda d: f(d, z3))(z6), jax.jacfwd(lambda d: f(z6, d))(z3)

    jr, jA, jB = jax.jit(jax.vmap(
        lambda T, o, r: jax.vmap(per, in_axes=(None, 0, 0, 0))(T, to_j(X, jd), o, r)
    ))(jg.cam_Tcw, to_j(uv, jd), to_j(ur, jd))
    pred, tA, tB = tpb._obs_jacobians(tg.cam_Tcw, to_t(X, td), tg.K, 40.0 if stereo else None)
    obs = to_t(np.concatenate([uv, ur[..., None]], -1) if stereo else uv, td)
    np.testing.assert_allclose(to_np(jr), to_np(obs - pred), atol=tol * 10, rtol=tol)
    scale = 1.0 if dt == "f64" else float(np.abs(to_np(jA)).max())
    np.testing.assert_allclose(to_np(jA), to_np(tA), atol=tol * scale, rtol=tol)
    np.testing.assert_allclose(to_np(jB), to_np(tB), atol=tol * scale, rtol=tol)
    if dt != "f64":
        return
    # the port's residual through torch.func.jacfwd, one observation
    f, p = 3, 5
    o = obs[f, p]
    T = tg.cam_Tcw[f]
    fn = (lambda dp: tpb._obs_residual_stereo(dp, torch.zeros(3, dtype=td), T, to_t(X[p], td), o, tg.K, 40.0)) \
        if stereo else (lambda dp: tpb._obs_residual(dp, torch.zeros(3, dtype=td), T, to_t(X[p], td), o, tg.K))
    A1 = torch.func.jacfwd(fn)(torch.zeros(6, dtype=td))
    np.testing.assert_allclose(to_np(A1), to_np(tA[f, p]), atol=tol * scale, rtol=tol)
    assert F == tA.shape[0]


def test_huber_jacobian_matches_autodiff_f64():
    """d/dr of the Huber scaling, both branches, against torch.func.jacfwd."""
    from cube_slam_wu_tpu_torch.slam.ba import _huber_scale

    r = torch.tensor([[0.3, -0.2], [4.0, 3.0], [1e-3, 2.0]], dtype=torch.float64)
    J = tpb._huber_jacobian(r, 1.5)
    for k in range(3):
        Jk = torch.func.jacfwd(lambda x: _huber_scale(x, 1.5))(r[k])
        np.testing.assert_allclose(to_np(J[k]), to_np(Jk), atol=1e-12)


@pytest.mark.parametrize("dt,tol", [("f64", 1e-9), ("f32", 5e-2)])
def test_triangulate_points(dt, tol):
    """DLT at the graph's poses from clean projections: same points and
    validity as JAX (float32 builds the 4x4 normal matrix from pixel-scale
    rows, hence the loose tolerance)."""
    jg, tg = _graphs(GRAPH, dt)
    jd, td, _ = DTYPES[dt]
    X = PTS["points"]
    uv = np.asarray(jax.vmap(lambda T: jax.vmap(lambda x: jpb.project_point(T, x, jg.K))(to_j(X, jd)))(jg.cam_Tcw))
    mask = PTS["obs_mask"].copy()
    mask[:, 0] = False  # no observation
    mask[:, 1] = False
    mask[2, 1] = True  # a single observation
    jX, jok = jpb.triangulate_points(jg.cam_Tcw, to_j(uv, jd), to_j(mask), jg.K)
    tX, tok = tpb.triangulate_points(tg.cam_Tcw, to_t(uv, td), to_t(mask), tg.K)
    np.testing.assert_array_equal(to_np(jok), to_np(tok))
    ok = to_np(tok)
    assert not ok[0] and not ok[1] and ok[2:].all()
    np.testing.assert_allclose(to_np(jX)[ok], to_np(tX)[ok], atol=tol, rtol=tol)
    np.testing.assert_allclose(to_np(tX)[ok], X[ok], atol=1e-6 if dt == "f64" else 0.2)


def check_optimize(dt, opts):
    """Five LM iterations over cameras + cuboids + points (with the point
    Huber kernel, the graph's Huber kernel and the fixed-lag prior; plain
    with stereo rows; float32): chi2, lambda, poses, cuboids and points."""
    opts = dict(opts)
    stereo = opts.pop("stereo", False)
    use_prior = opts.pop("prior", False)
    jg, tg = _graphs(GRAPH, dt)
    jf, tf = _factors(PTS, dt, stereo=stereo)
    jprior = tprior = None
    if use_prior:
        from torch_window_parity import jprior as mk_jprior, prior_tree_from_graph, tprior as mk_tprior

        tree = prior_tree_from_graph(GRAPH)
        jd, td, _ = DTYPES[dt]
        jprior, tprior = mk_jprior(tree, jd), mk_tprior(tree, td)
    jr = jpb.optimize(jg, jf, jg.K, iterations=5, prior=jprior, **opts)
    tr = tpb.optimize(tg, tf, tg.K, iterations=5, prior=tprior, **opts)
    f64 = dt == "f64"
    rel = 1e-7 if f64 else 5e-3
    np.testing.assert_allclose(float(jr.chi2), float(tr.chi2), rtol=rel)
    np.testing.assert_allclose(float(jr.lambda_final), float(tr.lambda_final), rtol=rel if f64 else 5e-2)
    assert_tree_close(tree_np(jr.cam_Tcw), tree_np(tr.cam_Tcw), atol=1e-7 if f64 else 2e-3)
    assert_tree_close(tree_np(jr.cube), tree_np(tr.cube), atol=1e-7 if f64 else 2e-3)
    np.testing.assert_allclose(to_np(jr.points), to_np(tr.points), atol=1e-7 if f64 else 2e-2)
    # the run did something: chi2 fell and the points moved
    assert float(tr.chi2) < float(tpb.optimize(tg, tf, tg.K, iterations=0, prior=tprior, **opts).chi2)
    assert np.abs(to_np(tr.points) - PTS["points"]).max() > 1e-3


@pytest.mark.parametrize("dt,opts", [("f64", {"stereo": True})])
def test_optimize(dt, opts):
    check_optimize(dt, opts)


def test_fix_first_false_and_masked_points_f64():
    """Plain least squares with `fix_first=False`: frame 0 moves as in JAX;
    masked points stay put."""
    jg, tg = _graphs(GRAPH, "f64")
    tree = dict(PTS)
    tree["point_mask"] = PTS["point_mask"].copy()
    tree["point_mask"][:4] = False
    jf, tf = _factors(tree, "f64")
    jr = jpb.optimize(jg, jf, jg.K, iterations=3, fix_first=False)
    tr = tpb.optimize(tg, tf, tg.K, iterations=3, fix_first=False)
    np.testing.assert_allclose(float(jr.chi2), float(tr.chi2), rtol=1e-7)
    np.testing.assert_allclose(to_np(jr.points), to_np(tr.points), atol=1e-7)
    np.testing.assert_array_equal(to_np(tr.points)[:4], PTS["points"][:4])
    assert np.abs(to_np(tr.cam_Tcw.trans)[0] - GRAPH["cam_Tcw"]["trans"][0]).max() > 1e-6
