"""Parity of the port's core/sim3.py with the JAX package's on the CPU.

The tangents are the JAX tests' own generator (tests/test_sim3.py), the
normal set and the 1e-6 small-angle set; every group operation agrees within
1e-12 in float64 and 1e-5 in float32, and the forward-mode Jacobian of
exp(t).log() agrees with `jax.jacfwd` within 1e-10, finite at the zero
tangent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from cube_slam_wu_tpu.core.sim3 import Sim3 as JSim3
from test_sim3 import _random_tangent
from cube_slam_wu_tpu_torch.core import rotations as trot
from cube_slam_wu_tpu_torch.core.sim3 import Sim3

TOL = {"f64": 1e-12, "f32": 1e-5}


def _pair(t_np, dt):
    jd, td, nd = tp.DTYPES[dt]
    t_np = np.asarray(t_np, nd)
    return jnp.asarray(t_np, jd), torch.from_numpy(t_np.copy()).to(td)


def _group_ops(exp, a, b, p):
    """exp, log, compose, inverse and apply of one package on (a, b, p)."""
    A, B = exp(a), exp(b)
    return A, A.log(), A.compose(B), A.inverse(), A.apply(p)


# float64 in one compile (eagerly JAX compiles op by op); float32 eagerly:
# under jit XLA fuses the near-pi logs of these tangents into a different
# float32 rounding (1.6e-4 on 3 of 448 values), which eager JAX does not
_jax_group_ops = {"f64": jax.jit(lambda a, b, p: _group_ops(JSim3.exp, a, b, p)),
                  "f32": lambda a, b, p: _group_ops(JSim3.exp, a, b, p)}
_jax_jac = jax.jit(jax.jacfwd(lambda v: JSim3.exp(v).log()))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("scale", [1.0, 1e-6], ids=["normal", "small"])
def test_group_ops_match_jax(dt, scale):
    tol = TOL[dt]
    ta, tb = (np.asarray(_random_tangent(64, seed=s, scale=scale)) for s in (1, 4))
    pts = np.random.default_rng(6).normal(size=(64, 3))
    (ja, xa), (jb, xb), (jp, xp) = _pair(ta, dt), _pair(tb, dt), _pair(pts, dt)
    ours = _group_ops(Sim3.exp, xa, xb, xp)
    ref = _jax_group_ops[dt](ja, jb, jp)
    for name, x, y in zip(("exp", "log", "compose", "inverse", "apply"), ours, ref):
        tp.assert_tree_close(tp.tree_np(x), tp.tree_np(y), atol=tol, path=name)
    TA = ours[0]
    # and the round trip holds in the port on its own
    np.testing.assert_allclose(tp.to_np(TA.log()), tp.to_np(xa), atol=1e-8 if dt == "f64" else 2e-4)


@pytest.mark.parametrize("where", ["zero", "random"])
def test_jacfwd_of_exp_log_matches_jax(where):
    if where == "zero":
        tangents = np.zeros((1, 7))
    else:
        tangents = np.asarray(_random_tangent(4, seed=9, scale=0.7))
    for t in tangents:
        jt, xt = _pair(t, "f64")
        Jj = np.asarray(_jax_jac(jt))
        Jt = tp.to_np(torch.func.jacfwd(lambda v: Sim3.exp(v).log())(xt))
        assert np.isfinite(Jt).all()
        np.testing.assert_allclose(Jt, Jj, atol=1e-10)
        if where == "zero":  # d log(exp(t)) / dt = I at t = 0
            np.testing.assert_allclose(Jt, np.eye(7), atol=1e-12)


def test_exp_matches_matrix_exponential():
    """The port's exp against a brute-force 4x4 matrix exponential of the
    generator [[skew(omega)+sigma*I, upsilon],[0,0]] (tests/test_sim3.py's
    check of the W coupling, which the exp/log round trip cannot see)."""
    from scipy.linalg import expm

    rng = np.random.default_rng(0)
    tangents = [
        np.array([0.3, -0.2, 0.5, 1.0, 2.0, -0.5, 0.4]),
        np.array([1e-6, 2e-6, -1e-6, 0.3, -0.2, 0.1, 1e-7]),
        np.array([0.5, 0.1, -0.3, 1.0, 0.0, 0.0, 0.0]),
        np.array([0.0, 0.0, 0.0, 0.5, -1.0, 2.0, -0.3]),
    ] + [rng.normal(size=7) * 0.5 for _ in range(4)]
    for tan in tangents:
        om, up, sg = tan[:3], tan[3:6], tan[6]
        G = np.zeros((4, 4))
        G[:3, :3] = np.array([[0, -om[2], om[1]], [om[2], 0, -om[0]], [-om[1], om[0], 0]]) + sg * np.eye(3)
        G[:3, 3] = up
        M = expm(G)
        s_ref = np.cbrt(np.linalg.det(M[:3, :3]))
        ours = Sim3.exp(torch.from_numpy(tan.copy()))
        np.testing.assert_allclose(float(ours.scale), s_ref, atol=1e-12)
        np.testing.assert_allclose(tp.to_np(trot.quat_to_rot(ours.quat)), M[:3, :3] / s_ref, atol=1e-12)
        np.testing.assert_allclose(tp.to_np(ours.trans), M[:3, 3], atol=1e-9)
