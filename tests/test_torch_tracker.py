"""Port parity: slam/tracker.py, the incremental step over 6 frames against
the JAX package (same random graph as test_torch_backend.py)."""

import numpy as np
import pytest
import torch

from torch_parity import DTYPES, jax_tree_to_numpy, to_j, to_np, to_t, tree_np, assert_tree_close

import jax.numpy as jnp

from torch_window_parity import empty_graphs, first_poses, frame_inputs, graph
from cube_slam_wu_tpu.core.cuboid import Cuboid as JCuboid
from cube_slam_wu_tpu.core.se3 import SE3 as JSE3
from cube_slam_wu_tpu.slam import tracker as jtracker
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph as JGraph
from cube_slam_wu_tpu_torch.core.cuboid import Cuboid as TCuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3 as TSE3
from cube_slam_wu_tpu_torch.slam import tracker as ttracker
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph as TGraph


@pytest.mark.parametrize("dt,tol", [("f64", 1e-8), ("f32", 2e-4)])
def test_incremental_step_over_6_frames(dt, tol):
    """Insert 6 frames one by one (constant-velocity init, soft gating, 5 LM
    iterations each) into a graph whose two landmarks already exist.

    The landmarks are pre-seeded because a landmark's FIRST observation is a
    coin toss in the JAX package: the cuboid is initialised from that very
    measurement, so both the 0 deg and the 180 deg front-face candidates of
    `min_log_error` have a residual of ~0 (the SE3 log loses the axis of an
    exact half turn) and an ulp picks one; the half-turn candidate carries a
    meaningless Jacobian.  The port never selects it (see
    `test_first_observation_is_well_posed` and ROADMAP.md queue 3)."""
    jd, td, _ = DTYPES[dt]
    F, O = 8, 2
    tree = graph()
    jstep = jtracker.make_incremental_step(5, None, 1.0, 1.0, None)
    tstep = ttracker.make_incremental_step(5, None, 1.0, 1.0, None)
    cube = tree["cube"]
    jg = JGraph.empty(F, O, jd)._replace(
        K=to_j(tree["K"], jd), cube_valid=jnp.ones(O, bool),
        cube=JCuboid(JSE3(to_j(cube["pose"]["quat"], jd), to_j(cube["pose"]["trans"], jd)), to_j(cube["scale"], jd)),
    )
    tg = TGraph.empty(F, O, td)._replace(
        K=to_t(tree["K"], td), cube_valid=torch.ones(O, dtype=torch.bool),
        cube=TCuboid(TSE3(to_t(cube["pose"]["quat"], td), to_t(cube["pose"]["trans"], td)), to_t(cube["scale"], td)),
    )
    first = np.linalg.inv(
        to_np(JSE3(to_j(tree["cam_Tcw"]["quat"][0]), to_j(tree["cam_Tcw"]["trans"][0])).matrix())
    )
    jfirst = JSE3.from_matrix(to_j(first, jd))
    tfirst = TSE3.from_matrix(to_t(first, td))
    rng = np.random.default_rng(5)
    for i in range(6):
        has = tree["cube_meas_mask"][i] | (i == 0)
        if i == 3:
            has = np.array([True, False])
        q = rng.uniform(0.5, 1.0, O)
        m = tree["cube_meas"]
        bbox = tree["bbox_meas"][i]
        jframe = jtracker.FrameInput(
            meas=JCuboid(JSE3(to_j(m["pose"]["quat"][i], jd), to_j(m["pose"]["trans"][i], jd)), to_j(m["scale"][i], jd)),
            quality=to_j(q, jd), has_meas=to_j(has), active=jnp.asarray(True),
            bbox=to_j(bbox, jd), bbox_weight=to_j(np.where(has, 0.005, 0.0), jd),
        )
        tframe = ttracker.FrameInput(
            meas=TCuboid(TSE3(to_t(m["pose"]["quat"][i], td), to_t(m["pose"]["trans"][i], td)), to_t(m["scale"][i], td)),
            quality=to_t(q, td), has_meas=to_t(has), active=torch.tensor(True),
            bbox=to_t(bbox, td), bbox_weight=to_t(np.where(has, 0.005, 0.0), td),
        )
        jg, (jchi2, jcubes) = jstep(jg, (jnp.asarray(i, jnp.int32), jframe, jfirst))
        tg, (tchi2, tcubes) = tstep(tg, (i, tframe, tfirst))
        np.testing.assert_allclose(float(jchi2), float(tchi2), rtol=1e-6 if dt == "f64" else 5e-3, atol=1e-9)
        np.testing.assert_allclose(to_np(jcubes), to_np(tcubes), atol=tol * 10)
    assert_tree_close(jax_tree_to_numpy(jg), tree_np(tg), atol=tol * 10)
    assert to_np(tg.frame_mask).sum() == 6 and to_np(tg.cube_valid).all()


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_first_observation_is_well_posed(dt):
    """A landmark initialised from its own first measurement: the half-turn
    candidate (residual exactly ~0, undefined derivative) is never selected,
    the Jacobian is finite and the first bundle adjustment does not raise
    chi2."""
    from cube_slam_wu_tpu_torch.slam import ba as tba

    _, td, _ = DTYPES[dt]
    F, O = 4, 2
    tree = graph()
    tstep = ttracker.make_incremental_step(5, None, 1.0, 1.0, None)
    tg = TGraph.empty(F, O, td)._replace(K=to_t(tree["K"], td))
    first = np.linalg.inv(
        to_np(JSE3(to_j(tree["cam_Tcw"]["quat"][0]), to_j(tree["cam_Tcw"]["trans"][0])).matrix())
    )
    tfirst = TSE3.from_matrix(to_t(first, td))
    m = tree["cube_meas"]
    for i in range(2):
        frame = ttracker.FrameInput(
            meas=TCuboid(TSE3(to_t(m["pose"]["quat"][i], td), to_t(m["pose"]["trans"][i], td)), to_t(m["scale"][i], td)),
            quality=torch.full((O,), 0.8, dtype=td), has_meas=torch.ones(O, dtype=torch.bool),
            active=torch.tensor(True), bbox=to_t(tree["bbox_meas"][i], td),
            bbox_weight=torch.full((O,), 0.005, dtype=td),
        )
        g_in = ttracker._insert_frame(tg, i, frame, tfirst, None, 1.0, 1.0)
        n = F * 6 + O * 9
        J = torch.func.jacfwd(lambda dx: tba._residual_vector(g_in, dx, True))(
            torch.zeros(n, dtype=td)
        )
        assert torch.isfinite(J).all()
        assert float(J.abs().max()) < 1e6
        r0 = tba._residual_vector(g_in, torch.zeros(n, dtype=td), True)
        tg, (chi2, _) = tstep(tg, (i, frame, tfirst))
        assert float(chi2) <= float((r0 * r0).sum()) + 1e-12
    assert to_np(tg.cube_valid).all()
    # the error of a cuboid against itself is zero, through the 0 deg candidate
    c = tg.cube
    e = c.min_log_error(c)
    assert float(e.abs().max()) < (1e-12 if dt == "f64" else 1e-5)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_gate_threshold_and_robust_delta_in_the_step(dt):
    """The incremental step with the hard innovation gate and the Huber
    kernel over 4 frames; the gate (0.25) drops some edges but not all."""
    F, O = 6, 2
    jstep = jtracker.make_incremental_step(5, 0.25, 1.0, 1.0, 0.5)
    tstep = ttracker.make_incremental_step(5, 0.25, 1.0, 1.0, 0.5)
    jg, tg = empty_graphs(F, O, dt, graph()["K"], graph()["cube"])
    jfirst, tfirst = first_poses(graph(), dt)
    rng = np.random.default_rng(5)
    for i in range(4):
        q = rng.uniform(0.5, 1.0, O)
        jframe, tframe = frame_inputs(graph(), i, dt, q, np.ones(O, bool))
        jg, (jchi2, _) = jstep(jg, (jnp.asarray(i, jnp.int32), jframe, jfirst))
        tg, (tchi2, _) = tstep(tg, (i, tframe, tfirst))
        np.testing.assert_array_equal(to_np(jg.cube_meas_mask), to_np(tg.cube_meas_mask))
        np.testing.assert_allclose(float(jchi2), float(tchi2), rtol=1e-6 if dt == "f64" else 5e-3, atol=1e-9)
    assert_tree_close(jax_tree_to_numpy(jg), tree_np(tg), atol=1e-6 if dt == "f64" else 1e-3)
    kept = to_np(tg.cube_meas_mask)[:4]
    assert kept[0].all() and 0 < kept.sum() < kept.size, kept
