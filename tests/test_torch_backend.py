"""Port parity: association, tracklet spawn, measurement assembly, the graph
residuals and the LM bundle adjustment against the JAX package on identical
random inputs.  (The incremental step is in test_torch_tracker.py.)"""

import numpy as np
import pytest
import torch

from torch_parity import DTYPES, jax_tree_to_numpy, to_j, to_np, to_t, tree_np, assert_tree_close

import jax.numpy as jnp

from cube_slam_wu_tpu.core.cuboid import Cuboid as JCuboid
from cube_slam_wu_tpu.core.se3 import SE3 as JSE3
from cube_slam_wu_tpu.ops import association as jassoc
from cube_slam_wu_tpu.ops.proposal import ProposalResult as JProposalResult
from cube_slam_wu_tpu.slam import ba as jba
from cube_slam_wu_tpu.slam import online as jonline
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph as JGraph
from cube_slam_wu_tpu.slam.graph import graph_chi2 as jgraph_chi2
from cube_slam_wu_tpu.slam.graph import graph_residuals as jgraph_residuals
from cube_slam_wu_tpu_torch.ops import association as tassoc
from cube_slam_wu_tpu_torch.ops.proposal import ProposalResult as TProposalResult
from cube_slam_wu_tpu_torch.slam import ba as tba
from cube_slam_wu_tpu_torch.slam import online as tonline
from cube_slam_wu_tpu_torch.slam import tracker as ttracker
from cube_slam_wu_tpu_torch.slam.convert import state_from_numpy
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph as TGraph
from cube_slam_wu_tpu_torch.slam.graph import graph_chi2 as tgraph_chi2
from cube_slam_wu_tpu_torch.slam.graph import graph_residuals as tgraph_residuals


def _boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(20, 80, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1)


@pytest.mark.parametrize("seed", range(4))
def test_iou_greedy_associate(seed):
    rng = np.random.default_rng(seed)
    O, D = 5, 4
    tracks = _boxes(rng, O)
    dets = tracks[rng.permutation(O)[:D]] + rng.normal(0, 6, (D, 4))
    if seed == 3:
        dets[1] = dets[0]  # exact tie between two detections
    tmask = rng.random(O) < 0.8
    dmask = rng.random(D) < 0.8
    ji = jassoc.iou_matrix(to_j(tracks), to_j(dets), to_j(tmask), to_j(dmask))
    ti = tassoc.iou_matrix(to_t(tracks), to_t(dets), to_t(tmask), to_t(dmask))
    np.testing.assert_allclose(to_np(ji), to_np(ti), atol=1e-12)
    jc, ja = jassoc.greedy_assign(ji, 0.3)
    tc, ta = tassoc.greedy_assign(ti, 0.3)
    np.testing.assert_array_equal(to_np(jc), to_np(tc))
    np.testing.assert_array_equal(to_np(ja), to_np(ta))
    jout = jassoc.associate_detections(to_j(tracks), to_j(tmask), to_j(dets), to_j(dmask))
    tout = tassoc.associate_detections(to_t(tracks), to_t(tmask), to_t(dets), to_t(dmask))
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(to_np(a), to_np(b))


def _host_spawn(used, alive, det_is_new, det_of_track, matched):
    """Host loop: each new detection (ascending) takes the first never-used
    slot; dropped when none is left."""
    used, alive = used.copy(), alive.copy()
    det_of_track, matched = det_of_track.copy(), matched.copy()
    dropped = 0
    for d in np.flatnonzero(det_is_new):
        free = np.flatnonzero(~used)
        if len(free) == 0:
            dropped += 1
            continue
        o = free[0]
        used[o] = alive[o] = matched[o] = True
        det_of_track[o] = d
    return det_of_track, matched, used, alive, dropped


def test_spawn_new_tracks_randomized_exact():
    rng = np.random.default_rng(0)
    for _ in range(60):
        O, D = int(rng.integers(1, 7)), int(rng.integers(1, 6))
        used = rng.random(O) < 0.5
        alive = used & (rng.random(O) < 0.7)
        det_of_track = rng.integers(0, D + 1, size=O).astype(np.int32)
        matched = (det_of_track < D) & alive
        det_is_new = rng.random(D) < 0.5
        for d in det_of_track[matched]:
            det_is_new[d] = False
        jbook = jonline.OnlineBook.empty(O, jnp.float32)._replace(
            used=to_j(used), alive=to_j(alive)
        )
        tbook = tonline.OnlineBook.empty(O, torch.float32)._replace(
            used=to_t(used), alive=to_t(alive)
        )
        jout = jonline._spawn_new_tracks(jbook, to_j(det_is_new), to_j(det_of_track), to_j(matched))
        tout = tonline._spawn_new_tracks(tbook, to_t(det_is_new), to_t(det_of_track), to_t(matched))
        host = _host_spawn(used, alive, det_is_new, det_of_track, matched)
        for a, b, h in zip(jout, tout, host):
            a, b = to_np(a), to_np(b)
            if a.ndim:  # slots that are not matched keep an arbitrary det index
                sel = to_np(tout[1]) if a.dtype != bool else slice(None)
                np.testing.assert_array_equal(a[sel], b[sel])
                np.testing.assert_array_equal(b[sel], np.asarray(h)[sel])
            else:
                assert int(a) == int(b) == int(h)


def _proposal_result(rng, D, mod, np_dtype):
    f = lambda *s: rng.normal(0, 1, s).astype(np_dtype)
    vals = dict(
        valid=rng.random(D) < 0.8,
        pos=f(D, 3) + np.array([0, 5, 0.5], np_dtype),
        rotY=rng.uniform(-3, 3, D).astype(np_dtype),
        scale=rng.uniform(0.2, 1.0, (D, 3)).astype(np_dtype),
        box_config_type=np.ones((D, 2), np.int32),
        corners_2d=f(D, 2, 8),
        corners_3d_world=f(D, 3, 8),
        edge_distance_error=f(D),
        edge_angle_error=f(D),
        normalized_error=rng.uniform(0, 1, D).astype(np_dtype),
        skew_ratio=f(D),
        camera_roll_delta=rng.uniform(-0.1, 0.1, D).astype(np_dtype),
        camera_pitch_delta=rng.uniform(-0.1, 0.1, D).astype(np_dtype),
        cap_overflow=np.zeros(D, np.int32),
    )
    return vals


@pytest.mark.parametrize("canon", [True, False])
def test_measurements_from_proposals(canon):
    rng = np.random.default_rng(1)
    O, D = 4, 3
    vals = _proposal_result(rng, D, None, np.float32)
    jres = JProposalResult(**{k: to_j(v) for k, v in vals.items()})
    tres = TProposalResult(**{k: to_t(v) for k, v in vals.items()})
    det_of_track = np.array([2, 0, 3, 1], np.int32)
    matched = np.array([True, True, False, True])
    r0, p0, y0 = 0.02, -1.6, 0.4
    cam_t = np.array([0.1, -0.2, 1.6], np.float32)
    jout = jonline._measurements_from_proposals(
        jres, to_j(det_of_track), to_j(matched), jnp.float32(r0), jnp.float32(p0),
        jnp.float32(y0), to_j(cam_t), jnp.float32, canonicalize_yaw=canon,
    )
    tout = tonline._measurements_from_proposals(
        tres, to_t(det_of_track), to_t(matched), torch.tensor(r0), torch.tensor(p0),
        torch.tensor(y0), to_t(cam_t), torch.float32, canonicalize_yaw=canon,
    )
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-5, rtol=1e-5)


def _random_graph_np(rng, F=8, O=2, n_active=6, np_dtype=np.float64):
    """A filled graph as nested dicts of numpy arrays: a camera driving
    forward, O cuboids ahead, noisy measurements, a few masked slots."""
    jd = jnp.float64
    K = np.array([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1.0]])
    R0 = np.array([[1.0, 0, 0], [0, 0, 1.0], [0, -1.0, 0]])  # camera looks along +y
    Twc = []
    for i in range(F):
        T = np.eye(4)
        T[:3, :3] = R0
        T[:3, 3] = [0.05 * i, 0.25 * i, 1.6]
        Twc.append(T)
    Twc = JSE3.from_matrix(to_j(np.stack(Twc), jd))
    noise = JSE3.exp(to_j(rng.normal(0, 0.02, (F, 6)), jd))
    Tcw_true = Twc.inverse()
    Tcw_est = noise.compose(Tcw_true)
    cubes_min = np.stack(
        [[-1.0 + 2.2 * o, 6.0 + 1.5 * o, 0.5, 0, 0, 0.4 + 0.9 * o, 0.6, 0.4, 0.5] for o in range(O)]
    )
    cube_true = JCuboid.from_minimal(to_j(cubes_min, jd))
    cube_est = JCuboid.from_minimal(to_j(cubes_min + rng.normal(0, 0.05, cubes_min.shape), jd))
    Twc_b = JSE3(
        jnp.broadcast_to(Twc.quat[:, None, :], (F, O, 4)),
        jnp.broadcast_to(Twc.trans[:, None, :], (F, O, 3)),
    )
    cube_b = JCuboid(
        JSE3(
            jnp.broadcast_to(cube_true.pose.quat[None], (F, O, 4)),
            jnp.broadcast_to(cube_true.pose.trans[None], (F, O, 3)),
        ),
        jnp.broadcast_to(cube_true.scale[None], (F, O, 3)),
    )
    meas = cube_b.transform_to(Twc_b)
    meas = meas.exp_update(to_j(rng.normal(0, 0.03, (F, O, 9)), jd))
    bbox = cube_b.project_bbox(
        JSE3(
            jnp.broadcast_to(Tcw_true.quat[:, None, :], (F, O, 4)),
            jnp.broadcast_to(Tcw_true.trans[:, None, :], (F, O, 3)),
        ),
        to_j(K, jd),
    ) + to_j(rng.normal(0, 1.0, (F, O, 4)), jd)
    prev = np.maximum(np.arange(F) - 1, 0)
    odom = Tcw_true.compose(JSE3(Tcw_true.quat[prev], Tcw_true.trans[prev]).inverse())
    odom = JSE3.exp(to_j(rng.normal(0, 0.01, (F, 6)), jd)).compose(odom)
    frame_mask = np.arange(F) < n_active
    meas_mask = (rng.random((F, O)) < 0.85) & frame_mask[:, None]
    g = JGraph(
        cam_Tcw=Tcw_est, cube=cube_est,
        frame_mask=to_j(frame_mask), cube_valid=to_j(np.ones(O, bool)),
        odom=odom, odom_mask=to_j(frame_mask & (np.arange(F) > 0)),
        cube_meas=meas,
        cube_meas_weight=to_j(rng.uniform(1.0, 2.0, (F, O)), jd),
        cube_meas_mask=to_j(meas_mask),
        bbox_meas=bbox, bbox_weight=to_j(np.full((F, O), 0.005), jd),
        bbox_mask=to_j(meas_mask), K=to_j(K, jd),
    )
    return jax_tree_to_numpy(g)


def _graphs(tree, dt):
    jd, td, _ = DTYPES[dt]
    cast = lambda a: jnp.asarray(a, jd) if np.asarray(a).dtype.kind == "f" else jnp.asarray(a)
    jg = JGraph(
        cam_Tcw=JSE3(**{k: cast(v) for k, v in tree["cam_Tcw"].items()}),
        cube=JCuboid(JSE3(**{k: cast(v) for k, v in tree["cube"]["pose"].items()}), cast(tree["cube"]["scale"])),
        frame_mask=cast(tree["frame_mask"]), cube_valid=cast(tree["cube_valid"]),
        odom=JSE3(**{k: cast(v) for k, v in tree["odom"].items()}),
        odom_mask=cast(tree["odom_mask"]),
        cube_meas=JCuboid(JSE3(**{k: cast(v) for k, v in tree["cube_meas"]["pose"].items()}), cast(tree["cube_meas"]["scale"])),
        cube_meas_weight=cast(tree["cube_meas_weight"]), cube_meas_mask=cast(tree["cube_meas_mask"]),
        bbox_meas=cast(tree["bbox_meas"]), bbox_weight=cast(tree["bbox_weight"]),
        bbox_mask=cast(tree["bbox_mask"]), K=cast(tree["K"]),
    )
    tg = state_from_numpy(tree, "cpu", td)
    assert isinstance(tg, TGraph)
    return jg, tg


GRAPH = _random_graph_np(np.random.default_rng(0))


@pytest.mark.parametrize("dt,tol", [("f64", 1e-10), ("f32", 1e-5)])
def test_graph_residuals(dt, tol):
    jg, tg = _graphs(GRAPH, dt)
    jr = jgraph_residuals(jg, jg.cam_Tcw, jg.cube)
    tr = tgraph_residuals(tg, tg.cam_Tcw, tg.cube)
    for a, b in zip(jr, tr):
        a, b = to_np(a), to_np(b)
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(a, b, atol=tol * (100 if dt == "f32" else 1), rtol=tol)
    np.testing.assert_allclose(
        float(jgraph_chi2(jg, jg.cam_Tcw, jg.cube)),
        float(tgraph_chi2(tg, tg.cam_Tcw, tg.cube)), rtol=1e-9 if dt == "f64" else 1e-4,
    )


@pytest.mark.parametrize("iters", [1, 2, 3, 4, 5])
def test_lm_chi2_and_lambda_per_iteration_f64(iters):
    jg, tg = _graphs(GRAPH, "f64")
    jr = jba.optimize(jg, iterations=iters)
    tr = tba.optimize(tg, iterations=iters)
    np.testing.assert_allclose(float(jr.chi2), float(tr.chi2), rtol=1e-8)
    np.testing.assert_allclose(float(jr.lambda_final), float(tr.lambda_final), rtol=1e-8)
    if iters == 5:
        assert float(tr.chi2) < float(tgraph_chi2(tg, tg.cam_Tcw, tg.cube))
        assert_tree_close(tree_np(jr.cam_Tcw), tree_np(tr.cam_Tcw), atol=1e-9)
        assert_tree_close(tree_np(jr.cube), tree_np(tr.cube), atol=1e-9)


def test_lm_poses_f32():
    jg, tg = _graphs(GRAPH, "f32")
    jr = jba.optimize(jg, iterations=5)
    tr = tba.optimize(tg, iterations=5)
    assert_tree_close(tree_np(jr.cam_Tcw), tree_np(tr.cam_Tcw), atol=1e-4)
    assert_tree_close(tree_np(jr.cube), tree_np(tr.cube), atol=1e-4)
    np.testing.assert_allclose(float(jr.chi2), float(tr.chi2), rtol=1e-3)


def test_unported_ba_options_raise():
    """Every option of the back end is ported now (parity cases in
    test_torch_ba_options.py and test_torch_window.py): what used to raise
    NotImplementedError runs, and only an unknown algorithm is refused."""
    _, tg = _graphs(GRAPH, "f64")
    for kw in (dict(algorithm="gn"), dict(algorithm="dogleg"), dict(robust_delta=1.0)):
        res = tba.optimize(tg, iterations=1, **kw)
        assert torch.isfinite(res.chi2)
    with pytest.raises(ValueError):
        tba.optimize(tg, algorithm="newton")
    assert callable(ttracker.make_incremental_step(gate_threshold=3.0))
    assert callable(ttracker.make_incremental_step(robust_delta=1.0))
    assert callable(ttracker.make_windowed_step(4))
