"""Port parity: association, tracklet spawn, measurement assembly, the graph
residuals and the LM bundle adjustment against the JAX package on identical
random inputs.  (The incremental step is in test_torch_tracker.py.)"""

import numpy as np
import pytest
import torch

import jax_runs
from torch_parity import to_j, to_np, to_t, tree_np, assert_tree_close
from torch_window_parity import graph, graphs

import jax.numpy as jnp

from cube_slam_wu_tpu.ops import association as jassoc
from cube_slam_wu_tpu.ops.proposal import ProposalResult as JProposalResult
from cube_slam_wu_tpu.slam import ba as jba
from cube_slam_wu_tpu.slam import online as jonline
from cube_slam_wu_tpu.slam.graph import graph_chi2 as jgraph_chi2
from cube_slam_wu_tpu.slam.graph import graph_residuals as jgraph_residuals
from cube_slam_wu_tpu_torch.ops import association as tassoc
from cube_slam_wu_tpu_torch.ops.proposal import ProposalResult as TProposalResult
from cube_slam_wu_tpu_torch.slam import ba as tba
from cube_slam_wu_tpu_torch.slam import online as tonline
from cube_slam_wu_tpu_torch.slam import tracker as ttracker
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


@pytest.mark.parametrize("dt,tol", [("f64", 1e-10), ("f32", 1e-5)])
def test_graph_residuals(dt, tol):
    jg, tg = graphs(graph(), dt)
    jr = jax_runs.run(f"backend_residuals_{dt}", lambda: jgraph_residuals(jg, jg.cam_Tcw, jg.cube))
    tr = tgraph_residuals(tg, tg.cam_Tcw, tg.cube)
    for a, b in zip(jr, tr):
        a, b = to_np(a), to_np(b)
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(a, b, atol=tol * (100 if dt == "f32" else 1), rtol=tol)
    np.testing.assert_allclose(
        float(jax_runs.run(f"backend_chi2_{dt}", lambda: jgraph_chi2(jg, jg.cam_Tcw, jg.cube))),
        float(tgraph_chi2(tg, tg.cam_Tcw, tg.cube)), rtol=1e-9 if dt == "f64" else 1e-4,
    )


@pytest.mark.parametrize("iters", [1, 2, 3, 4, 5])
def test_lm_chi2_and_lambda_per_iteration_f64(iters):
    jg, tg = graphs(graph(), "f64")
    jr = jax_runs.run(f"backend_lm_f64_{iters}", lambda: jba.optimize(jg, iterations=iters))
    tr = tba.optimize(tg, iterations=iters)
    np.testing.assert_allclose(float(jr.chi2), float(tr.chi2), rtol=1e-8)
    np.testing.assert_allclose(float(jr.lambda_final), float(tr.lambda_final), rtol=1e-8)
    if iters == 5:
        assert float(tr.chi2) < float(tgraph_chi2(tg, tg.cam_Tcw, tg.cube))
        assert_tree_close(tree_np(jr.cam_Tcw), tree_np(tr.cam_Tcw), atol=1e-9)
        assert_tree_close(tree_np(jr.cube), tree_np(tr.cube), atol=1e-9)


def test_lm_poses_f32():
    jg, tg = graphs(graph(), "f32")
    jr = jax_runs.run("backend_lm_f32_5", lambda: jba.optimize(jg, iterations=5))
    tr = tba.optimize(tg, iterations=5)
    assert_tree_close(tree_np(jr.cam_Tcw), tree_np(tr.cam_Tcw), atol=1e-4)
    assert_tree_close(tree_np(jr.cube), tree_np(tr.cube), atol=1e-4)
    np.testing.assert_allclose(float(jr.chi2), float(tr.chi2), rtol=1e-3)


def test_unported_ba_options_raise():
    """Every option of the back end is ported now (parity cases in
    test_torch_ba_options.py and test_torch_window.py): what used to raise
    NotImplementedError runs, and only an unknown algorithm is refused."""
    _, tg = graphs(graph(), "f64")
    for kw in (dict(algorithm="gn"), dict(algorithm="dogleg"), dict(robust_delta=1.0)):
        res = tba.optimize(tg, iterations=1, **kw)
        assert torch.isfinite(res.chi2)
    with pytest.raises(ValueError):
        tba.optimize(tg, algorithm="newton")
    assert callable(ttracker.make_incremental_step(gate_threshold=3.0))
    assert callable(ttracker.make_incremental_step(robust_delta=1.0))
    assert callable(ttracker.make_windowed_step(4))
