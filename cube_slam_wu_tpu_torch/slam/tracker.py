"""Incremental camera-object SLAM: the per-frame step.

Re-designs the reference's per-frame loop (incremental_build_graph,
object_slam/src/main_obj.cpp:479-841): every step activates one more frame
in the fixed-capacity graph (constant-velocity pose initialisation,
measurement insertion) and re-optimises the full graph with 5 LM iterations
— the same O(N)-per-frame re-optimisation schedule as the reference — or,
in the fixed-lag step, only the trailing window (slam/window.py).

Objects are a batch axis: each frame carries up to O cuboid measurements
(with masks); an object's vertex is initialised from its first observation
(the reference's frame-0 special case generalised, main_obj.cpp:741-750).

The frame index `i` is a host integer (the caller knows which frame it is
feeding), so slot addressing costs no device read.  The graph is updated
functionally: a step returns new tensors and leaves its input untouched.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.slam import ba
from cube_slam_wu_tpu_torch.slam import window as win_mod
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph
from cube_slam_wu_tpu_torch.utils import hostsync


class FrameInput(NamedTuple):
    """Per-frame measurement inputs (leading axis = object)."""

    meas: Cuboid  # (O,) camera-frame cuboid measurements
    quality: torch.Tensor  # (O,) in [0.5, 1]; weight = 2*quality
    has_meas: torch.Tensor  # (O,) bool
    active: torch.Tensor  # () bool: frame exists (for padded batches)
    # optional 2D bbox observations [cx, cy, w, h] per object for
    # EdgeSE3CuboidProj factors (g2o_Object.h:264-292).  The reference's
    # object_slam main program builds only the 3D EdgeSE3Cuboid; the projection
    # edge is part of its capability surface and is wired here behind
    # bbox_weight (None/0 = reference behaviour).
    bbox: torch.Tensor | None = None  # (O, 4)
    bbox_weight: torch.Tensor | None = None  # (O,)


def _set_row(batch: torch.Tensor, i: int, value: torch.Tensor) -> torch.Tensor:
    out = batch.clone()
    out[i] = value
    return out


def _set_se3(batch: SE3, i: int, value: SE3) -> SE3:
    return SE3(_set_row(batch.quat, i, value.quat), _set_row(batch.trans, i, value.trans))


def _set_cuboid(batch: Cuboid, i: int, value: Cuboid) -> Cuboid:
    return Cuboid(_set_se3(batch.pose, i, value.pose), _set_row(batch.scale, i, value.scale))


def _insert_frame(
    graph: CameraObjectGraph,
    i: int,
    frame: FrameInput,
    first_Twc: SE3,
    gate_threshold: float | None,
    soft_gate_alpha: float | None,
    soft_gate_power: float,
) -> CameraObjectGraph:
    """Constant-velocity pose init + measurement insertion + cuboid vertex
    initialisation (shared by the full-graph and windowed steps).

    Innovation gating (beyond the reference, which feeds every detection into
    the graph unweighted): before inserting a camera-object edge, the 9-d
    `min_log_error` innovation of the measurement against the CURRENT cuboid
    estimate (at the constant-velocity predicted pose) is computed;
    `gate_threshold` drops edges whose innovation norm exceeds it, and
    `soft_gate_alpha` scales the measurement quality by
    1/(1 + alpha*innovation^power).  This is what keeps the online pipeline
    at trajectory parity despite noisier single-frame detections."""
    O = graph.n_objects
    i = int(i)

    # -- constant-velocity pose initialisation (main_obj.cpp:548-565) ----
    prev = graph.cam_Tcw[max(i - 1, 0)]
    prevprev = graph.cam_Tcw[max(i - 2, 0)]
    if i > 1:
        odom_val = prev.compose(prevprev.inverse())
    else:
        odom_val = SE3.identity(
            (), graph.cam_Tcw.trans.dtype, graph.cam_Tcw.trans.device
        )
    curr_Tcw = first_Twc.inverse() if i == 0 else odom_val.compose(prev)

    # -- innovation gating against the current cuboid estimates ----------
    curr_Twc = curr_Tcw.inverse()
    Twc_b = SE3(curr_Twc.quat.expand(O, 4), curr_Twc.trans.expand(O, 3))
    pred_global = frame.meas.transform_from(Twc_b)  # (O,)
    innovation = torch.linalg.norm(
        graph.cube.min_log_error(pred_global), dim=-1
    )  # (O,)
    can_gate = graph.cube_valid & (i > 0)
    quality = frame.quality
    has_meas = frame.has_meas
    if soft_gate_alpha is not None:
        quality = torch.where(
            can_gate,
            quality / (1.0 + soft_gate_alpha * innovation**soft_gate_power),
            quality,
        )
    if gate_threshold is not None:
        has_meas = has_meas & (~can_gate | (innovation < gate_threshold))

    # -- write the new frame into the graph ------------------------------
    g = graph._replace(
        cam_Tcw=_set_se3(graph.cam_Tcw, i, curr_Tcw),
        frame_mask=_set_row(graph.frame_mask, i, frame.active),
        odom=_set_se3(graph.odom, i, odom_val),
        odom_mask=_set_row(graph.odom_mask, i, frame.active & (i > 0)),
        cube_meas=_set_cuboid(graph.cube_meas, i, frame.meas),
        cube_meas_weight=_set_row(graph.cube_meas_weight, i, 2.0 * quality),
        cube_meas_mask=_set_row(graph.cube_meas_mask, i, frame.active & has_meas),
    )
    if frame.bbox is not None:
        g = g._replace(
            bbox_meas=_set_row(g.bbox_meas, i, frame.bbox),
            bbox_weight=_set_row(g.bbox_weight, i, frame.bbox_weight),
            bbox_mask=_set_row(
                g.bbox_mask, i, frame.active & has_meas & (frame.bbox_weight > 0)
            ),
        )

    # -- cuboid vertex initialisation on first observation ---------------
    # (generalises the reference's frame-0 init, main_obj.cpp:741-750)
    init_cube = frame.meas.transform_from(Twc_b)  # (O,)
    set_cube = (~g.cube_valid) & frame.active & frame.has_meas
    return g._replace(
        cube=Cuboid(
            SE3(
                torch.where(set_cube[:, None], init_cube.pose.quat, g.cube.pose.quat),
                torch.where(set_cube[:, None], init_cube.pose.trans, g.cube.pose.trans),
            ),
            torch.where(set_cube[:, None], init_cube.scale, g.cube.scale),
        ),
        cube_valid=g.cube_valid | set_cube,
    )


def make_incremental_step(
    iterations: int = 5,
    gate_threshold: float | None = None,
    soft_gate_alpha: float | None = None,
    soft_gate_power: float = 1.0,
    robust_delta: float | None = None,
):
    """Build the full-graph step:
    (graph, (index, FrameInput, first_pose)) -> (graph, (chi2, cubes)).

    `first_pose` is the fixed frame-0 camera-to-world pose (the reference
    uses the first ground-truth pose, main_obj.cpp:526)."""

    def step(carry, inp):
        graph: CameraObjectGraph = carry
        i, frame, first_Twc = inp
        g = _insert_frame(
            graph, i, frame, first_Twc,
            gate_threshold, soft_gate_alpha, soft_gate_power,
        )
        # -- full-graph re-optimisation (main_obj.cpp:802-803) ---------------
        result = ba.optimize(
            g, iterations=iterations, fix_first=True, robust_delta=robust_delta
        )
        g = g._replace(cam_Tcw=result.cam_Tcw, cube=result.cube)
        # skip everything for padded slots
        g = ba.tree_where(frame.active, g, graph)
        # per-frame optimized landmark snapshot (cube_pose_opti_history,
        # main_obj.cpp:815-819)
        return g, (result.chi2, g.cube.to_minimal())

    return step


def make_windowed_step(
    window: int,
    iterations: int = 5,
    gate_threshold: float | None = None,
    soft_gate_alpha: float | None = None,
    soft_gate_power: float = 1.0,
    robust_delta: float | None = None,
):
    """Fixed-lag step: ((graph, prior), (index, FrameInput, first_pose)) ->
    ((graph, prior), (chi2, cubes)).  Optimises only the trailing `window`
    frames; on frame departure its cuboid edges are absorbed into the Gaussian
    prior (slam.window).  Per-frame cost is O(window^2 .. ^3) independent of
    the sequence length, unlike the reference's whole-graph re-optimisation
    (main_obj.cpp:802-803).

    The frame index is a host integer, so the departing frame and the
    window's start are host arithmetic and the window is a plain slice."""
    W = int(window)

    def step(carry, inp):
        graph, prior = carry
        i, frame, first_Twc = inp
        i = int(i)
        g = _insert_frame(
            graph, i, frame, first_Twc,
            gate_threshold, soft_gate_alpha, soft_gate_power,
        )

        # -- absorb the departing frame (index i - W) into the prior ---------
        d = max(i - W, 0)
        mask_d = g.cube_meas_mask[d] if i >= W else torch.zeros_like(g.cube_meas_mask[d])
        prior_new = win_mod.absorb_frame(
            prior,
            g.cam_Tcw[d].inverse(),
            Cuboid(g.cube_meas.pose[d], g.cube_meas.scale[d]),
            g.cube_meas_weight[d],
            mask_d,
            g.cube,
        )

        # -- optimise the trailing window ------------------------------------
        s = min(max(i - W + 1, 0), g.capacity - W)
        win = win_mod.window_slice(g, s, W)
        result = ba.optimize(
            win, iterations=iterations, fix_first=True, prior=prior_new,
            robust_delta=robust_delta,
        )
        g = win_mod.window_scatter(g, result.cam_Tcw, s)
        g = g._replace(cube=result.cube)

        # skip everything for padded slots
        g = ba.tree_where(frame.active, g, graph)
        prior_new = ba.tree_where(frame.active, prior_new, prior)
        return (g, prior_new), (result.chi2, g.cube.to_minimal())

    return step


class PointState(NamedTuple):
    """Rolling point-landmark state carried by the point-augmented windowed
    step: the dense observation raster (the reference's analogue is
    ORB-SLAM2's per-keyframe feature observations; its g2o ships the mono
    projection edges, types_six_dof_expmap.h:145-175) plus current world
    estimates."""

    obs_uv: torch.Tensor  # (F, P, 2) pixel observations per frame slot
    obs_mask: torch.Tensor  # (F, P) observation validity
    points: torch.Tensor  # (P, 3) world estimates
    point_valid: torch.Tensor  # (P,) triangulated + accepted

    @staticmethod
    def empty(capacity: int, n_points: int, dtype=torch.float64, device="cpu") -> "PointState":
        return PointState(
            obs_uv=torch.zeros((capacity, n_points, 2), dtype=dtype, device=device),
            obs_mask=torch.zeros((capacity, n_points), dtype=torch.bool, device=device),
            points=torch.zeros((n_points, 3), dtype=dtype, device=device),
            point_valid=torch.zeros((n_points,), dtype=torch.bool, device=device),
        )


@contextlib.contextmanager
def _booked(name: str, captured):
    """Book the captures and replays that `captured` (a
    `utils.capture.Captured`) makes inside the context as `<name>_captures`
    and `<name>_replays` under `kitti/step` (host counts, no read)."""
    seen = captured.captures, captured.replays
    yield
    for kind, before, now in (("captures", seen[0], captured.captures),
                              ("replays", seen[1], captured.replays)):
        if now > before:
            hostsync.add_count("kitti/step", f"{name}_{kind}", now - before)


def _pinhole_inverse(K: torch.Tensor) -> torch.Tensor:
    """K^-1 without a host read (`inv_ex` reports failure in a flag that
    nothing reads; a pinhole K is always invertible)."""
    return torch.linalg.inv_ex(K).inverse


def make_windowed_point_step(
    window: int,
    K: torch.Tensor,
    iterations: int = 5,
    gate_threshold: float | None = None,
    soft_gate_alpha: float | None = None,
    soft_gate_power: float = 1.0,
    robust_delta: float | None = None,
    point_weight: float = 0.05,
    min_obs: int = 3,
    reproj_gate_px: float = 8.0,
    point_huber: float | None = 2.0,
    max_point_range: float = 60.0,
):
    """Fixed-lag step with point landmarks: the full CubeSLAM objective
    (odometry + cuboid + bbox + point reprojection) optimised jointly over
    the trailing window via slam.point_ba's Schur reduction.

    This is the paper's camera+points+objects coupling: points supply dense
    frame-to-frame relative-pose information that the cuboid edges alone
    cannot, while the cuboids anchor global scale.

    carry = (graph, CubePrior, PointState); the input adds per-frame point
    observations (obs_uv (P, 2), obs_mask (P,)), a `respawned (P,)` flag
    marking slots the front-end re-seeded with a NEW physical feature (their
    observation history and point estimate are cleared, so a reused slot can
    never mix two landmarks) and a `ground_hint (P,)` flag for features the
    front-end believes lie on the ground plane (below the horizon, outside
    every detection box).  The frame index is a host integer.

    Per step: record observations -> initialise never-valid slots with
    >= `min_obs` in-window observations (batched DLT at the current window
    poses, accepted only under `reproj_gate_px` and in front of the camera
    within `max_point_range`) -> gate each observation by reprojection
    error -> joint LM.

    Monocular bootstrap: ground-hinted slots that fail DLT are initialised by
    intersecting their newest observation ray with the world ground plane
    z = 0 (the known-camera-height geometry the cuboid proposals use), valid
    from a single view; the landmark stays a free 3-DoF variable in the BA.
    Points falling out of the window are not marginalised.  A valid point
    whose in-window observations are ALL rejected by the reprojection gate
    (>= 3 of them) is demoted to invalid so the slot can re-initialise.

    The prior's absorption is `window.captured_absorb` and the joint LM is
    `point_ba.captured_lm` (`utils.capture.Captured`): every frame absorbs a
    frame and solves the window at the same shapes, so on a card each is
    captured in a CUDA graph on the first frame of the process's first
    session and replayed on every later frame, of that session and of later
    ones; on the CPU they are plain `window.absorb_frame` and
    `point_ba.optimize`.  What they return are clones of the graphs'
    outputs, since they go into the carry and the next replay overwrites the
    graphs' own buffers.  Frames before the window is full absorb with an
    empty mask, as every frame runs the same graph.

    The step's outputs are (chi2, cubes, stats): `stats` (2,) int64 holds the
    LM iterations whose step was taken and the valid points in the solve,
    for the caller to read with its pull of the other two.  Its stages
    (`utils.hostsync`): `step/insert` (frame insertion, eager, and the
    prior's absorption: on a card the copies into its graph's inputs, one
    replay and the clones of its outputs), `step/points` (observation
    bookkeeping, DLT, the ground bootstrap, the reprojection gate and
    demotion) and `step/lm` (the LM: the same on a card, while the LM's
    device time waits at the caller's next read).  It books each absorption
    and each LM that replayed as `absorb_replays` and `lm_replays`, and each
    capture as `absorb_captures` and `lm_captures`, under `kitti/step` (host
    counts, no read)."""
    from cube_slam_wu_tpu_torch.core import rotations as rotu
    from cube_slam_wu_tpu_torch.slam import point_ba
    from cube_slam_wu_tpu_torch.slam.point_ba import PointFactors

    W = int(window)
    Kinv = _pinhole_inverse(K)

    def step(carry, inp):
        graph, prior, ps = carry
        i, frame, first_Twc, obs_i, obs_mask_i, respawned, ground_hint = inp
        i = int(i)
        with hostsync.stage("step/insert"):
            g = _insert_frame(
                graph, i, frame, first_Twc,
                gate_threshold, soft_gate_alpha, soft_gate_power,
            )

            # -- absorb the departing frame into the cuboid prior -----------
            d = max(i - W, 0)
            mask_d = g.cube_meas_mask[d] if i >= W else torch.zeros_like(g.cube_meas_mask[d])
            absorb = win_mod.captured_absorb
            with _booked("absorb", absorb):
                prior_new = absorb(
                    prior,
                    g.cam_Tcw[d].inverse(),
                    Cuboid(g.cube_meas.pose[d], g.cube_meas.scale[d]),
                    g.cube_meas_weight[d],
                    mask_d,
                    g.cube,
                )
        dtype = ps.points.dtype
        dev = ps.points.device
        P = ps.points.shape[0]

        with hostsync.stage("step/points"):
            # -- record this frame's point observations; forget respawned slots
            omask = _set_row(ps.obs_mask & ~respawned[None, :], i, obs_mask_i & frame.active)
            ouv = _set_row(ps.obs_uv, i, obs_i)
            pvalid = ps.point_valid & ~respawned

            # -- window slices ------------------------------------------------
            s = min(max(i - W + 1, 0), g.capacity - W)
            win = win_mod.window_slice(g, s, W)
            obs_uv_w = ouv[s : s + W]
            obs_mask_w = omask[s : s + W] & win.frame_mask[:, None]

            # -- triangulate fresh tracks at the current window poses ---------
            n_obs = torch.sum(obs_mask_w, dim=0)  # (P,)
            fresh = (~pvalid) & (n_obs >= min_obs)
            X_new, tri_ok = point_ba.triangulate_points(win.cam_Tcw, obs_uv_w, obs_mask_w, K)

            def reproj_err(points):
                proj = point_ba.project_point(win.cam_Tcw[:, None], points[None], K)  # (W, P, 2)
                return torch.linalg.norm(proj - obs_uv_w, dim=-1)

            # DLT acceptance: finite solution, all-window reprojection under
            # the gate, and a sane camera-relative range in the newest frame
            err_new = torch.where(obs_mask_w, reproj_err(X_new), 0.0)
            newest_C = win.cam_Tcw[W - 1].inverse().trans
            rng_new = torch.linalg.norm(X_new - newest_C[None, :], dim=-1)
            accept = (
                fresh
                & tri_ok
                & torch.all(err_new < reproj_gate_px, dim=0)
                & (rng_new < max_point_range)
            )

            # ground-plane bootstrap for hinted slots DLT could not solve:
            # lift the NEWEST observation's ray onto world z = 0
            rows_w = torch.arange(W, device=dev)[:, None]
            last_row = torch.amax(torch.where(obs_mask_w, rows_w, -1), dim=0)  # (P,)
            row = torch.clamp(last_row, 0, W - 1)
            Twc_last = win.cam_Tcw[row].inverse()  # (P,) poses
            uv_last = obs_uv_w[row, torch.arange(P, device=dev)]  # (P, 2)
            ray_c = torch.cat([uv_last, torch.ones_like(uv_last[:, :1])], dim=-1) @ Kinv.T
            d_w = rotu.quat_rotate(Twc_last.quat, ray_c)
            C = Twc_last.trans  # (P, 3) camera centres
            dz = d_w[..., 2]
            t_hit = -C[..., 2] / torch.where(torch.abs(dz) > 1e-6, dz, torch.full_like(dz, -1e-6))
            X_ground = C + t_hit[:, None] * d_w
            ground_accept = (
                fresh
                & ~accept
                & ground_hint
                & (last_row >= 0)
                & (dz < -0.02)  # ray actually descends to the ground
                & (t_hit > 0.5)
                & (t_hit < max_point_range)
                & (C[..., 2] > 0.2)  # camera above the plane
            )

            points = torch.where(accept[:, None], X_new, ps.points)
            points = torch.where(ground_accept[:, None], X_ground, points)
            pvalid = pvalid | accept | ground_accept

            # -- per-observation outlier gate vs current estimates ------------
            obs_ok = obs_mask_w & pvalid[None, :] & (reproj_err(points) < reproj_gate_px)

            # demote landmarks that every in-window observation rejects
            n_ok = torch.sum(obs_ok, dim=0)
            garbage = pvalid & (n_obs >= 3) & (n_ok == 0)
            pvalid = pvalid & ~garbage
            obs_ok = obs_ok & pvalid[None, :]

        factors = PointFactors(
            points=points,
            point_mask=pvalid,
            obs_uv=obs_uv_w,
            obs_mask=obs_ok,
            obs_weight=torch.full((W, P), point_weight, dtype=dtype, device=dev),
        )
        lm = point_ba.captured_lm
        with _booked("lm", lm), hostsync.stage("step/lm"):
            result = lm(
                win, factors, K,
                iterations=iterations, fix_first=True,
                robust_delta=robust_delta, prior=prior_new,
                point_huber=point_huber,
            )
        g = win_mod.window_scatter(g, result.cam_Tcw, s)
        g = g._replace(cube=result.cube)

        # skip everything for padded slots
        ps_new = PointState(ouv, omask, result.points, pvalid)
        g = ba.tree_where(frame.active, g, graph)
        prior_new = ba.tree_where(frame.active, prior_new, prior)
        ps_new = ba.tree_where(frame.active, ps_new, ps)
        stats = torch.stack([result.accepted, torch.sum(pvalid)])
        return (g, prior_new, ps_new), (result.chi2, g.cube.to_minimal(), stats)

    return step


def run_incremental(
    first_Twc: SE3,
    frames: FrameInput,
    capacity: int | None = None,
    iterations: int = 5,
    gate_threshold: float | None = None,
    soft_gate_alpha: float | None = None,
    soft_gate_power: float = 1.0,
    window: int | None = None,
    robust_delta: float | None = None,
    K: torch.Tensor | None = None,
    point_obs: tuple | None = None,
    point_weight: float = 0.05,
    point_opts: dict | None = None,
):
    """Run incremental SLAM over all frames (a loop of the per-frame step;
    nothing is read back to the host).

    Returns (graph, chi2_history (N,), cube_history (N, O, 9)) — the
    per-frame optimized landmark snapshots mirror the reference's
    cube_pose_opti_history (main_obj.cpp:815-819).

    `window=None` re-optimises the full graph every frame (the reference's
    schedule, main_obj.cpp:802-803); `window=W` runs the fixed-lag smoother
    (slam.window) with O(W)-bounded per-frame cost.  A window >= the
    capacity is exactly the full-graph path (no frame ever departs).

    `point_obs = (obs_uv (N, P, 2), obs_mask (N, P)[, ground_hint (N, P)])`
    adds point-landmark reprojection factors to the WINDOWED path
    (make_windowed_point_step; requires `window` and `K`): pre-tracked
    feature observations (e.g. slam.features.build_point_tracks, whose slots
    are never reused, so no respawn flags are needed) are triangulated and
    jointly optimised with the cuboids inside each window.

    `frames` fields have leading axes (N, O) (padded allowed via `active`);
    the graph is built on their device and dtype."""
    from cube_slam_wu_tpu_torch.utils.tree import tree_map

    n, n_obj = frames.quality.shape
    capacity = capacity or n
    dtype = frames.meas.scale.dtype
    dev = frames.meas.scale.device
    graph = CameraObjectGraph.empty(capacity, n_obj, dtype, dev)
    if K is not None:
        graph = graph._replace(K=torch.as_tensor(K).to(device=dev, dtype=dtype))

    def frame(i):
        return tree_map(lambda a: a[i], frames)

    def stack(outs):
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    outs = []
    if window is None or window >= capacity:
        step = make_incremental_step(
            iterations, gate_threshold, soft_gate_alpha, soft_gate_power, robust_delta
        )
        for i in range(n):
            graph, out = step(graph, (i, frame(i), first_Twc))
            outs.append(out)
        return (graph, *stack(outs))

    prior = win_mod.CubePrior.empty(n_obj, dtype, dev)
    if point_obs is not None:
        if K is None:
            raise ValueError("point_obs requires K (projection intrinsics)")
        obs_uv = torch.as_tensor(point_obs[0]).to(device=dev, dtype=dtype)
        obs_mask = torch.as_tensor(point_obs[1]).to(device=dev, dtype=torch.bool)
        P = obs_uv.shape[1]
        if len(point_obs) > 2:
            ground = torch.as_tensor(point_obs[2]).to(device=dev, dtype=torch.bool)
        else:
            ground = torch.zeros((n, P), dtype=torch.bool, device=dev)
        step = make_windowed_point_step(
            window, graph.K, iterations, gate_threshold, soft_gate_alpha,
            soft_gate_power, robust_delta, point_weight=point_weight,
            **(point_opts or {}),
        )
        carry = (graph, prior, PointState.empty(capacity, P, dtype, dev))
        no_respawn = torch.zeros((P,), dtype=torch.bool, device=dev)  # pre-built tracks
        for i in range(n):
            carry, out = step(
                carry,
                (i, frame(i), first_Twc, obs_uv[i], obs_mask[i], no_respawn, ground[i]),
            )
            outs.append(out[:2])
        return (carry[0], *stack(outs))

    step = make_windowed_step(
        window, iterations, gate_threshold, soft_gate_alpha, soft_gate_power, robust_delta
    )
    carry = (graph, prior)
    for i in range(n):
        carry, out = step(carry, (i, frame(i), first_Twc))
        outs.append(out)
    return (carry[0], *stack(outs))
