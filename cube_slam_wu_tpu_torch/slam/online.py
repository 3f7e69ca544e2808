"""Fused online SLAM step.

The whole per-frame step of the online pipeline as one function on device
tensors:

    (state, gray image, yolo boxes, frame index)
        -> (state', Twc pose + report scalars)

Everything between the image coming in and the optimised pose going out
stays on the device:

- line detection (ops.detect) and batched cuboid proposals (ops.proposal);
- IoU tracklet association (ops.association.associate_detections) + the
  tracklet book state transitions (spawn into free slots, accept, retire)
  as device arrays;
- ground->camera measurement assembly with yaw canonicalization
  (main_obj.cpp:649-675, :732);
- the incremental BA step (tracker.make_incremental_step, or with `window=W`
  the fixed-lag tracker.make_windowed_step — constant-velocity init,
  innovation weighting, LM).

Per frame the host (a) ships the grayscale up as uint8 with the boxes (it is
cast to float on the device), and (b) pulls the optimised pose + a handful of
report scalars, one frame late so that the pull overlaps the next frame's
work.  PyTorch runs eagerly, so the step also reads a few flags on the host
while it runs: the Canny hysteresis convergence check, the line-merge
convergence check and the cap-overflow flag that decides the caps-off exact
recompute.  Each is a blocking read; `utils.hostsync` counts them and the
run loop reports them with the pulls (`FusedRunResult.syncs_per_frame`).
The stages carry `utils.hostsync.stage` labels (`online/...`): profiler
ranges, which `tools/profile_step.py` reads, that also split the host reads
by stage.

The state is updated functionally: a step returns new tensors.
"""

from __future__ import annotations

import math
import pathlib
from typing import NamedTuple

import numpy as np
import torch

from cube_slam_wu_tpu_torch import resolve_device
from cube_slam_wu_tpu_torch.core import rotations as rotu
from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.slam import tracker
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph
from cube_slam_wu_tpu_torch.slam.window import CubePrior
from cube_slam_wu_tpu_torch.utils import hostsync
from cube_slam_wu_tpu_torch.utils import io as uio

# intrinsics of the TUM-class sequences the folder reader is written for
TUM_K = np.array([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1.0]])


class OnlineBook(NamedTuple):
    """Device-resident tracklet slots."""

    bbox: torch.Tensor  # (O, 4) last associated detection box (corners)
    alive: torch.Tensor  # (O,) currently matchable
    used: torch.Tensor  # (O,) ever spawned
    last: torch.Tensor  # (O,) int32 frame of last association
    range: torch.Tensor  # (O,) last camera-relative range (-1 = none)
    yaw: torch.Tensor  # (O,) last accepted yaw
    count: torch.Tensor  # (O,) int32 accepted measurements

    @staticmethod
    def empty(n_slots: int, dtype=torch.float32, device="cpu") -> "OnlineBook":
        return OnlineBook(
            bbox=torch.zeros((n_slots, 4), dtype=dtype, device=device),
            alive=torch.zeros(n_slots, dtype=torch.bool, device=device),
            used=torch.zeros(n_slots, dtype=torch.bool, device=device),
            last=torch.full((n_slots,), -1, dtype=torch.int32, device=device),
            range=torch.full((n_slots,), -1.0, dtype=dtype, device=device),
            yaw=torch.zeros(n_slots, dtype=dtype, device=device),
            count=torch.zeros(n_slots, dtype=torch.int32, device=device),
        )


class OnlineState(NamedTuple):
    graph: CameraObjectGraph
    book: OnlineBook
    # fixed-lag smoother prior (slam.window.CubePrior); present but unused
    # when the step runs the full-graph (window=None) path
    prior: CubePrior | None = None


class StepReport(NamedTuple):
    """Per-frame scalars pulled with the pose."""

    cap_overflow: torch.Tensor  # int32 hypotheses shed before fallback
    cap_fallback: torch.Tensor  # bool: exact recompute taken
    no_valid_proposal: torch.Tensor  # bool
    n_matched: torch.Tensor  # int32 measurements accepted
    dropped: torch.Tensor  # int32 new detections without a free slot
    chi2: torch.Tensor  # post-optimization chi2


def _spawn_new_tracks(book: OnlineBook, det_is_new, det_of_track, matched):
    """Assign new detections (ascending det index) to free slots (ascending
    slot index) — the host loop's `for d in nonzero(det_is_new): spawn()`
    vectorized.  Returns (det_of_track, matched, used', alive', dropped)."""
    O = book.used.shape[0]
    D = det_is_new.shape[0]
    dev = det_is_new.device
    free = ~book.used  # (O,)
    free_rank = torch.cumsum(free, 0) - 1  # rank of each free slot
    new_rank = torch.cumsum(det_is_new, 0) - 1  # rank of each new det
    n_new = torch.sum(det_is_new)
    n_free = torch.sum(free)
    # det index for each rank r (scatter; untouched ranks stay D = invalid).
    # Detections that are not new (and new ones beyond O ranks) all write the
    # spare slot O, which is never read for a spawning slot.
    det_for_rank = torch.full((O + 1,), D, dtype=torch.int64, device=dev)
    det_for_rank.scatter_(
        0,
        torch.where(det_is_new, torch.clamp(new_rank, max=O), O),
        torch.arange(D, device=dev),
    )
    spawn = free & (free_rank < n_new)
    d_spawn = det_for_rank[torch.clamp(free_rank, 0, O)].to(det_of_track.dtype)
    det_of_track = torch.where(spawn, d_spawn, det_of_track)
    matched = matched | spawn
    return (
        det_of_track,
        matched,
        book.used | spawn,
        book.alive | spawn,
        (n_new - torch.minimum(n_new, n_free)).to(torch.int32),
    )


def _measurements_from_proposals(
    res, det_of_track, matched, roll0, pitch0, yaw0, cam_t, dtype,
    canonicalize_yaw=True,
):
    """Camera-frame measurements of the matched proposals, over object slots
    on device (main_obj.cpp:649-675; quality :732).  Returns
    (meas9 (O, 9), quality (O,), rng (O,))."""
    D = res.pos.shape[0]
    d = torch.clamp(det_of_track, 0, D - 1).to(torch.int64)
    pos = res.pos[d]
    rotY = res.rotY[d]
    scale = res.scale[d]
    nerr = res.normalized_error[d]
    rdel = res.camera_roll_delta[d]
    pdel = res.camera_pitch_delta[d]

    half_pi = math.pi / 2
    yaw_init = yaw0 - half_pi
    if canonicalize_yaw:
        k = torch.round((rotY - yaw_init) / half_pi)
    else:
        k = torch.zeros_like(rotY)
    yaw_c = rotY - k * half_pi
    swap = torch.remainder(k.to(torch.int32), 2) != 0
    sl = torch.where(swap, scale[:, 1], scale[:, 0])
    sw = torch.where(swap, scale[:, 0], scale[:, 1])
    zeros = torch.zeros_like(yaw_c)
    cube_ground = Cuboid.from_minimal(
        torch.stack(
            [pos[:, 0], pos[:, 1], pos[:, 2], zeros, zeros, yaw_c,
             sl, sw, scale[:, 2]],
            dim=-1,
        )
    )
    R_new = rotu.euler_zyx_to_rot(roll0 + rdel, pitch0 + pdel, yaw0.expand(rdel.shape))
    pose_used = SE3.from_rot_trans(R_new, cam_t.expand(rdel.shape[0], 3))
    local = cube_ground.transform_to(pose_used)
    meas9 = local.to_minimal()
    quality = (1.0 - nerr + 0.5) / 2.0
    rng = torch.linalg.norm(pos - cam_t[None, :], dim=-1)
    z = torch.zeros_like(quality)
    return (
        torch.where(matched[:, None], meas9, 0.0),
        torch.where(matched, quality, z),
        torch.where(matched, rng, z),
    )


def make_online_step(
    K_np: np.ndarray,
    T0_np: np.ndarray,
    capacity: int,
    dtype=torch.float32,
    detect_cfg=None,
    proposal_overrides: dict | None = None,
    max_objects: int = 1,
    max_detections: int = 1,
    min_iou: float = 0.3,
    iterations: int = 5,
    soft_gate_alpha: float | None = 1.0,
    soft_gate_power: float = 1.0,
    robust_delta: float | None = None,
    bbox_edge_weight: float = 0.005,
    window: int | None = None,
    canonicalize_yaw: bool = True,
    track_max_age: int | None = None,
    exact_fallback: bool = True,
    sample_cam_roll_pitch: bool = True,
    device=None,
):
    """Build the fused per-frame step for the TUM-class online pipeline
    (fixed first camera pose fed to the proposal engine, main_obj.cpp:
    624-628; constant-velocity BA pose init).

    `device=None` means the card (raises without one); the CPU is used only
    on `device="cpu"`.

    `window=W < capacity` runs the fixed-lag smoother: only the trailing W
    frames are optimised and `state.prior` (a `CubePrior`) carries what the
    departed frames knew of the landmarks.

    Returns step(state, gray_u8 (H, W) uint8, boxes_c (D, 4) corners,
    det_mask (D,), i int) -> (state', (Twc (7,) [x y z qw qx qy qz],
    StepReport)), all tensors on `device`.

    Frame 0 needs its own instance (sample_cam_roll_pitch=False, the
    reference samples roll/pitch only after the first frame)."""
    from cube_slam_wu_tpu_torch.ops.association import associate_detections
    from cube_slam_wu_tpu_torch.ops.detect import DetectConfig, detector_for
    from cube_slam_wu_tpu_torch.ops.proposal import (
        ProposalConfig, caps_off, detect_cuboids, driver_overrides,
    )

    dev = resolve_device(device)
    detect_cfg = detect_cfg or DetectConfig()
    detect_line_segments = detector_for(detect_cfg)
    over = driver_overrides(proposal_overrides)
    O, D = max_objects, max_detections

    T0 = np.asarray(T0_np, np.float64)
    T0_64 = torch.as_tensor(T0)
    roll0, pitch0, yaw0 = (
        v.to(device=dev, dtype=dtype) for v in rotu.rot_to_euler_zyx(T0_64[:3, :3])
    )
    K = torch.as_tensor(np.asarray(K_np, np.float64)).to(device=dev, dtype=dtype)
    T0_t = T0_64.to(device=dev, dtype=dtype)
    cam_t = T0_t[:3, 3]
    first_Twc = SE3.from_matrix(T0_t)

    windowed = window is not None and window < capacity
    if windowed:
        ba_step = tracker.make_windowed_step(
            window, iterations, None, soft_gate_alpha, soft_gate_power, robust_delta
        )
    else:
        ba_step = tracker.make_incremental_step(
            iterations, None, soft_gate_alpha, soft_gate_power, robust_delta
        )

    true_t = torch.ones((), dtype=torch.bool, device=dev)

    def step(state: OnlineState, gray_u8, boxes_c, det_mask, i):
        i = int(i)
        graph, book = state.graph, state.book

        # the image ships as uint8 (rounded BT.601 grayscale is exactly
        # u8-representable) — 4x fewer bytes through the host->device link
        # than f32; cast on device.
        gray32 = gray_u8.to(torch.float32)
        # ---- line detection (always f32: dtype-pinned line sets) ------------
        with hostsync.stage("online/detect_lines"):
            lines32, lmask = detect_line_segments(gray32, detect_cfg)
        lines = lines32.to(dtype)
        gray = gray32.to(dtype)

        # ---- batched proposals at the FIXED first pose ----------------------
        cfg = ProposalConfig(
            max_lines=int(lines.shape[0]),
            sample_cam_roll_pitch=sample_cam_roll_pitch,
            **over,
        )
        boxes_c = boxes_c.to(dtype)
        xywh = torch.stack(
            [
                boxes_c[:, 0] - 1.0,  # matlab -1 offset (main_obj.cpp:620)
                boxes_c[:, 1] - 1.0,
                boxes_c[:, 2] - boxes_c[:, 0],
                boxes_c[:, 3] - boxes_c[:, 1],
            ],
            dim=-1,
        )
        with hostsync.stage("online/proposals"):
            res = detect_cuboids(gray, K, T0_t, xywh, det_mask, lines, lmask, cfg)
        overflow = torch.sum(res.cap_overflow).to(torch.int32)
        fallback = torch.zeros((), dtype=torch.bool, device=dev)
        if exact_fallback:
            # caps-off exact recompute.  The decision is data-dependent, so
            # the overflow flag is read on the host: one blocking read per
            # frame, counted by utils.hostsync.
            fallback = overflow > 0
            with hostsync.stage("online/cap_check"):
                refine = hostsync.host_bool(fallback)
            if refine:
                with hostsync.stage("online/proposals_caps_off"):
                    res = detect_cuboids(
                        gray, K, T0_t, xywh, det_mask, lines, lmask, caps_off(cfg)
                    )
        det_valid = res.valid & det_mask
        any_valid = torch.any(det_valid)

        # ---- tracklet association + book update -----------------------------
        alive = book.alive
        if track_max_age is not None:
            alive = alive & (i - book.last <= track_max_age)
        det_of_track, matched, det_is_new = associate_detections(
            book.bbox, alive, boxes_c, det_valid, min_iou=min_iou
        )
        det_of_track, matched, used, alive, dropped = _spawn_new_tracks(
            book._replace(alive=alive), det_is_new, det_of_track, matched
        )

        meas9, quality, rng = _measurements_from_proposals(
            res, det_of_track, matched, roll0, pitch0, yaw0, cam_t, dtype,
            canonicalize_yaw=canonicalize_yaw,
        )

        dsafe = torch.clamp(det_of_track, 0, D - 1).to(torch.int64)
        box_of_track = boxes_c[dsafe]
        book = OnlineBook(
            bbox=torch.where(matched[:, None], box_of_track, book.bbox),
            alive=alive,
            used=used,
            last=torch.where(matched, torch.full_like(book.last, i), book.last),
            range=torch.where(matched, rng, book.range),
            yaw=torch.where(matched, res.rotY[dsafe].to(dtype), book.yaw),
            count=book.count + matched.to(torch.int32),
        )

        # ---- frame assembly + incremental BA --------------------------------
        x0, y0, x1, y1 = (box_of_track[:, j] for j in range(4))
        bbox_cxywh = torch.stack(
            [(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1
        )
        frame = tracker.FrameInput(
            meas=Cuboid.from_minimal(meas9),
            quality=quality,
            has_meas=matched,
            active=true_t,
            bbox=torch.where(matched[:, None], bbox_cxywh, 0.0),
            bbox_weight=torch.where(
                matched, torch.full_like(quality, bbox_edge_weight), torch.zeros_like(quality)
            ),
        )
        prior = state.prior
        with hostsync.stage("online/insert_and_ba"):
            if windowed:
                (graph, prior), (chi2, _) = ba_step(
                    (graph, prior), (i, frame, first_Twc)
                )
            else:
                graph, (chi2, _) = ba_step(graph, (i, frame, first_Twc))

        Twc = graph.cam_Tcw[i].inverse()
        out = (
            torch.cat([Twc.trans, Twc.quat]),
            StepReport(
                cap_overflow=overflow,
                cap_fallback=fallback,
                no_valid_proposal=~any_valid,
                n_matched=torch.sum(matched & any_valid).to(torch.int32),
                dropped=dropped,
                chi2=chi2,
            ),
        )
        return OnlineState(graph, book, prior), out

    return step


class FusedRunResult(NamedTuple):
    traj_Twc_xyzq: np.ndarray  # (N, 7)
    cubes_minimal: np.ndarray  # (O, 9)
    cube_valid: np.ndarray  # (O,)
    chi2: np.ndarray  # (N,)
    report: dict  # aggregated counters
    syncs_per_frame: float  # measured blocking host reads / frame
    bytes_up_per_frame: float
    bytes_down_per_frame: float
    # (O,) objects the fixed-lag prior holds; None on the full-graph path
    prior_valid: np.ndarray | None = None


def run_online_frames(
    frames,
    K_np: np.ndarray,
    T0_np: np.ndarray,
    n_frames: int,
    dtype=torch.float32,
    max_objects: int = 1,
    max_detections: int = 1,
    overlap: bool = True,
    capacity: int | None = None,
    device=None,
    on_frame=None,
    **step_kwargs,
) -> FusedRunResult:
    """The core loop of the fused online pipeline over in-memory frames.

    `frames` yields `(gray_u8 (H, W) uint8, boxes_c (D, 4) corner boxes,
    det_mask (D,) bool)` as numpy arrays, `n_frames` of them; `K_np` are the
    intrinsics and `T0_np` the fixed camera-to-world pose of frame 0.
    `on_frame(i)` (optional) is called after frame i was enqueued.

    `window=W` (passed on to `make_online_step`) runs the fixed-lag smoother
    when W is below the capacity.

    With `overlap=True` the pose of frame i-1 is pulled while frame i's work
    is in flight (one-frame latency, standard double buffering).

    The transfer accounting is measured, not modelled: every blocking host
    read made while the loop runs (the per-frame pulls, the flags read inside
    the step, and the final pull of trajectory and landmarks) is counted in
    `syncs_per_frame`, and every byte copied either way in the byte counts.
    """
    dev = resolve_device(device)
    n = int(n_frames)
    capacity = capacity or n
    D = max_detections

    def mk(**kw):
        return make_online_step(
            K_np, T0_np, capacity, dtype,
            max_objects=max_objects, max_detections=D, device=dev,
            **step_kwargs, **kw,
        )

    step0 = mk(sample_cam_roll_pitch=False)  # main_obj.cpp:624
    stepN = mk(sample_cam_roll_pitch=True)

    graph = CameraObjectGraph.empty(capacity, max_objects, dtype, dev)._replace(
        K=torch.as_tensor(np.asarray(K_np, np.float64)).to(device=dev, dtype=dtype)
    )
    window = step_kwargs.get("window")
    prior = None
    if window is not None and window < capacity:
        prior = CubePrior.empty(max_objects, dtype, dev)
    state = OnlineState(graph, OnlineBook.empty(max_objects, dtype, dev), prior)

    start = hostsync.snapshot()
    outs = []
    pending = None

    def pull(p):
        pose, rep = p
        host = hostsync.pull((pose,) + tuple(rep))
        return host[0], StepReport(*host[1:])

    for i, (gray_np, boxes_c, dmask) in enumerate(frames):
        if i >= n:
            break
        gray = hostsync.push(np.ascontiguousarray(gray_np, dtype=np.uint8), dev)
        boxes_t = hostsync.push(np.asarray(boxes_c, np.float64), dev, dtype)
        dmask_t = hostsync.push(np.asarray(dmask, bool), dev)
        step = step0 if i == 0 else stepN
        state, out = step(state, gray, boxes_t, dmask_t, i)
        if on_frame is not None:
            on_frame(i)
        if overlap:
            if pending is not None:
                outs.append(pull(pending))
            pending = out
        else:
            outs.append(pull(out))
    if pending is not None:
        outs.append(pull(pending))

    final = (state.graph.cam_Twc().to_xyzq(), state.graph.cube.to_minimal(),
             state.graph.cube_valid)
    if state.prior is not None:
        final += (state.prior.valid,)
    traj, cubes, cube_valid, *prior_valid = hostsync.pull(final)
    end = hostsync.snapshot()
    n_done = max(len(outs), 1)
    report = dict(
        cap_overflow=int(sum(int(o[1].cap_overflow) for o in outs)),
        cap_fallbacks=int(sum(bool(o[1].cap_fallback) for o in outs)),
        no_valid_proposal=int(sum(bool(o[1].no_valid_proposal) for o in outs)),
        n_measurements=int(sum(int(o[1].n_matched) for o in outs)),
        dropped=int(sum(int(o[1].dropped) for o in outs)),
    )
    return FusedRunResult(
        traj_Twc_xyzq=np.asarray(traj),
        cubes_minimal=np.asarray(cubes),
        cube_valid=np.asarray(cube_valid),
        chi2=np.asarray([float(o[1].chi2) for o in outs]),
        report=report,
        syncs_per_frame=(end["syncs"] - start["syncs"]) / n_done,
        bytes_up_per_frame=(end["h2d_bytes"] - start["h2d_bytes"]) / n_done,
        bytes_down_per_frame=(end["d2h_bytes"] - start["d2h_bytes"]) / n_done,
        prior_valid=np.asarray(prior_valid[0]) if prior_valid else None,
    )


def sequence_frames(images, detections, max_detections: int):
    """Frames for `run_online_frames` from in-memory images (H, W) uint8 and
    per-frame detection rows `x y w h conf` (1-based x/y as in the
    reference's txts)."""
    for img, det in zip(images, detections):
        boxes_c, _conf, dmask = uio.detections_from_rows(det, n_max=max_detections)
        yield np.asarray(img, np.uint8), boxes_c, dmask


def run_online_slam_fused(
    base_folder,
    n_frames: int | None = None,
    dtype=torch.float32,
    max_objects: int = 1,
    max_detections: int = 1,
    overlap: bool = True,
    capacity: int | None = None,
    K_np: np.ndarray | None = None,
    device=None,
    **step_kwargs,
) -> FusedRunResult:
    """Drive the fused step over the reference TUM dataset layout
    (`truth_cam_poses.txt`, `raw_imgs/%04d_rgb_raw.jpg`,
    `filter_2d_obj_txts/%04d_yolo2_0.15.txt`): a thin reader on top of
    `run_online_frames` (it needs Pillow to decode the images).

    A frame whose image file is missing is fed as a black image of the first
    frame's size; a missing detection file means no detections."""
    resolve_device(device)  # fail before touching any file
    base = pathlib.Path(base_folder)
    truth = uio.read_number_txt(base / "truth_cam_poses.txt")
    n = truth.shape[0] if n_frames is None else min(n_frames, truth.shape[0])
    K_np = TUM_K if K_np is None else np.asarray(K_np, np.float64)
    first = SE3.from_xyzq(torch.as_tensor(truth[0, 1:8]).to(dtype))
    T0_np = first.matrix().to(torch.float64).numpy()
    D = max_detections

    def frames():
        shape = None
        for i in range(n):
            img_path = base / "raw_imgs" / f"{i:04d}_rgb_raw.jpg"
            det_path = base / "filter_2d_obj_txts" / f"{i:04d}_yolo2_0.15.txt"
            if img_path.exists():
                gray_np = uio.load_image_gray(img_path).astype(np.uint8)
                shape = gray_np.shape
            else:
                if shape is None:
                    shape = _first_image_shape(base, n)
                gray_np = np.zeros(shape, np.uint8)
            if det_path.exists():
                boxes_c, _conf, dmask = uio.read_detections_txt(det_path, n_max=D)
            else:
                boxes_c = np.zeros((D, 4))
                dmask = np.zeros(D, bool)
            yield gray_np, boxes_c, dmask

    return run_online_frames(
        frames(), K_np, T0_np, n, dtype=dtype, max_objects=max_objects,
        max_detections=D, overlap=overlap, capacity=capacity, device=device,
        **step_kwargs,
    )


def _first_image_shape(base: pathlib.Path, n: int):
    """Shape of the first image file that exists among the first n frames."""
    for i in range(n):
        p = base / "raw_imgs" / f"{i:04d}_rgb_raw.jpg"
        if p.exists():
            return uio.load_image_gray(p).shape
    raise FileNotFoundError(f"no image under {base / 'raw_imgs'}")
