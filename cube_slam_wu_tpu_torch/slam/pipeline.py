"""The SLAM drivers over frame sequences: the TUM dataset's two-phase online
and offline drivers, and the KITTI driver.

One per-frame front end serves every frame loop (`_FrontEnd`, built once per
run from the driver's arguments): take the frame in, detect its lines (and
track them by LBD descriptors), propose one cuboid per 2D detection in one
batch, rerun the frame with the caps off where a cap bound, then associate
the proposals into fixed object slots by IoU (a host-side tracklet book) and
turn each into a camera-frame measurement.  Two loops drive it:

- the two-phase loop (`_frontend_frames`): every frame's proposals at the
  fixed first camera pose, optionally with the track's yaw prior and a depth
  gate, then one `tracker.run_incremental` pass.  `run_online_frontend` and
  `run_online_slam` run it over the TUM layout (the reference's
  object_slam/data, fixed TUM fr3 intrinsics; `run_online_slam` optionally
  adds point tracks to the windowed BA and a joint point polish,
  `_point_refinement`), and `run_kitti_frames(pose_feedback=False)` over
  KITTI frames, the reference's schedule;
- the interleaved loop (`_run_kitti_tracked`, `run_kitti_frames(
  pose_feedback=True)`): each frame's proposals at the tracker's
  constant-velocity predicted pose, a 3D association gate against the
  landmarks, and the BA step right after; with `point_weight > 0`, Harris +
  ZNCC point tracks (slam.features.IncrementalTracker) in the windowed joint
  camera + cuboid + point BA (tracker.make_windowed_point_step).

`run_offline_slam` replays the saved cuboids (detect_cuboids_saved.txt at
the poses of pop_cam_poses_saved.txt, main_obj.cpp:682-722);
`run_kitti_slam` reads the KITTI odometry layout (Pillow decodes the images)
and calls `run_kitti_frames`.  As in the JAX package, the association policy
and the tracklet book live on the host; the device work of a frame comes
back in a few counted reads (utils.hostsync): the feature tracker's result,
the proposals with the line-track match flags, the BA step's outputs with the
next frame's pose and gate caches, and the flags the detector and the
proposal engine read while they run.  The stages carry `utils.hostsync.stage`
labels (`kitti/...`, `tum/...`, `offline/...`): profiler ranges for
tools/profile_step.py that also split the host reads by stage, and what the
benchmark's per-layer metrics read.
"""

from __future__ import annotations

import pathlib
from typing import NamedTuple

import numpy as np
import torch

from cube_slam_wu_tpu_torch import resolve_device
from cube_slam_wu_tpu_torch.core import rotations as rotu
from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.slam import tracker
from cube_slam_wu_tpu_torch.slam.online import TUM_K  # the folder readers fix these intrinsics
from cube_slam_wu_tpu_torch.utils import hostsync
from cube_slam_wu_tpu_torch.utils import io as uio
from cube_slam_wu_tpu_torch.utils import kitti as ukitti


class FrontendReport(NamedTuple):
    """Per-run accounting of skipped/failed frames: pipeline-level failures
    are surfaced instead of silently continued."""

    n_frames: int
    missing_image: list
    missing_detections: list
    empty_detections: list
    no_valid_proposal: list
    dropped_detections: int  # valid detections with no free object slot
    far_spawns: int = 0  # new-object spawns skipped by spawn_range_m
    # frames where a binding ProposalConfig.dist_gather_cap shed valid
    # hypotheses; each such frame is recomputed with the exact full gather
    # (cap_fallbacks counts the reruns)
    cap_overflow_frames: int = 0
    cap_fallbacks: int = 0

    def summary(self) -> str:
        return (
            f"frames={self.n_frames} missing_img={len(self.missing_image)} "
            f"missing_det={len(self.missing_detections)} "
            f"empty_det={len(self.empty_detections)} "
            f"no_proposal={len(self.no_valid_proposal)} "
            f"dropped_det={self.dropped_detections} "
            f"far_spawns={self.far_spawns} "
            f"cap_overflow={self.cap_overflow_frames}"
        )

    def counters(self) -> dict:
        """Every counter as a plain int (lists by their length)."""
        return {
            k: (len(v) if isinstance(v, list) else int(v)) for k, v in self._asdict().items()
        }


class SlamOutput(NamedTuple):
    traj_Twc_xyzq: np.ndarray  # (N, 7) x y z qx qy qz qw
    cube_minimal: np.ndarray  # (9,) final cuboid [xyz rpy lwh] (object 0)
    chi2: np.ndarray  # (N,) per-frame final chi2
    timestamps: np.ndarray
    cube_history: np.ndarray | None = None  # (N, O, 9) per-frame optimized
    cubes_minimal: np.ndarray | None = None  # (O, 9) all object landmarks
    cube_valid: np.ndarray | None = None  # (O,) landmark initialised
    frontend_report: "FrontendReport | None" = None
    # the windowed paths' landmark prior and the point landmarks at the end
    # (None where the mode has none)
    prior_valid: np.ndarray | None = None  # (O,)
    points: np.ndarray | None = None  # (P, 3)
    point_valid: np.ndarray | None = None  # (P,)


class FrameResult(NamedTuple):
    """What the interleaved KITTI loop hands its `on_result` hook after frame
    i: the values of the frame's one read, and references to device tensors
    (no copy, no read) of the step's input and of its carry before and after
    the step.  The step is functional, so the references stay valid."""

    i: int
    chi2: float  # the step's final chi2
    cubes_minimal: np.ndarray  # (O, 9) the landmarks [xyz rpy lwh]
    Tcw: np.ndarray  # (4, 4) frame i's optimized world-to-camera pose
    Tcw_prev: np.ndarray  # (4, 4) frame i-1's (frame 0's at i = 0)
    cube_pos: np.ndarray  # (O, 3) landmark positions
    cube_valid: np.ndarray  # (O,) landmark initialised
    lm_accepted: int | None  # LM iterations whose step was taken (points mode)
    ba_points: int | None  # valid points in the window's solve (points mode)
    step_input: tuple  # the step's input (index, FrameInput, first pose[, points])
    carry_before: tuple  # the step's carry before frame i
    carry_after: tuple  # and after it


class _HostProposals(NamedTuple):
    """The fields of a frame's ProposalResult the host policy reads."""

    valid: np.ndarray
    pos: np.ndarray
    rotY: np.ndarray
    scale: np.ndarray
    normalized_error: np.ndarray
    camera_roll_delta: np.ndarray
    camera_pitch_delta: np.ndarray
    cap_overflow: np.ndarray


def _pull_proposals(res, extra=()):
    """One counted read: the proposal fields the host needs, plus `extra`
    device tensors.  Returns (_HostProposals, extra as numpy)."""
    fields = tuple(getattr(res, f) for f in _HostProposals._fields)
    host = hostsync.pull(fields + tuple(extra))
    return _HostProposals(*host[: len(fields)]), host[len(fields):]


def _associate_local(book, boxes_c, det_valid, min_iou):
    """The (O x D) IoU association on the host's CPU: microseconds of work
    next to the host-side book, no device round trip."""
    from cube_slam_wu_tpu_torch.ops.association import associate_detections

    f64 = torch.float64
    out = associate_detections(
        torch.as_tensor(np.asarray(book.bbox), dtype=f64),
        torch.as_tensor(np.asarray(book.alive)),
        torch.as_tensor(np.asarray(boxes_c), dtype=f64),
        torch.as_tensor(np.asarray(det_valid)),
        min_iou=min_iou,
    )
    return tuple(np.array(v.numpy()) for v in out)


def _se3_inv_mat(T: np.ndarray) -> np.ndarray:
    """Exact inverse of a rigid 4x4 (R^T, -R^T t) on the host."""
    out = np.eye(4)
    R = T[:3, :3]
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ T[:3, 3]
    return out


def _assemble_frame(meas9, quality, has, bbox, w, device, dtype) -> tracker.FrameInput:
    """Measurements as a FrameInput on the device (host arrays pushed once
    each): one frame's, (O, ...), or a sequence's, (N, O, ...); the 2D box
    edges weighted `w` on every measured slot."""
    has_t = hostsync.push(np.asarray(has, bool), device)
    quality_t = hostsync.push(np.asarray(quality, np.float64), device, dtype)
    w_t = torch.full_like(quality_t, float(w))
    return tracker.FrameInput(
        meas=Cuboid.from_minimal(hostsync.push(np.asarray(meas9, np.float64), device, dtype)),
        quality=quality_t,
        has_meas=has_t,
        active=torch.ones(has_t.shape[:-1], dtype=torch.bool, device=device),
        bbox=hostsync.push(np.asarray(bbox, np.float64), device, dtype),
        bbox_weight=torch.where(has_t, w_t, torch.zeros_like(w_t)),
    )


def _post_step_state(g, i: int):
    """Everything the next frame's host-side prediction and association gate
    need, as device tensors to be pulled with the step's outputs."""
    return (
        g.cam_Tcw[i].matrix(),
        g.cam_Tcw[max(i - 1, 0)].matrix(),
        g.cube.pose.trans,
        g.cube_valid,
    )


class _TrackletBook:
    """Host-side tracklet slots of the front end: per-slot last-box /
    liveness / association bookkeeping.  Association *policy* (IoU
    matching, spawn gates, the loops' depth and 3D gates) stays in
    `_FrontEnd` and the loops.  Slots are never reused once retired — a
    retired slot's landmark estimate belongs to the old object."""

    _KEYS = (
        "track_bbox", "track_alive", "track_used", "track_last",
        "track_range", "track_yaw", "meas_count",
    )

    def __init__(self, n_slots: int):
        self.bbox = np.zeros((n_slots, 4))  # last associated box (corners)
        self.alive = np.zeros(n_slots, bool)  # currently matchable
        self.used = np.zeros(n_slots, bool)  # ever spawned
        self.last = np.full(n_slots, -1)  # frame of last association
        self.range = np.full(n_slots, -1.0)  # last camera-relative range
        self.yaw = np.full(n_slots, np.nan)  # last accepted yaw
        self.count = np.zeros(n_slots, np.int64)  # accepted measurements

    def _arrays(self):
        return (self.bbox, self.alive, self.used, self.last, self.range,
                self.yaw, self.count)

    def retire_stale(self, i: int, max_age: int | None) -> None:
        """Stop matching tracks not associated for > max_age frames (a stale
        box left where an object exited otherwise captures the next object
        entering near that image position)."""
        if max_age is not None:
            self.alive[self.alive & (i - self.last > max_age)] = False

    def spawn(self) -> int | None:
        """Claim the first never-used slot; None when all are taken."""
        free = np.nonzero(~self.used)[0]
        if free.size == 0:
            return None
        o = int(free[0])
        self.alive[o] = True
        self.used[o] = True
        return o

    def accept(self, o: int, i: int, box, rng: float, yaw: float) -> None:
        self.bbox[o] = box
        self.last[o] = i
        self.range[o] = rng
        self.yaw[o] = yaw
        self.count[o] += 1

    def state(self) -> dict:
        return dict(zip(self._KEYS, self._arrays()))

    def load_state(self, data) -> None:
        for key, arr in zip(self._KEYS, self._arrays()):
            if key in data:  # older checkpoints lack some keys
                arr[:] = data[key]


def _proposal_measurement(res, d: int, roll, pitch, yaw, cam_t, dtype, canonicalize_yaw=True):
    """Ground-frame proposal row `d` -> (camera-frame 9-DoF measurement, fit
    quality, camera-relative range), computed on the host's CPU in `dtype`.
    Mirrors the reference's measurement assembly (main_obj.cpp:649-675;
    quality :732).

    Canonicalizes the front face: rotates yaw by the multiple of 90 deg that
    brings it nearest the facing-the-camera init (camera_yaw - 90,
    box_proposal_detail.cpp:180), swapping l/w on odd multiples.  The camera
    pose used for the transform carries the proposal's sampled roll/pitch
    deltas (main_obj.cpp:667-675)."""
    yaw_init = yaw - np.pi / 2
    rot_y = float(res.rotY[d])
    k = int(np.round((rot_y - yaw_init) / (np.pi / 2))) if canonicalize_yaw else 0
    yaw_c = rot_y - k * (np.pi / 2)
    s = res.scale[d]
    sl, sw = (float(s[1]), float(s[0])) if k % 2 else (float(s[0]), float(s[1]))
    t = lambda v: torch.as_tensor(v, dtype=torch.float64).to(dtype)
    cube_ground = Cuboid.from_minimal(
        t([*(float(v) for v in res.pos[d]), 0.0, 0.0, yaw_c, sl, sw, float(s[2])])
    )
    R_new = rotu.euler_zyx_to_rot(
        t(roll + float(res.camera_roll_delta[d])),
        t(pitch + float(res.camera_pitch_delta[d])),
        t(yaw),
    )
    pose_used = SE3.from_rot_trans(R_new, t(np.asarray(cam_t, np.float64)))
    local = cube_ground.transform_to(pose_used)
    quality = (1.0 - float(res.normalized_error[d]) + 0.5) / 2.0
    rng = float(np.linalg.norm(np.asarray(res.pos[d], np.float64) - np.asarray(cam_t)))
    return local.to_minimal().to(torch.float64).numpy(), quality, rng


def _line_track_quality(boxes_c, d, lmask, mids, line_matched):
    """Fraction of the detection ROI's lines with a frame-to-frame
    descriptor match: unstable line sets imply an unstable proposal."""
    x0b, y0b, x1b, y1b = boxes_c[d]
    mx, my = (x0b + x1b) / 2, (y0b + y1b) / 2
    hw = (x1b - x0b) * 0.6 + 10
    hh = (y1b - y0b) * 0.6 + 10
    roi = lmask & (np.abs(mids[:, 0] - mx) < hw) & (np.abs(mids[:, 1] - my) < hh)
    return float(line_matched[roi].mean()) if roi.any() else 0.0


class _LineTracker:
    """Frame-to-frame LBD line tracking on the device: the previous frame's
    float descriptors matched to this frame's (guided by midpoint motion).
    `track` returns the device tensors (matched flags, line midpoints) that
    the caller pulls with the proposals, or None on the first frame."""

    def __init__(self, gate: float, stage_prefix: str):
        self.gate = gate
        self.prev = None
        self.label = f"{stage_prefix}/lbd"

    def track(self, gray32, lines32, lmask):
        from cube_slam_wu_tpu_torch.ops import lbd as lbd_ops

        with hostsync.stage(self.label):
            desc, dvalid = lbd_ops.lbd_descriptors(gray32, lines32, lmask)
            dvalid = dvalid & lmask
            out = None
            if self.prev is not None:
                prev_lines, prev_valid, prev_desc = self.prev
                _, _, matched = lbd_ops.l2_match(
                    desc, prev_desc, dvalid, prev_valid,
                    query_lines=lines32, train_lines=prev_lines,
                    max_midpoint_dist=self.gate,
                )
                out = (matched, 0.5 * (lines32[:, 0:2] + lines32[:, 2:4]))
            self.prev = (lines32, dvalid, desc)
        return out


class _PathFrames:
    """Frames of a KITTI-layout sequence from (image path, detections path)
    pairs: item i is (gray (H, W) uint8 or None when the image file is
    missing, detection rows `x y w h conf` or None when the detections file
    is missing).  Decodes on access (Pillow)."""

    def __init__(self, specs):
        self.specs = [(pathlib.Path(a), pathlib.Path(b)) for a, b in specs]

    def __len__(self):
        return len(self.specs)

    def __getitem__(self, i):
        img, det = self.specs[i]
        gray = uio.load_image_gray(img).astype(np.uint8) if img.exists() else None
        rows = uio.read_number_txt(det) if det.exists() else None
        return gray, rows


def _xywh(boxes_c):
    """Corner boxes -> [x y w h] with the matlab -1 offset (main_obj.cpp:620)."""
    b = np.asarray(boxes_c, np.float64)
    return np.column_stack([b[:, 0] - 1.0, b[:, 1] - 1.0, b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]])


class _FrontEnd:
    """The per-frame front end of both frame loops, built once per run from
    the driver's arguments: a frame taken in (`take`), its lines and cuboid
    proposals (`propose`), then the proposals associated into the host-side
    tracklet book and measured (`associate`).  It keeps the run's
    FrontendReport.  Each loop keeps the pose it anchors the proposals at
    and its own association gate.

    Stages: `<stage_prefix>/detect_lines`, `/lbd` (the line tracks) and
    `/proposals` (the caps-off rerun included); the uploads and the
    proposals' one read sit outside every stage."""

    def __init__(self, n, K_np, dtype, dev, detect, detect_cfg, proposal_overrides, max_objects,
                 max_detections, min_iou, track_max_age, spawn_range_m, range_weight_m,
                 line_track_weight, line_track_gate, canonicalize_yaw=True, stage_prefix="kitti"):
        from cube_slam_wu_tpu_torch.ops.proposal import driver_overrides

        self.dtype, self.dev, self.prefix = dtype, dev, stage_prefix
        self.detect, self.detect_cfg = detect, detect_cfg
        self.over = driver_overrides(proposal_overrides)
        self.K = torch.as_tensor(np.asarray(K_np, np.float64)).to(device=dev, dtype=dtype)
        self.book = _TrackletBook(max_objects)
        self.report = FrontendReport(n, [], [], [], [], 0)
        self.lines_tr = _LineTracker(line_track_gate, stage_prefix) if line_track_weight > 0.0 else None
        self.O, self.D, self.min_iou, self.track_max_age = max_objects, max_detections, min_iou, track_max_age
        self.spawn_range_m, self.range_weight_m = spawn_range_m, range_weight_m
        self.line_track_weight, self.canonicalize_yaw = line_track_weight, canonicalize_yaw

    def _count(self, *counters):
        self.report = self.report._replace(**{k: getattr(self.report, k) + 1 for k in counters})

    def upload(self, gray_u8):
        """An image on the device as float32; it ships as uint8, a quarter
        of the bytes."""
        return hostsync.push(np.ascontiguousarray(gray_u8, np.uint8), self.dev).to(torch.float32)

    def take(self, i, gray_u8, rows, upload_any_image=False):
        """Frame i in: (ok, gray32, boxes_c, dmask).  A missing image, a
        missing detections file or a frame without detections is reported
        and not ok.  The image is uploaded once the frame is ok, or with
        `upload_any_image` whenever there is one; `gray32` is None where it
        was not, `boxes_c` and `dmask` where there are no detection rows."""
        if gray_u8 is None:
            self.report.missing_image.append(i)
            return False, None, None, None
        gray32 = self.upload(gray_u8) if upload_any_image else None
        if rows is None:
            self.report.missing_detections.append(i)
            return False, gray32, None, None
        boxes_c, _conf, dmask = uio.detections_from_rows(rows, n_max=self.D)
        if not dmask.any():
            self.report.empty_detections.append(i)
            return False, gray32, boxes_c, dmask
        return True, self.upload(gray_u8) if gray32 is None else gray32, boxes_c, dmask

    def propose(self, i, gray32, boxes_c, dmask, T_wc, yaw_prior=None):
        """Frame i's lines (always detected in float32: dtype-pinned line
        sets), their tracks, and one cuboid proposal per box at the
        camera-to-world pose `T_wc` (a device tensor, or a host (4, 4) array
        uploaded with the boxes), read in one pull with the tracks.  A frame
        on which a cap shed valid hypotheses is proposed again with every cap
        off, so a binding cap never changes a ranking.  `yaw_prior` (a host
        float) is the proposals' temporal yaw prior.  Returns (_HostProposals,
        the line-track arrays or (), the boxes with a valid proposal), or
        None, reported, when no box has one."""
        from cube_slam_wu_tpu_torch.ops.proposal import ProposalConfig, caps_off, detect_cuboids

        with hostsync.stage(f"{self.prefix}/detect_lines"):
            lines32, lmask = self.detect(gray32, self.detect_cfg)
        extra = ()
        if self.lines_tr is not None:
            tracked = self.lines_tr.track(gray32, lines32, lmask)
            if tracked is not None:
                extra = (*tracked, lmask)
        cfg = ProposalConfig(max_lines=int(lines32.shape[0]), sample_cam_roll_pitch=(i != 0), **self.over)
        if not isinstance(T_wc, torch.Tensor):
            T_wc = hostsync.push(T_wc, self.dev, self.dtype)
        args = (gray32.to(self.dtype), self.K, T_wc, hostsync.push(_xywh(boxes_c), self.dev, self.dtype),
                hostsync.push(dmask, self.dev), lines32.to(self.dtype), lmask)
        if yaw_prior is not None:
            yaw_prior = hostsync.push(np.asarray(yaw_prior), self.dev, self.dtype)

        def run(c, extra):
            with hostsync.stage(f"{self.prefix}/proposals"):
                r = detect_cuboids(*args, c, yaw_prior=yaw_prior)
            return _pull_proposals(r, extra)

        res, ex = run(cfg, extra)
        if int(np.sum(res.cap_overflow)) > 0:
            self._count("cap_overflow_frames", "cap_fallbacks")
            res = run(caps_off(cfg), ())[0]
        det_valid = res.valid & dmask
        if not det_valid.any():
            self.report.no_valid_proposal.append(i)
            return None
        return res, ex, det_valid

    def associate(self, i, proposed, boxes_c, cam_t, rpy, veto=None):
        """Frame i's proposals (what `propose` returned) into its
        measurements: stale tracks retired, the IoU association, a match
        dropped where `veto(o, pos)` holds for its slot o and the proposal's
        world position, a slot spawned for each new detection within
        `spawn_range_m` of the camera at `cam_t` (a full book drops it), and
        each matched detection's camera-frame measurement at the camera's
        roll, pitch, yaw `rpy` (`_proposal_measurement`), its quality scaled
        by range and line-track consistency.  Returns (meas9 (O, 9),
        quality (O,), has (O,), bbox [cx cy w h] (O, 4))."""
        res, ex, det_valid = proposed
        book, O = self.book, self.O
        book.retire_stale(i, self.track_max_age)
        det_of_track, matched, det_is_new = _associate_local(book, boxes_c, det_valid, self.min_iou)
        pos = lambda d: np.asarray(res.pos[d], np.float64)  # noqa: E731
        if veto is not None:
            for o in np.nonzero(matched)[0]:
                if veto(o, pos(int(det_of_track[o]))):
                    matched[o] = False
        meas9, quality, has, bbox = np.zeros((O, 9)), np.zeros(O), np.zeros(O, bool), np.zeros((O, 4))
        for d in np.nonzero(det_is_new)[0]:
            if self.spawn_range_m is not None and float(np.linalg.norm(pos(d) - cam_t)) > self.spawn_range_m:
                self._count("far_spawns")
                continue
            o = book.spawn()
            if o is None:
                self._count("dropped_detections")
                continue
            det_of_track[o] = d
            matched[o] = True
        for o in np.nonzero(matched)[0]:
            d = int(det_of_track[o])
            meas9[o], quality[o], rng_d = _proposal_measurement(
                res, d, *rpy, cam_t, self.dtype, canonicalize_yaw=self.canonicalize_yaw,
            )
            book.accept(o, i, boxes_c[d], rng_d, float(res.rotY[d]))
            if self.range_weight_m is not None:
                quality[o] *= min(1.0, (self.range_weight_m / max(rng_d, 1e-6)) ** 2)
            if ex:
                line_matched, mids, lmask_h = ex
                cons = _line_track_quality(boxes_c, d, lmask_h, mids, line_matched)
                quality[o] *= (1.0 - self.line_track_weight) + self.line_track_weight * cons
            x0b, y0b, x1b, y1b = boxes_c[d]
            bbox[o] = [(x0b + x1b) / 2, (y0b + y1b) / 2, x1b - x0b, y1b - y0b]
            has[o] = True
        return meas9, quality, has, bbox


def _with_bbox_weight(frames: tracker.FrameInput, w: float) -> tracker.FrameInput:
    """`frames` with the 2D box edges weighted `w` on every measured slot
    (unchanged for w <= 0)."""
    if w <= 0.0:
        return frames
    q = frames.quality
    return frames._replace(bbox_weight=torch.where(frames.has_meas, torch.full_like(q, w), torch.zeros_like(q)))


def _frontend_frames(fe: _FrontEnd, frames, n: int, T0: np.ndarray, *, depth_gate_m: float | None,
                     checkpoint_path, checkpoint_every: int, use_yaw_prior: bool = False):
    """The two-phase front end over a frame sequence (see
    `run_online_frontend`): every frame's proposals at the fixed
    camera-to-world pose `T0` (4x4), the yaw prior and the depth gate.
    Returns (FrameInput with (N, O) axes on the device, FrontendReport)."""
    dtype, dev, O = fe.dtype, fe.dev, fe.O
    # single-track path: the track's last yaw is each frame's proposal prior
    yaw_prior_on = O == 1 and fe.D == 1 and use_yaw_prior
    rpy0 = tuple(float(v) for v in rotu.rot_to_euler_zyx(torch.as_tensor(T0[:3, :3])))
    T0_t = torch.as_tensor(T0).to(device=dev, dtype=dtype)
    cam_t = T0[:3, 3]
    veto = None
    if depth_gate_m is not None:
        def veto(o, pos):  # the camera-relative range jumps from the track's last
            rng = float(np.linalg.norm(pos - cam_t))
            return fe.book.range[o] >= 0.0 and abs(rng - fe.book.range[o]) > depth_gate_m

    meas9 = np.zeros((n, O, 9))
    quality = np.zeros((n, O))
    has = np.zeros((n, O), bool)
    bbox2d = np.zeros((n, O, 4))  # associated YOLO box as [cx, cy, w, h]

    start_frame = 0
    if checkpoint_path is not None:
        from cube_slam_wu_tpu_torch.slam import checkpoint as ckpt

        def _save(i_next):
            report = fe.report
            ckpt.save_pytree(checkpoint_path, dict(
                i_next=np.asarray(i_next),
                meas9=meas9, quality=quality, has=has, bbox2d=bbox2d,
                **fe.book.state(),
                missing_image=np.asarray(report.missing_image, np.int64),
                missing_detections=np.asarray(report.missing_detections, np.int64),
                empty_detections=np.asarray(report.empty_detections, np.int64),
                no_valid_proposal=np.asarray(report.no_valid_proposal, np.int64),
                dropped=np.asarray(report.dropped_detections),
                far_spawns=np.asarray(report.far_spawns),
                cap_overflow_frames=np.asarray(report.cap_overflow_frames),
                cap_fallbacks=np.asarray(report.cap_fallbacks),
            ))

        cp = ckpt._resolve(checkpoint_path)
        if cp.exists():
            data = np.load(cp)
            # prefix copy: an interrupted run may have been saved with a
            # shorter frame list than this resume (or vice versa)
            m = min(n, data["meas9"].shape[0])
            start_frame = min(int(data["i_next"]), n)
            meas9[:m] = data["meas9"][:m]
            quality[:m] = data["quality"][:m]
            has[:m] = data["has"][:m]
            bbox2d[:m] = data["bbox2d"][:m]
            fe.book.load_state(data)
            get = lambda k: int(data[k]) if k in data else 0
            fe.report = FrontendReport(
                n,
                list(data["missing_image"]),
                list(data["missing_detections"]),
                list(data["empty_detections"]),
                list(data["no_valid_proposal"]),
                int(data["dropped"]),
                get("far_spawns"),
                cap_overflow_frames=get("cap_overflow_frames"),
                cap_fallbacks=get("cap_fallbacks"),
            )

    for i in range(start_frame, n):
        if checkpoint_path is not None and i > start_frame and (i - start_frame) % max(checkpoint_every, 1) == 0:
            _save(i)
        ok, gray32, boxes_c, dmask = fe.take(i, *frames[i])
        if not ok:
            continue
        prior = fe.book.yaw[0] if yaw_prior_on and np.isfinite(fe.book.yaw[0]) else None
        proposed = fe.propose(i, gray32, boxes_c, dmask, T0_t, yaw_prior=prior)
        if proposed is not None:
            meas9[i], quality[i], has[i], bbox2d[i] = fe.associate(i, proposed, boxes_c, cam_t, rpy0, veto)

    if checkpoint_path is not None:
        _save(n)
    # the 2D box edges unweighted: the caller scales them
    return _assemble_frame(meas9, quality, has, bbox2d, 0.0, dev, dtype), fe.report


def run_online_frontend(
    frame_specs,
    K_np: np.ndarray,
    first_Twc: SE3,
    dtype=torch.float32,
    detect_cfg=None,
    proposal_overrides: dict | None = None,
    max_objects: int = 1,
    max_detections: int | None = None,
    min_iou: float = 0.3,
    use_yaw_prior: bool = False,
    canonicalize_yaw: bool = True,
    line_track_weight: float = 0.0,
    line_track_gate: float = 80.0,
    checkpoint_path=None,
    checkpoint_every: int = 25,
    track_max_age: int | None = None,
    depth_gate_m: float | None = None,
    spawn_range_m: float | None = None,
    range_weight_m: float | None = None,
    device=None,
):
    """Multi-object online front-end: per frame, line detection -> batched
    cuboid proposals for every 2D detection -> IoU tracklet association into
    fixed object slots.  Returns (FrameInput with (N, O) axes on the device,
    FrontendReport).

    `frame_specs` is a list of (image_path, detections_path) per frame.  The
    proposals for frames > 0 are generated around the FIRST camera pose with
    roll/pitch sampling (main_obj.cpp:624-628): no tracker feedback enters
    the front-end.

    `depth_gate_m` drops an IoU match whose camera-relative range jumps more
    than this many metres from the track's last accepted range (a handoff
    between objects on a forward drive); `spawn_range_m` refuses to spawn a
    landmark from a detection lifted beyond this range; `range_weight_m`
    scales each accepted measurement's quality by min(1, (R / range)^2);
    `track_max_age` retires a track not associated for that many frames;
    `line_track_weight` scales the quality by the fraction of the box's lines
    matched to the previous frame by LBD descriptors.

    `checkpoint_path` enables elastic resume: every `checkpoint_every`
    frames the accumulated measurements + tracklet state are saved (the JAX
    package's keys); an existing file resumes at the first unprocessed
    frame.  Line-track descriptor state is not checkpointed.

    `use_yaw_prior` (one object, one detection) feeds the track's last
    accepted yaw to each frame's proposals as a temporal prior (the
    reference's box_proposal_detail.cpp:178 TODO); while the track has none
    the frame runs without."""
    from cube_slam_wu_tpu_torch.ops.detect import DetectConfig, detector_for

    dev = resolve_device(device)
    frames = _PathFrames(frame_specs)
    T0 = first_Twc.matrix().to(torch.float64).cpu().numpy()
    detect_cfg = detect_cfg or DetectConfig()
    fe = _FrontEnd(
        len(frames), K_np, dtype, dev, detector_for(detect_cfg), detect_cfg, proposal_overrides,
        max_objects, max_detections or max(1, max_objects), min_iou, track_max_age, spawn_range_m,
        range_weight_m, line_track_weight, line_track_gate, canonicalize_yaw, stage_prefix="tum",
    )
    return _frontend_frames(fe, frames, len(frames), T0, depth_gate_m=depth_gate_m,
                            checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                            use_yaw_prior=use_yaw_prior)


# ---------------------------------------------------------------------------
# the TUM dataset drivers (the reference's object_slam/data layout)
# ---------------------------------------------------------------------------

class OfflineData(NamedTuple):
    pred_objects: np.ndarray  # rows: frame x y z yaw l w h err
    init_poses: np.ndarray  # rows: t x y z qx qy qz qw (pop cam poses)
    truth_poses: np.ndarray  # rows: t x y z qx qy qz qw


def load_offline_dataset(base_folder) -> OfflineData:
    base = pathlib.Path(base_folder)
    return OfflineData(
        pred_objects=uio.read_number_txt(base / "detect_cuboids_saved.txt"),
        init_poses=uio.read_number_txt(base / "pop_cam_poses_saved.txt"),
        truth_poses=uio.read_number_txt(base / "truth_cam_poses.txt"),
    )


def build_offline_frames(data: OfflineData, dtype=torch.float32, device=None) -> tracker.FrameInput:
    """Per-frame measurement inputs from the offline txts
    (main_obj.cpp:682-736): each frame's saved cuboid (the last row for that
    frame) moved into the camera frame of its pop_cam_poses_saved.txt pose,
    with quality (1 - err + 0.5) / 2, on one object axis (O = 1).  All rows
    are transformed in one batch on the device."""
    dev = resolve_device(device)
    n = data.truth_poses.shape[0]
    by_frame = {int(r[0]): r for r in data.pred_objects}
    idx = [i for i in range(n) if i in by_frame]
    rows = np.asarray([by_frame[i] for i in idx], np.float64).reshape(-1, 9)
    meas9 = torch.zeros((n, 9), dtype=dtype, device=dev)
    if idx:
        zero = np.zeros(len(idx))
        cube_pose = np.column_stack([rows[:, 1:4], zero, zero, rows[:, 4:8]])
        cam_pop = SE3.from_xyzq(hostsync.push(data.init_poses[idx, 1:8], dev, dtype))
        local = Cuboid.from_minimal(hostsync.push(cube_pose, dev, dtype)).transform_to(cam_pop)
        meas9 = meas9.index_copy(0, torch.as_tensor(idx, device=dev), local.to_minimal())
    quality = np.zeros((n, 1))
    quality[idx, 0] = (1.0 - rows[:, 8] + 0.5) / 2.0
    has = np.zeros((n, 1), bool)
    has[idx, 0] = True
    return tracker.FrameInput(
        meas=Cuboid.from_minimal(meas9[:, None, :]),
        quality=hostsync.push(quality, dev, dtype),
        has_meas=hostsync.push(has, dev),
        active=torch.ones((n,), dtype=torch.bool, device=dev),
    )


def run_offline_slam(base_folder, iterations: int = 5, dtype=torch.float32, device=None) -> SlamOutput:
    """Offline-mode incremental SLAM over a TUM-layout folder with saved
    cuboids (detect_cuboids_saved.txt + pop_cam_poses_saved.txt, the
    reference's offline replay, main_obj.cpp:682-722 and main():844-904);
    returns the optimized trajectory (camera-to-world, TUM order) like
    output_cam_poses.txt, and object 0's per-frame history."""
    dev = resolve_device(device)  # fail before touching any file
    data = load_offline_dataset(base_folder)
    with hostsync.stage("offline/frames"):
        frames = build_offline_frames(data, dtype, dev)
        first_Twc = SE3.from_xyzq(hostsync.push(data.truth_poses[0, 1:8], dev, dtype))
    with hostsync.stage("offline/ba"):
        graph, chi2s, cube_hist = tracker.run_incremental(first_Twc, frames, iterations=iterations)
    traj, cubes, chi2, hist = hostsync.pull(
        (graph.cam_Twc().to_xyzq(), graph.cube.to_minimal(), chi2s, cube_hist)
    )
    return SlamOutput(
        traj_Twc_xyzq=traj,
        cube_minimal=cubes[0],
        chi2=chi2,
        timestamps=data.truth_poses[:, 0],
        cube_history=hist,
    )


def _tum_image(base, i: int) -> pathlib.Path:
    return pathlib.Path(base) / "raw_imgs" / f"{i:04d}_rgb_raw.jpg"


def _load_grays(paths, dev, dtype):
    """Decoded gray frames on the device (uploaded as uint8), or None when
    any file is missing."""
    if not all(pathlib.Path(p).exists() for p in paths):
        return None
    return [
        hostsync.push(uio.load_image_gray(p).astype(np.uint8), dev).to(dtype) for p in paths
    ]


def run_online_slam(
    base_folder,
    n_frames: int | None = None,
    iterations: int = 5,
    dtype=torch.float32,
    detect_cfg=None,
    proposal_overrides: dict | None = None,
    soft_gate_alpha: float | None = 1.0,
    refine_with_points: bool = False,
    use_yaw_prior: bool = False,
    max_objects: int = 1,
    max_detections: int | None = None,
    min_iou: float = 0.3,
    window: int | None = None,
    line_track_weight: float = 0.0,
    robust_delta: float | None = None,
    bbox_edge_weight: float = 0.005,
    point_weight: float = 0.0,
    n_points: int = 128,
    checkpoint_path=None,
    checkpoint_every: int = 25,
    device=None,
) -> SlamOutput:
    """The two-phase online mono pipeline over a TUM-layout folder: the
    front-end pass (`run_online_frontend`: line detection -> cuboid
    proposals for all detections at the first camera pose -> IoU association
    into `max_objects` slots), then one `tracker.run_incremental` pass (the
    reference's online branch, main_obj.cpp:585-679).

    `bbox_edge_weight` adds EdgeSE3CuboidProj factors on the associated YOLO
    boxes (g2o_Object.h:264-292; the reference's driver builds only the 3D
    edge, main_obj.cpp:762-782).  `point_weight > 0` adds Harris + ZNCC
    point tracks (`features.build_point_tracks`, `n_points` corners) to the
    windowed BA and needs a fixed-lag `window` shorter than the run; when an
    image file is missing the tracks would misalign, so the run goes on
    without points (the report lists the missing frames).
    `refine_with_points` polishes the result with one joint camera + cuboid
    + point Schur BA (`_point_refinement`).  `checkpoint_path` threads the
    front-end's resume checkpoint; a completed one is a front-end cache for
    back-end sweeps.  `device=None` means the card (raises without one)."""
    dev = resolve_device(device)  # fail before touching any file
    base = pathlib.Path(base_folder)
    truth = uio.read_number_txt(base / "truth_cam_poses.txt")
    n = truth.shape[0] if n_frames is None else min(n_frames, truth.shape[0])
    if point_weight > 0.0 and (window is None or window >= n):
        raise ValueError("point_weight > 0 requires a fixed-lag window")
    first_Twc = SE3.from_xyzq(torch.as_tensor(truth[0, 1:8]).to(dtype))
    frame_specs = [
        (_tum_image(base, i), base / "filter_2d_obj_txts" / f"{i:04d}_yolo2_0.15.txt")
        for i in range(n)
    ]
    with hostsync.stage("tum/frontend"):
        frames, report = run_online_frontend(
            frame_specs, TUM_K, first_Twc, dtype,
            detect_cfg=detect_cfg, proposal_overrides=proposal_overrides,
            max_objects=max_objects, max_detections=max_detections, min_iou=min_iou,
            use_yaw_prior=use_yaw_prior, line_track_weight=line_track_weight,
            checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every, device=dev,
        )
    frames = _with_bbox_weight(frames, bbox_edge_weight)
    point_obs = None
    if point_weight > 0.0:
        from cube_slam_wu_tpu_torch.slam.features import build_point_tracks

        with hostsync.stage("tum/point_tracks"):
            grays = _load_grays([img for img, _ in frame_specs], dev, torch.float32)
            if grays is not None:
                point_obs = build_point_tracks(grays, max_corners=n_points)
    K = hostsync.push(TUM_K, dev, dtype)
    with hostsync.stage("tum/run_incremental"):
        graph, chi2s, cube_hist = tracker.run_incremental(
            first_Twc.to(dev),
            frames,
            iterations=iterations,
            soft_gate_alpha=soft_gate_alpha,
            window=window,
            robust_delta=robust_delta,
            K=K if (bbox_edge_weight > 0.0 or point_obs is not None) else None,
            point_obs=point_obs,
            point_weight=point_weight,
        )
    if refine_with_points:
        with hostsync.stage("tum/point_refinement"):
            graph = _point_refinement(graph, base, n, K, dtype)
    traj, cubes, cube_valid, chi2, hist = hostsync.pull(
        (graph.cam_Twc().to_xyzq(), graph.cube.to_minimal(), graph.cube_valid, chi2s, cube_hist)
    )
    return SlamOutput(
        traj_Twc_xyzq=traj,
        cube_minimal=cubes[0],
        chi2=chi2,
        timestamps=truth[:n, 0],
        cube_history=hist,
        cubes_minimal=cubes,
        cube_valid=cube_valid,
        frontend_report=report,
    )


def _point_refinement(
    graph,
    base,
    n: int,
    K: torch.Tensor,
    dtype,
    max_corners: int = 192,
    outlier_px: float = 3.0,
    min_track_obs: int = 3,
    obs_weight: float = 0.05,
):
    """Joint camera-object-point polish after the incremental pass: Harris +
    ZNCC tracks over the sequence are triangulated (DLT) from the incremental
    trajectory; observations whose reprojection error exceeds `outlier_px`
    are dropped and tracks left with fewer than `min_track_obs` observations
    go, then one Schur-reduced LM of 8 iterations refines poses, cuboids and
    points together.  Reads nothing back to the host past the feature
    tracker.  Returns the graph unchanged when an image file is missing.

    (On the JAX package's bundled 58-frame cabinet sequence this polish does
    not improve ATE, 0.234 -> 0.238 m: the error there is cuboid-measurement
    bias, which monocular points cannot correct.  Off by default.)"""
    from cube_slam_wu_tpu_torch.slam import features, point_ba

    dev = K.device
    grays = _load_grays([_tum_image(base, i) for i in range(n)], dev, dtype)
    if grays is None:
        return graph
    obs_uv, obs_mask = features.build_point_tracks(grays, max_corners=max_corners)
    obs_uv = hostsync.push(obs_uv, dev, dtype)
    obs_mask = hostsync.push(obs_mask, dev)
    pts, ok = point_ba.triangulate_points(graph.cam_Tcw, obs_uv, obs_mask, K)

    # reprojection gating against the incremental trajectory: every camera
    # against every point, (F, P, 2)
    T = graph.cam_Tcw
    proj = point_ba.project_point(SE3(T.quat[:, None], T.trans[:, None]), pts[None], K)
    err = torch.linalg.norm(proj - obs_uv, dim=-1)
    obs_ok = obs_mask & ok[None, :] & (err < outlier_px)
    track_ok = ok & (torch.sum(obs_ok, dim=0) >= min_track_obs)
    obs_ok = obs_ok & track_ok[None, :]

    factors = point_ba.PointFactors(
        points=pts,
        point_mask=track_ok,
        obs_uv=obs_uv,
        obs_mask=obs_ok,
        # pixel residuals against unit-information odometry/cuboid edges
        obs_weight=torch.full(obs_mask.shape, obs_weight, dtype=dtype, device=dev),
    )
    res = point_ba.optimize(graph, factors, K, iterations=8)
    return graph._replace(cam_Tcw=res.cam_Tcw, cube=res.cube)


def run_kitti_slam(
    seq_dir,
    detections_dir,
    poses_path=None,
    n_frames: int | None = None,
    device=None,
    **kwargs,
) -> SlamOutput:
    """Multi-object online SLAM over a KITTI-odometry-layout sequence: reads
    calib.txt, times.txt, image_0/*.png (Pillow) and the per-frame detection
    txts (`x y w h prob`, the reference's filter_2d_obj_txts contract) and
    runs `run_kitti_frames` over them; see there for the options.  The
    frame-0 pose is the ground truth's first pose when `poses_path` is given,
    else the synthetic generator's camera_pose(0)."""
    dev = resolve_device(device)  # fail before touching any file
    seq = ukitti.load_sequence(seq_dir, poses_path)
    n_avail = len(seq.image_paths)
    n = n_avail if n_frames is None else min(n_frames, n_avail)
    if n == 0:
        raise ValueError(f"no images under {seq_dir}/image_0")
    if seq.poses_T_wc is not None:
        T0 = np.asarray(seq.poses_T_wc[0], np.float64)
    else:
        from cube_slam_wu_tpu_torch.utils.synth import camera_pose

        T0 = np.asarray(camera_pose(0.0), np.float64)
    frames = _PathFrames(
        [(seq.image_paths[i], ukitti.detection_txt_path(detections_dir, i)) for i in range(n)]
    )
    return run_kitti_frames(
        frames, seq.K, T0, n_frames=n, timestamps=seq.timestamps[:n], device=dev, **kwargs
    )


def run_kitti_frames(
    frames,
    K_np: np.ndarray,
    T_wc0: np.ndarray,
    n_frames: int | None = None,
    timestamps: np.ndarray | None = None,
    iterations: int = 5,
    dtype=torch.float32,
    detect_cfg=None,
    proposal_overrides: dict | None = None,
    soft_gate_alpha: float | None = 2.0,
    max_objects: int = 8,
    max_detections: int = 4,
    min_iou: float = 0.25,
    window: int | None = None,
    robust_delta: float | None = None,
    bbox_edge_weight: float = 0.0,
    checkpoint_path=None,
    checkpoint_every: int = 25,
    track_max_age: int | None = 12,
    depth_gate_m: float | None = 2.5,
    spawn_range_m="auto",
    min_meas: int = 2,
    range_weight_m: float | None = None,
    pose_feedback: bool = False,
    point_weight: float = 0.0,
    n_points: int = 96,
    point_opts: dict | None = None,
    line_track_weight="auto",
    line_track_gate: float = 80.0,
    device=None,
    on_frame=None,
    on_result=None,
) -> SlamOutput:
    """Multi-object online SLAM over frames in memory: the JAX package's
    `run_kitti_slam` loop with its frame source as a parameter.

    `frames` is a sequence (len + indexing) whose item i is (gray (H, W)
    uint8 or None for a missing image, detection rows `x y w h conf` (1-based
    x/y) or None for a missing detections file); `K_np` the intrinsics,
    `T_wc0` the camera-to-world pose of frame 0 (z-up world, camera
    `T_wc0[2, 3]` above the ground).  `device=None` means the card (raises
    without one); the CPU is used only on `device="cpu"`.  `on_frame(i)`
    (optional) is called after frame i's step was enqueued.  `on_result`
    (optional, interleaved loop only) is called with frame i's `FrameResult`
    right after the frame's one read; when it returns true the run ends after
    frame i and returns its `SlamOutput` over frames 0..i.

    `pose_feedback=True` interleaves front-end and back-end: each frame's
    proposal grid runs at the tracker's constant-velocity PREDICTED pose
    (the reference reuses the first frame's pose for every frame,
    main_obj.cpp:624-628, which drifts away from a moving camera).
    `pose_feedback=False` keeps the reference's two-phase schedule.
    `point_weight > 0` (interleaved, with a window) adds point landmarks to
    the windowed joint BA.

    Auto policies, as in the JAX package: `spawn_range_m="auto"` is
    sqrt(0.6 * fx * h_cam) (the range at which one pixel of box error lifts
    to 0.6 m of depth error, h_cam = |T_wc0[2, 3]| floored at 0.5 m);
    `line_track_weight="auto"` is 0.5 in the interleaved mode without points,
    else 0.

    `min_meas` reports a landmark as valid only after it has accepted that
    many measurements (the graph keeps every slot)."""
    from cube_slam_wu_tpu_torch.ops.detect import DetectConfig, detect_line_segments, detector_for

    dev = resolve_device(device)
    n = len(frames) if n_frames is None else min(int(n_frames), len(frames))
    if n == 0:
        raise ValueError("no frames")
    T0 = np.asarray(T_wc0, np.float64)
    K_np = np.asarray(K_np, np.float64)
    timestamps = np.arange(n) * 0.1 if timestamps is None else np.asarray(timestamps)[:n]
    if isinstance(spawn_range_m, str):  # "auto"
        h_cam = max(float(abs(T0[2, 3])), 0.5)
        spawn_range_m = float(np.sqrt(0.6 * K_np[0, 0] * h_cam))
    if point_weight > 0.0 and not pose_feedback:
        raise ValueError("point_weight > 0 needs the interleaved loop (pose_feedback=True)")
    if on_result is not None and not pose_feedback:
        raise ValueError("on_result needs the interleaved loop (pose_feedback=True)")
    detect_cfg = detect_cfg or DetectConfig()
    if pose_feedback:
        # the interleaved loop runs the plain detector whatever
        # `short_recovery` says, as the JAX package's does; `nfa_validation`
        # is honoured
        detect = detect_line_segments
        if isinstance(line_track_weight, str):  # "auto"
            line_track_weight = 0.5 if point_weight == 0.0 else 0.0
    else:
        # the two-phase schedule, as the JAX package's: the recovery route,
        # no line tracks, max(1, max_objects) boxes unless told
        detect, line_track_weight = detector_for(detect_cfg), 0.0
        max_detections = max_detections or max(1, max_objects)
    fe = _FrontEnd(
        n, K_np, dtype, dev, detect, detect_cfg, proposal_overrides, max_objects, max_detections,
        min_iou, track_max_age, spawn_range_m, range_weight_m, line_track_weight, line_track_gate,
    )
    if pose_feedback:
        return _run_kitti_tracked(
            fe, frames, n, K_np, T0, timestamps, iterations=iterations,
            soft_gate_alpha=soft_gate_alpha, window=window, robust_delta=robust_delta,
            bbox_edge_weight=bbox_edge_weight, min_meas=min_meas, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, point_weight=point_weight, n_points=n_points,
            point_opts=point_opts, on_frame=on_frame, on_result=on_result,
        )

    first_Twc = SE3.from_matrix(torch.as_tensor(T0).to(dtype))
    frames_in, report = _frontend_frames(
        fe, frames, n, first_Twc.matrix().to(torch.float64).numpy(), depth_gate_m=depth_gate_m,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
    )
    frames_in = _with_bbox_weight(frames_in, bbox_edge_weight)
    with hostsync.stage("kitti/run_incremental"):
        graph, chi2s, cube_hist = tracker.run_incremental(
            first_Twc.to(dev),
            frames_in,
            iterations=iterations,
            soft_gate_alpha=soft_gate_alpha,
            window=window,
            robust_delta=robust_delta,
            K=fe.K if bbox_edge_weight > 0.0 else None,
        )
    if on_frame is not None:
        on_frame(n - 1)
    traj, cubes, cube_valid, chi2, hist, has = hostsync.pull(
        (graph.cam_Twc().to_xyzq(), graph.cube.to_minimal(), graph.cube_valid,
         chi2s, cube_hist, frames_in.has_meas)
    )
    meas_count = has.sum(axis=0)
    return SlamOutput(
        traj_Twc_xyzq=traj,
        cube_minimal=cubes[0],
        chi2=chi2,
        timestamps=timestamps,
        cube_history=hist,
        cubes_minimal=cubes,
        cube_valid=cube_valid & (meas_count >= min_meas),
        frontend_report=report,
    )


# the interleaved loop's 3D association gate (m): an IoU match is dropped
# when the detection's world-lifted position is farther than this from the
# track's landmark estimate
ASSOC_GATE_M = 3.0


def _run_kitti_tracked(fe: _FrontEnd, frames, n: int, K_np: np.ndarray, T0: np.ndarray,
                       timestamps: np.ndarray, *, iterations: int, soft_gate_alpha, window,
                       robust_delta, bbox_edge_weight: float, min_meas: int, checkpoint_path,
                       checkpoint_every: int, point_weight: float, n_points: int, point_opts,
                       on_frame, on_result):
    """Interleaved front-end/back-end loop (see run_kitti_frames): one
    tracker step per frame, with the next frame's proposal grid anchored at
    the tracker's constant-velocity predicted pose.

    The 3D association gate is one only this mode can provide: an IoU match
    is vetoed when the detection's world-lifted cuboid position is more than
    ASSOC_GATE_M from the track's current landmark estimate (a seamless
    handoff between objects on a forward drive would otherwise build one
    chimera track).  The vetoed measurement is DROPPED only.

    `point_weight > 0` adds point landmarks to the windowed joint BA
    (requires `window`): Harris+ZNCC features tracked incrementally
    (slam.features.IncrementalTracker, slot reuse with respawn flags),
    triangulated/ground-bootstrapped and optimised inside each window
    (tracker.make_windowed_point_step).  Ground hints come from corners below
    the principal row and outside every detection box.

    Stages (`utils.hostsync`): `kitti/features`, `kitti/detect_lines`,
    `kitti/proposals`, `kitti/associate` (stale retirement, the IoU
    association, the 3D gate, spawning and measuring, the frame's assembly)
    and `kitti/step`; with points, `kitti/step` also books the frame's
    `lm_rejected` iterations and `ba_points` (valid points in the solve),
    read with the step's outputs."""
    from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph
    from cube_slam_wu_tpu_torch.slam.window import CubePrior

    dtype, dev, O = fe.dtype, fe.dev, fe.O
    first_Twc = SE3.from_rot_trans(
        torch.as_tensor(T0[:3, :3]).to(device=dev, dtype=dtype),
        torch.as_tensor(T0[:3, 3]).to(device=dev, dtype=dtype),
    )
    # frame 0's pose as the driver's host cache sees it (in `dtype`)
    T_first = SE3.from_rot_trans(
        torch.as_tensor(T0[:3, :3]).to(dtype), torch.as_tensor(T0[:3, 3]).to(dtype)
    ).matrix().to(torch.float64).numpy()

    graph = CameraObjectGraph.empty(n, O, dtype, dev)._replace(K=fe.K)
    windowed = window is not None and window < n
    use_points = point_weight > 0.0
    if use_points and not windowed:
        raise ValueError("point_weight > 0 requires a fixed-lag window")
    ftracker = None
    if use_points:
        from cube_slam_wu_tpu_torch.slam.features import IncrementalTracker

        step = tracker.make_windowed_point_step(
            window, fe.K, iterations, None, soft_gate_alpha, 1.0,
            robust_delta, point_weight=point_weight, **(point_opts or {}),
        )
        carry = (graph, CubePrior.empty(O, dtype, dev), tracker.PointState.empty(n, n_points, dtype, dev))
        # level-camera horizon: ground candidates sit below the principal row
        ftracker = IncrementalTracker(n_points, horizon_row=float(K_np[1, 2]) + 5.0)
    elif windowed:
        step = tracker.make_windowed_step(window, iterations, None, soft_gate_alpha, 1.0, robust_delta)
        carry = (graph, CubePrior.empty(O, dtype, dev))
    else:
        step = tracker.make_incremental_step(iterations, None, soft_gate_alpha, 1.0, robust_delta)
        carry = graph

    def graph_of(carry):  # the windowed steps carry (graph, prior[, points])
        return carry[0] if windowed else carry

    chi2s = np.zeros(n)
    cube_hist = np.zeros((n, O, 9))
    start_frame = 0

    if checkpoint_path is not None:
        from cube_slam_wu_tpu_torch.slam import checkpoint as ckpt

        cp = ckpt._resolve(checkpoint_path)
        data = None
        if cp.exists():
            # the checkpoint is TWO files written back-to-back (state, then
            # the carry); a crash between the writes — or a stale state file
            # from an earlier run — leaves a torn pair: read as "start fresh"
            try:
                data = np.load(cp)
                resumed_carry = ckpt.load_pytree(cp.parent / (cp.name + ".carry"), carry)
            except (OSError, ValueError, KeyError) as e:
                print(f"[kitti] torn/stale checkpoint at {cp} ({e}); starting fresh", flush=True)
                data = None
        if data is not None:
            start_frame = min(int(data["i_next"]), n)
            carry = resumed_carry
            fe.book.load_state(data)
            m = min(n, data["chi2s"].shape[0])
            chi2s[:m] = data["chi2s"][:m]
            cube_hist[:m] = data["cube_hist"][:m]
            if ftracker is not None:
                ftracker.load_state(data)
                prev = frames[start_frame - 1][0] if start_frame > 0 else None
                if prev is not None:
                    ftracker.prev_gray = fe.upload(prev)

        def _save(i_next):
            ckpt.save_pytree(
                cp,
                dict(
                    i_next=np.asarray(i_next),
                    **fe.book.state(),
                    **(ftracker.state() if ftracker is not None else {}),
                    chi2s=chi2s, cube_hist=cube_hist,
                ),
            )
            ckpt.save_pytree(cp.parent / (cp.name + ".carry"), carry)

    # Host-side caches refreshed from the ONE post-step read each frame: the
    # two most recent optimized Tcw matrices (constant-velocity pose
    # prediction) and the cuboid positions/validity (3D association gate).
    Tcw_prev = Tcw_prevprev = None  # (4,4) float64, frames i-1 / i-2
    cube_pos_h = np.zeros((O, 3))
    cube_valid_h = np.zeros(O, bool)

    def veto(o, pos):  # the 3D gate, against the caches as they stand
        return cube_valid_h[o] and float(np.linalg.norm(pos - cube_pos_h[o])) > ASSOC_GATE_M

    for i in range(start_frame, n):
        if checkpoint_path is not None and i > start_frame and (i - start_frame) % max(checkpoint_every, 1) == 0:
            _save(i)

        if i > 0 and Tcw_prev is None:
            # resumed mid-run: one-time refill of the host caches
            Tcw_prev, Tcw_prevprev, cube_pos_h, cube_valid_h = hostsync.pull(
                _post_step_state(graph_of(carry), i - 1)
            )
            Tcw_prev = np.asarray(Tcw_prev, np.float64)
            Tcw_prevprev = np.asarray(Tcw_prevprev, np.float64)
        # constant-velocity predicted pose (the tracker recomputes the same
        # prediction inside _insert_frame), entirely on the host
        if i == 0:
            T_pred = T_first
        else:
            pred_Tcw = Tcw_prev @ _se3_inv_mat(Tcw_prevprev) @ Tcw_prev if i > 1 else Tcw_prev
            T_pred = _se3_inv_mat(pred_Tcw)
        R_p = T_pred[:3, :3]
        pitch_p = float(np.arcsin(np.clip(-R_p[2, 0], -1.0, 1.0)))
        roll_p = float(np.arctan2(R_p[2, 1], R_p[2, 2]))
        yaw_p = float(np.arctan2(R_p[1, 0], R_p[0, 0]))

        # the point tracker needs every image, so each is uploaded
        ok, gray32, boxes_c, dmask = fe.take(i, *frames[i], upload_any_image=True)

        # -- incremental feature tracking (every frame with an image) -------
        pt_obs = np.zeros((n_points, 2))
        pt_alive = np.zeros(n_points, bool)
        pt_respawn = np.zeros(n_points, bool)
        pt_ground = np.zeros(n_points, bool)
        if ftracker is not None and gray32 is not None:
            with hostsync.stage("kitti/features"):
                pt_obs, pt_alive, pt_respawn, pt_ground = ftracker.advance(
                    gray32, boxes_c[dmask] if boxes_c is not None else None
                )

        proposed = fe.propose(i, gray32, boxes_c, dmask, T_pred) if ok else None
        with hostsync.stage("kitti/associate"):
            # from_minimal(0) == Cuboid.identity where nothing is measured
            meas = (np.zeros((O, 9)), np.zeros(O), np.zeros(O, bool), np.zeros((O, 4)))
            if proposed is not None:
                meas = fe.associate(i, proposed, boxes_c, T_pred[:3, 3], (roll_p, pitch_p, yaw_p), veto)
            frame = _assemble_frame(*meas, bbox_edge_weight, dev, dtype)
        carry_before = carry
        with hostsync.stage("kitti/step"):
            inp = (i, frame, first_Twc)
            if use_points:
                inp += (hostsync.push(pt_obs, dev, dtype), hostsync.push(pt_alive, dev),
                        hostsync.push(pt_respawn, dev), hostsync.push(pt_ground, dev))
            # the point step also returns its LM counts
            carry, (chi2, cube_min, *stats) = step(carry, inp)
        if on_frame is not None:
            on_frame(i)
        # ONE read per frame: the step's outputs + everything the next
        # frame's host-side prediction and association gate need
        chi2_h, cube_min_h, T1_h, T2_h, cube_pos_h, cube_valid_h, *stats_h = hostsync.pull(
            (chi2, cube_min) + _post_step_state(graph_of(carry), i) + tuple(stats)
        )
        accepted = ba_points = None
        if stats_h:
            accepted, ba_points = (int(v) for v in stats_h[0])
            hostsync.add_count("kitti/step", "lm_rejected", iterations - accepted)
            hostsync.add_count("kitti/step", "ba_points", ba_points)
        Tcw_prev = np.asarray(T1_h, np.float64)
        Tcw_prevprev = np.asarray(T2_h, np.float64)
        chi2s[i] = float(chi2_h)
        cube_hist[i] = cube_min_h
        if on_result is not None and on_result(FrameResult(
            i, float(chi2_h), cube_min_h, Tcw_prev, Tcw_prevprev, cube_pos_h, cube_valid_h,
            accepted, ba_points, inp, carry_before, carry,
        )):
            n = i + 1
            break

    if checkpoint_path is not None:
        _save(n)
    report = fe.report._replace(n_frames=n)

    graph = graph_of(carry)
    final = (graph.cam_Twc().to_xyzq(), graph.cube.to_minimal(), graph.cube_valid)
    if windowed:
        final += (carry[1].valid,)
    if use_points:
        final += (carry[2].points, carry[2].point_valid)
    host = hostsync.pull(final)
    traj, cubes, cube_valid = host[:3]
    return SlamOutput(
        traj_Twc_xyzq=traj[:n],
        cube_minimal=cubes[0],
        chi2=chi2s[:n],
        timestamps=timestamps[:n],
        cube_history=cube_hist[:n],
        cubes_minimal=cubes,
        cube_valid=cube_valid & (fe.book.count >= min_meas),
        frontend_report=report,
        prior_valid=host[3] if windowed else None,
        points=host[4] if use_points else None,
        point_valid=host[5] if use_points else None,
    )
