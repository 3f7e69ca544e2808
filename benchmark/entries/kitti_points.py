"""Entry `kitti_points`: monocular object SLAM with point landmarks over a
KITTI-sized drive, as `cli kitti --pose-feedback --point-weight 0.3` runs it.

Each session is one call of the port's `slam/pipeline.py::run_kitti_frames`
over the world's frames in order from frame 0, at the configuration's
settings (window, point and object slots, detections per frame, LM
iterations, dtype) and the CLI's other defaults.  The frame source takes a
frame from the window when the driver reads it; the driver's per-frame
result hook (`on_result`) marks the frame done, keeps the frame's pulled
pose and references to the step's input and carry before and after, and
ends the session when the window has closed.  A session that reaches the
world's last frame inside the window is followed by a fresh one.  The
warm-up is a session that the hook ends after the traffic's
`warmup_frames`.  After the window the kept references become plain arrays
for the reference (`references/kitti_points.py`); the seed changes nothing
of the work.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch


class Source:
    """The world's frames as the driver reads them: item i is (gray u8,
    detection rows); reading it takes a frame from the window."""

    def __init__(self, world, window):
        self.world, self.window = world, window
        self.taken: dict = {}  # session frame -> window frame

    def __len__(self):
        return len(self.world.images)

    def __getitem__(self, i):
        self.taken[i] = self.window.take()
        return self.world.images[i], self.world.detections[i]


def _np(t):
    return t.detach().cpu().numpy()


def _pose(prefix, T):
    return {f"{prefix}_q": _np(T.quat), f"{prefix}_t": _np(T.trans)}


def state_arrays(carry) -> dict:
    """The carry (graph, CubePrior, PointState) as the reference's plain
    arrays (`references/kitti_points.STATE`)."""
    g, prior, ps = carry
    out = {**_pose("cam", g.cam_Tcw), **_pose("odom", g.odom), **_pose("cube", g.cube.pose),
           **_pose("meas", g.cube_meas.pose), **_pose("prior_lin", prior.lin.pose)}
    out.update(frame_mask=_np(g.frame_mask), odom_mask=_np(g.odom_mask), cube_s=_np(g.cube.scale),
               cube_valid=_np(g.cube_valid), meas_s=_np(g.cube_meas.scale),
               meas_w=_np(g.cube_meas_weight), meas_mask=_np(g.cube_meas_mask),
               bbox_mask=_np(g.bbox_mask), prior_H=_np(prior.H), prior_b=_np(prior.b),
               prior_lin_s=_np(prior.lin.scale), prior_valid=_np(prior.valid),
               obs_uv=_np(ps.obs_uv), obs_mask=_np(ps.obs_mask), points=_np(ps.points),
               point_valid=_np(ps.point_valid))
    return out


def input_arrays(inp) -> dict:
    """The step's input as the reference's plain arrays
    (`references/kitti_points.INPUT`)."""
    _, frame, first, obs, obs_mask, respawned, ground = inp
    return {**_pose("meas", frame.meas.pose), **_pose("first", first),
            "meas_s": _np(frame.meas.scale), "quality": _np(frame.quality),
            "has_meas": _np(frame.has_meas), "active": _np(frame.active),
            "bbox_weight": _np(frame.bbox_weight), "obs": _np(obs), "obs_mask": _np(obs_mask),
            "respawned": _np(respawned), "ground": _np(ground)}


class Program:
    def __init__(self, ctx):
        from cube_slam_wu_tpu_torch.slam import pipeline

        from harness.cell import Refused

        if "on_result" not in inspect.signature(pipeline.run_kitti_frames).parameters:
            raise Refused("run_kitti_frames has no per-frame result hook (on_result)")
        self.run_kitti_frames = pipeline.run_kitti_frames
        self.ctx = ctx
        s = ctx.settings
        self.kw = dict(pose_feedback=True, point_weight=s["point_weight"], window=s["window"],
                       n_points=s["n_points"], max_objects=s["max_objects"],
                       max_detections=s["max_detections"], iterations=s["iterations"],
                       dtype=getattr(torch, s["dtype"]), device=ctx.device)

    def _session(self, window, stop_after=None) -> list:
        """One session from frame 0, ended by the hook when the window has
        closed (or after `stop_after` frames)."""
        world = self.ctx.world
        src = Source(world, window)
        kept = []

        def on_result(r):
            k = src.taken[r.i]
            window.done(k)
            kept.append(dict(k=k, i=r.i, Tcw=r.Tcw, refs=(r.step_input, r.carry_before,
                                                          r.carry_after)))
            return not window.open() or r.i + 1 == stop_after

        self.run_kitti_frames(src, world.K, world.T_wc[0], on_result=on_result, **self.kw)
        return kept

    def warmup(self):
        """The first frames of a session: every shape of the step is the
        session's (the graph holds all of the world's frames)."""
        from harness.window import Window

        w = Window(1e9)
        w.start()
        self._session(w, stop_after=int(self.ctx.traffic["warmup_frames"]))

    def drive(self, window) -> list:
        kept = []
        while window.open():
            kept += self._session(window)
        K = np.asarray(self.ctx.world.K, np.float64)
        for f in kept:
            inp, before, after = f.pop("refs")
            f.update(K=K, input=input_arrays(inp), before=state_arrays(before),
                     after=state_arrays(after))
        return kept

    def notes(self, frames) -> dict:
        after = [f["after"] for f in frames]
        return {"frames": len(frames),
                "sessions": sum(1 for f in frames if f["i"] == 0),
                "valid_points_per_frame": float(np.mean([a["point_valid"].sum() for a in after]))
                if after else 0.0,
                "valid_landmarks_at_the_end": int(after[-1]["cube_valid"].sum()) if after else 0}

    def close(self):
        self.ctx = None
