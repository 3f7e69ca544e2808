"""Entry `detect_cuboid`: the single-image 3D cuboid detector (the
reference's `detect_3d_cuboid` node) over a stream of frames.

Per frame, as `cli detect-cuboid` runs it (`--top-k 5 --sample-height
--sample-roll-pitch` in the traffic's settings): `ops/detect.py::
detect_line_segments` on the gray image, then `ops/proposal.py::
detect_cuboids` on all of the frame's boxes in one batch at the frame's
camera pose; the line segments and the ranked cuboids of every box are
pulled to the host in one read.  The frames of the fixed world are replayed
over and over until the window ends, in an order drawn from the seed: the
seed changes the order and not the work.  The harness's own spans time the
two calls on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from harness.frames import FIELDS, detect_inputs, proposal_config


class Program:
    def __init__(self, ctx):
        from cube_slam_wu_tpu_torch.ops.detect import detect_line_segments
        from cube_slam_wu_tpu_torch.ops.proposal import ProposalConfig, detect_cuboids
        from cube_slam_wu_tpu_torch.utils import hostsync

        self.detect_lines, self.detect_cuboids = detect_line_segments, detect_cuboids
        self.ProposalConfig, self.hostsync = ProposalConfig, hostsync
        self.ctx = ctx
        self.s = ctx.settings
        self.dtype = getattr(torch, self.s["dtype"])
        self.inputs = [detect_inputs(ctx.world, i, self.s["max_detections"])
                       for i in range(len(ctx.world.images))]
        self.K = hostsync.push(ctx.world.K, ctx.device, self.dtype)
        self.order = np.random.default_rng(ctx.seed).permutation(len(self.inputs))

    def _frame(self, i: int) -> dict:
        hs, dev, span = self.hostsync, self.ctx.device, self.ctx.spans.span
        gray_u8, xywh, mask, T_wc = self.inputs[i]
        gray = hs.push(np.ascontiguousarray(gray_u8), dev).to(self.dtype)
        with span("detect_cuboid/detect_lines"):
            lines, lmask = self.detect_lines(gray)
        cfg = proposal_config(self.ProposalConfig, self.s, int(lines.shape[0]))
        T_t, xywh_t = hs.push(T_wc, dev, self.dtype), hs.push(xywh, dev, self.dtype)
        mask_t = hs.push(mask, dev)
        with span("detect_cuboid/proposals"):
            res = self.detect_cuboids(gray, self.K, T_t, xywh_t, mask_t, lines.to(self.dtype),
                                      lmask, cfg)
        host = hs.pull((lines, lmask) + tuple(getattr(res, f) for f in FIELDS))
        return dict(zip(FIELDS, host[2:]), lines=host[0][host[1]], frame=i)

    def warmup(self):
        for i in range(int(self.ctx.traffic["warmup_frames"])):
            self._frame(int(self.order[i % len(self.order)]))

    def drive(self, window) -> list:
        out = []
        while window.open():
            k = window.take()
            out.append(self._frame(int(self.order[k % len(self.order)])))
            window.done(k)
        return out

    def notes(self, frames) -> dict:
        valid = np.array([f["valid"].any(axis=-1).sum() for f in frames])
        return {"frames": len(frames), "boxes_with_a_valid_cuboid_per_frame": float(valid.mean())}

    def close(self):
        self.K = None
