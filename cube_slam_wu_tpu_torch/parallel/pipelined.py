"""Pipeline-parallel online front end: line detection and cuboid proposal
as two pipeline STAGES, frames streaming through.

The reference processes each frame start-to-finish in one thread (detect
lines main_obj.cpp:593, then detect_cuboid :633).  With the two stages on
two workers, stage 0 detects frame t+1 while stage 1 proposes cuboids for
frame t, so steady-state throughput goes from 1/(t_detect + t_proposal)
towards 1/max(t_detect, t_proposal); DP over frames is impossible (online
SLAM consumes frames in order) unless latency is allowed to grow.

Design:
- each stage is one host thread, on its own device, and on a CUDA device on
  its own CUDA stream.  Threads are needed because each stage makes
  blocking host reads (the detector's merge flags, the proposals' Canny
  flags), which would serialise the two stages in one thread;
- the frame stream is on each stage's device and each stage indexes it
  itself: the image is never handed over;
- between the stages sits a queue of depth 1.  The handoff carries the
  frame's line set, its mask and, on a CUDA device, an event recorded on the
  detector's stream after them: the proposal stream waits on the event, and
  the handed-off tensors are marked with `record_stream` so that the caching
  allocator cannot give their memory to the detector before the proposal
  stream is done with it;
- a failure in either stage stops the other and is raised by `run`: no
  thread dies quietly while `run` returns partial results.

On one card both stages are `cuda:0`, each with its own stream; on the CPU
both are `cpu`.  The stages' host reads are booked under the
`utils.hostsync` labels `frontend/detect_lines` and `frontend/proposals`
in both schedules.  The per-frame work is `frame_detect` then `frame_propose`,
exactly as the sequential glue runs them (`make_sequential_frontend`), so the
two schedules give the same bits.
"""

from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch

from cube_slam_wu_tpu_torch.ops.detect import DetectConfig, detect_line_segments
from cube_slam_wu_tpu_torch.ops.proposal import (
    FLOAT32_STABLE, ProposalConfig, ProposalResult, detect_cuboid_single,
)
from cube_slam_wu_tpu_torch.utils import hostsync

N_STAGES = 2  # detect | propose
_POLL_S = 0.1  # how often a blocked stage looks whether the other one failed


class _Frontend:
    """The per-frame glue of the online front end (detection in float32,
    proposals in `dtype` with max_lines = the detector's capacity and the
    drivers' FLOAT32_STABLE settings), on the tensors of one `run`."""

    def __init__(self, K_np, T_wc_np, detect_cfg: DetectConfig, proposal_overrides, dtype):
        # detector output capacity: top-K by length (detect_line_segments)
        L = min(detect_cfg.max_output, detect_cfg.n_peaks * detect_cfg.runs_per_peak)
        self.detect_cfg = detect_cfg
        self.prop_cfg = ProposalConfig(max_lines=L, **{**FLOAT32_STABLE, **(proposal_overrides or {})})
        self.K = np.asarray(K_np)
        self.T_wc = np.asarray(T_wc_np)
        self.dtype = dtype

    def inputs(self, grays, bboxes, T_wcs, device):
        """The frame stream on `device`: grays (T, H, W), bboxes (T, 4),
        per-frame poses (T, 4, 4) (each frame at `T_wc_np` when None), K."""
        as_t = lambda a: a if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a))  # noqa: E731
        grays = as_t(grays).to(device, self.dtype)
        T = grays.shape[0]
        if T_wcs is None:
            T_wcs = np.repeat(self.T_wc[None], T, axis=0)
        return dict(grays=grays, bboxes=as_t(bboxes).to(device, self.dtype),
                    T_wcs=as_t(T_wcs).to(device, self.dtype),
                    K=torch.as_tensor(self.K).to(device, self.dtype))

    def frame_detect(self, ins, t):
        with hostsync.stage("frontend/detect_lines"):
            lines, mask = detect_line_segments(ins["grays"][t].to(torch.float32), self.detect_cfg)
            return lines.to(self.dtype), mask

    def frame_propose(self, ins, t, lines, mask) -> ProposalResult:
        with hostsync.stage("frontend/proposals"):
            return detect_cuboid_single(ins["grays"][t], ins["K"], ins["T_wcs"][t],
                                        ins["bboxes"][t], lines, mask, self.prop_cfg)


def _stack(results) -> ProposalResult:
    return ProposalResult(*(torch.stack(f) for f in zip(*results)))


def make_sequential_frontend(device, K_np, T_wc_np, detect_cfg: DetectConfig = DetectConfig(),
                             proposal_overrides: dict | None = None, dtype=torch.float32):
    """`run(grays, bboxes, T_wcs=None) -> ProposalResult (T, ...)`: the
    per-frame glue, one frame after the other on `device` (what the
    pipelined front end must reproduce)."""
    fe = _Frontend(K_np, T_wc_np, detect_cfg, proposal_overrides, dtype)

    def run(grays, bboxes, T_wcs=None):
        ins = fe.inputs(grays, bboxes, T_wcs, torch.device(device))
        out = []
        for t in range(ins["grays"].shape[0]):
            out.append(fe.frame_propose(ins, t, *fe.frame_detect(ins, t)))
        return _stack(out)

    return run


def make_pipelined_frontend(devices, K_np, T_wc_np, detect_cfg: DetectConfig = DetectConfig(),
                            proposal_overrides: dict | None = None, dtype=torch.float32):
    """Build `run(grays (T, H, W), bboxes (T, 4)[, T_wcs (T, 4, 4)]) ->
    ProposalResult (T, ...)` running the detect|propose pipeline with stage s
    on `devices[s]` (exactly 2; both may be the same card).  Matches the
    sequential per-frame glue of `pipeline.run_online_frontend` (detection in
    float32, proposals in `dtype`, max_lines = detector capacity).

    `T_wcs` (optional) gives each frame its OWN camera pose, serving the
    interleaved `pose_feedback` mode where the proposal grid anchors at the
    tracker's constant-velocity predicted pose; omitted, every frame uses
    `T_wc_np` (the reference's static-pose TUM schedule,
    main_obj.cpp:624-628)."""
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != N_STAGES:
        raise ValueError(f"pipelined frontend needs {N_STAGES} devices, got {len(devices)}")
    if devices[0].type != devices[1].type or devices[0].type not in ("cpu", "cuda"):
        raise ValueError(f"pipelined frontend: two CPU or two CUDA devices, not {devices}")
    fe = _Frontend(K_np, T_wc_np, detect_cfg, proposal_overrides, dtype)

    def run(grays, bboxes, T_wcs=None):
        ins = [fe.inputs(grays, bboxes, T_wcs, devices[0])]
        ins.append(ins[0] if devices[1] == devices[0] else fe.inputs(grays, bboxes, T_wcs, devices[1]))
        T = ins[0]["grays"].shape[0]
        cuda = devices[0].type == "cuda"
        streams = [torch.cuda.Stream(d) if cuda else None for d in devices]
        for s, d in zip(streams, devices):
            if cuda:  # the stage's stream sees the uploads of the caller's
                s.wait_stream(torch.cuda.current_stream(d))
        handoff = queue.Queue(maxsize=1)
        results = [None] * T
        errors = []
        stop = threading.Event()

        def on_stream(s):
            return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()

        def put(item):
            while not stop.is_set():
                try:
                    handoff.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    pass
            return False

        def get():
            while not stop.is_set():
                try:
                    return handoff.get(timeout=_POLL_S)
                except queue.Empty:
                    pass
            return None

        def detect_stage():
            with on_stream(streams[0]):
                for t in range(T):
                    lines, mask = fe.frame_detect(ins[0], t)
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(streams[0])
                    if not put((t, lines, mask, event)):
                        return

        def propose_stage():
            with on_stream(streams[1]):
                for _ in range(T):
                    item = get()
                    if item is None:
                        return
                    t, lines, mask, event = item
                    if cuda:
                        streams[1].wait_event(event)
                        # the stream that reads the handed-off tensors: this
                        # one, or for a copy between two cards the source
                        # card's current stream, which runs the copy
                        reader = (streams[1] if devices[0] == devices[1]
                                  else torch.cuda.current_stream(devices[0]))
                        lines.record_stream(reader)
                        mask.record_stream(reader)
                    lines, mask = lines.to(devices[1]), mask.to(devices[1])
                    results[t] = fe.frame_propose(ins[1], t, lines, mask)

        def guarded(fn):
            def body():
                try:
                    fn()
                except BaseException as e:  # noqa: BLE001 - re-raised by run()
                    errors.append(e)
                    stop.set()
            return body

        threads = [threading.Thread(target=guarded(fn), name=f"pipelined-{name}", daemon=True)
                   for fn, name in ((detect_stage, "detect"), (propose_stage, "propose"))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        if any(r is None for r in results):
            raise RuntimeError("pipelined frontend: a stage ended before every frame was done")
        if cuda:
            # the caller's stream continues from the results; their memory
            # belongs to the proposal stream's pool until that stream is done
            main = torch.cuda.current_stream(devices[1])
            main.wait_stream(streams[1])
            for res in results:
                for f in res:
                    f.record_stream(main)
        return _stack(results)

    return run
