"""Where a frame's time and host reads go on the card: the fused online step,
the KITTI driver's interleaved points step, or a whole run of the TUM
two-phase or offline driver, under torch.profiler.

    python -m cube_slam_wu_tpu_torch.tools.profile_step [--frames 6] [--window W] [--out DIR]
    python -m cube_slam_wu_tpu_torch.tools.profile_step --kitti [--frames 6] [--out DIR]
    python -m cube_slam_wu_tpu_torch.tools.profile_step --two-phase [--frames 20] [--window 16] [--out DIR]
    python -m cube_slam_wu_tpu_torch.tools.profile_step --offline [--frames 20] [--out DIR]

The step modes run the synthetic 480x640 three-object sequence of
chip_smoke.py for a few warm-up frames, then profile `--frames` more.  With
`--window W` the step is the fixed-lag one, and the warm-up runs until the
window slides (W + 2 frames unless `--warmup` says more), so that every
profiled frame absorbs a departing frame.  With `--kitti` the driver is
`slam.pipeline.run_kitti_frames` at chip_smoke.py's kitti_path configuration
(375x1242, six objects, window 16, 96 point slots, 8 object slots, 4
detections); the warm-up again runs until the window slides.

`--two-phase` and `--offline` write that world's first `--frames` frames
(default 20) in the TUM folder layout (`utils.synth.write_tum_sequence`,
with the offline replay's files), warm up on a 4-frame run, and profile one
whole run of `slam.pipeline.run_online_slam` at chip_smoke.py's
`tum_two_phase_path` settings (window 16, point weight 0.3, 128 point
slots) or of `run_offline_slam`; per frame means over the run's frames.
They count the host reads and time the stages on the host
(`utils.hostsync.stage`) without the torch profiler unless `--trace` asks
for it: a whole run is millions of events, and summing them up took the
profiler 704 s for 20 offline frames on an H100 machine.

Every mode with a trace prints one JSON line: wall ms/frame (profiler on),
device-busy ms/frame (sum of kernel and memcpy time), the idle share of the card, the
number of device kernels per frame, host and device span (first to last
kernel) of each labelled stage (`online/`, `kitti/`, `tum/`, `offline/`)
and the ten kernels with the most device time, the blocking host reads per
profiled frame and, under `host_reads_by_stage`, the reads and bytes per
frame of each stage label (`utils.hostsync.stage`; a count goes to the
innermost open stage, `other` is outside every stage, so they sum to the
totals; with the stage's entries and host seconds), and the seconds the
profiler took to sum its events up.  Without a trace the line has the wall
ms/frame and `host_reads_by_stage`.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from cube_slam_wu_tpu_torch.slam.online import run_online_frames, sequence_frames
from cube_slam_wu_tpu_torch.tools.cardtime import nvidia_smi_line
from cube_slam_wu_tpu_torch.utils import hostsync, synth

KITTI_WORLD = dict(n_objects=6, size=(375, 1242), speed=0.5, curve=0.002, noise_px=0.8,
                   dropout=0.05, seed=4, ground_texture=4.0)
KITTI_SETTINGS = dict(pose_feedback=True, window=16, point_weight=0.3, n_points=96,
                      max_objects=8, max_detections=4)
TUM_WORLD = dict(size=(480, 640), n_objects=3, seed=0)
TWO_PHASE_SETTINGS = dict(window=16, point_weight=0.3, n_points=128)
STAGE_PREFIXES = ("online/", "kitti/", "tum/", "offline/")


class Capture:
    """A profiler (unless `trace` is off) and the host-read counts between
    `start()` and `stop()`, with a synchronisation at both ends."""

    def __init__(self, trace: bool = True):
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if trace else None

    def start(self):
        torch.cuda.synchronize()
        if self.prof is not None:
            self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.s0 = hostsync.snapshot()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.s1 = hostsync.snapshot()
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    def summary(self, frames: int) -> dict:
        """The JSON fields every mode prints, per profiled frame (without a
        trace: the wall time, and the host reads and host seconds by stage)."""
        reads = hostsync.delta(self.s0, self.s1, per=frames)
        wall_ms = (self.t1 - self.t0) * 1e3 / frames
        out = {"frames": frames, "host_reads_per_frame": reads["syncs"],
               "host_reads_by_stage": reads["by_stage"]}
        if self.prof is None:
            return {**out, "wall_ms_per_frame": wall_ms}
        t_post = time.perf_counter()
        self.averages = averages = self.prof.key_averages()
        is_stage = lambda e: e.key.startswith(STAGE_PREFIXES)
        # device-side events; the stage labels also appear there (as spans
        # from a stage's first to its last kernel) and are not kernels
        events = [e for e in averages if e.device_type.name == "CUDA" and not is_stage(e)]
        dev_us = sum(e.self_device_time_total for e in events)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
        stages = {}
        for e in averages:
            if is_stage(e):
                st = stages.setdefault(e.key, {})
                if e.device_type.name == "CUDA":
                    st["device_span_ms_per_frame"] = e.self_device_time_total / 1e3 / frames
                else:
                    st["host_ms_per_frame"] = e.cpu_time_total / 1e3 / frames
        busy_ms = dev_us / 1e3 / frames
        return {
            **out,
            "stages": stages,
            "wall_ms_per_frame_profiler_on": wall_ms,
            "device_busy_ms_per_frame": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_kernels_per_frame": sum(e.count for e in events) / frames,
            "top_kernels": [
                {"name": e.key[:60], "ms_per_frame": e.self_device_time_total / 1e3 / frames,
                 "calls_per_frame": e.count / frames}
                for e in top
            ],
            "profiler_postprocess_s": time.perf_counter() - t_post,
        }

    def write_table(self, path) -> None:
        """The profiler's table (after `summary`, whose sums it reuses)."""
        if self.prof is not None:
            pathlib.Path(path).write_text(
                self.averages.table(sort_by="self_cuda_time_total", row_limit=60))


def write_tum_folder(root, n_frames: int) -> pathlib.Path:
    """The 480x640 three-object world's first `n_frames` frames in the TUM
    folder layout, with the offline replay's files."""
    seq = synth.make_sequence(n_frames=n_frames, **TUM_WORLD)
    folder = synth.write_tum_sequence(seq, pathlib.Path(root) / f"tum{n_frames}")
    synth.write_offline_files(seq, folder, seed=TUM_WORLD["seed"])
    return folder


def profile_tum(folder, mode: str, frames: int, warmup_folder=None, trace: bool = True,
                **settings) -> tuple:
    """Profile one whole run of the two-phase driver (`mode="two_phase"`,
    over the folder's first `frames` frames, `TWO_PHASE_SETTINGS` overridden
    by `settings`) or of the offline replay (`mode="offline"`, over the whole
    folder, which should hold `frames` frames), after a 4-frame warm-up run
    (the offline one on `warmup_folder`).  `trace=False` counts the host
    reads by stage and times the run without the profiler (whose trace of a
    whole run is millions of events).  Returns (summary, Capture)."""
    from cube_slam_wu_tpu_torch.slam.pipeline import run_offline_slam, run_online_slam

    if mode == "two_phase":
        kw = dict(TWO_PHASE_SETTINGS, **settings)
        run_online_slam(folder, n_frames=4, window=2, point_weight=kw["point_weight"],
                        n_points=kw["n_points"])
        run = lambda: run_online_slam(folder, n_frames=frames, **kw)
    elif mode == "offline":
        run_offline_slam(warmup_folder if warmup_folder is not None else folder)
        run = lambda: run_offline_slam(folder)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    cap = Capture(trace)
    cap.start()
    run()
    cap.stop()
    return cap.summary(frames), cap


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None,
                    help="profiled frames (default 6; 20 with --two-phase / --offline)")
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--window", type=int, default=0,
                    help="fixed-lag window in frames (0 = full-graph step; "
                         "the two-phase driver's default is 16)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--kitti", action="store_true",
                      help="profile the KITTI driver's interleaved points step")
    mode.add_argument("--two-phase", action="store_true",
                      help="profile a whole run of the TUM two-phase driver")
    mode.add_argument("--offline", action="store_true",
                      help="profile a whole run of the TUM offline replay")
    ap.add_argument("--trace", action="store_true",
                    help="with --two-phase / --offline: also take the torch profiler's "
                         "trace (summing a whole run's events up takes ~35 s per frame)")
    ap.add_argument("--out", default="build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = nvidia_smi_line()

    if args.two_phase or args.offline:
        frames = args.frames or 20
        tum_mode = "two_phase" if args.two_phase else "offline"
        settings = {"window": args.window} if (args.two_phase and args.window > 0) else {}
        with tempfile.TemporaryDirectory() as tmp:
            folder = write_tum_folder(tmp, frames)
            warm = write_tum_folder(tmp, 4) if args.offline else None
            summary, cap = profile_tum(folder, tum_mode, frames, warmup_folder=warm,
                                       trace=args.trace, **settings)
        cap.write_table(out / f"profile_step_{tum_mode}.txt")
        head = {"card": smi, "path": tum_mode, "warmup": 4, "trace": args.trace,
                "settings": dict(TWO_PHASE_SETTINGS, **settings) if args.two_phase else {}}
        print(json.dumps({**head, **summary}))
        return

    frames = args.frames or 6
    window = KITTI_SETTINGS["window"] if args.kitti else (args.window if args.window > 0 else None)
    if window is not None:
        args.warmup = max(args.warmup, window + 2)
    n = args.warmup + frames
    cap = Capture()

    def on_frame(i):
        if i == args.warmup - 1:
            cap.start()
        if i == n - 1:
            cap.stop()

    if args.kitti:
        from cube_slam_wu_tpu_torch.slam.pipeline import run_kitti_frames

        seq = synth.make_sequence(n_frames=n, **KITTI_WORLD)
        run_kitti_frames(list(zip(seq.images, seq.detections)), seq.K, seq.T_wc[0],
                         on_frame=on_frame, **KITTI_SETTINGS)
    else:
        seq = synth.make_sequence(n_frames=n, **TUM_WORLD)
        run_online_frames(
            sequence_frames(seq.images, seq.detections, 3), seq.K, seq.T_wc[0], n,
            max_objects=3, max_detections=3, capacity=64, window=window, on_frame=on_frame,
        )
    tag = "_kitti" if args.kitti else (f"_window{window}" if window else "")
    cap.write_table(out / f"profile_step{tag}.txt")
    summary = cap.summary(frames)
    print(json.dumps({"card": smi, "path": "kitti" if args.kitti else "online",
                      "warmup": args.warmup, "window": window, **summary}))


if __name__ == "__main__":
    main()
