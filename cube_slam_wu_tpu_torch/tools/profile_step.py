"""Where a frame's time goes on the card: the fused online step, or the KITTI
driver's interleaved points step, under torch.profiler.

    python -m cube_slam_wu_tpu_torch.tools.profile_step [--frames 6] [--window W] [--out DIR]
    python -m cube_slam_wu_tpu_torch.tools.profile_step --kitti [--frames 6] [--out DIR]

Runs the synthetic 480x640 three-object sequence of chip_smoke.py for a few
warm-up frames, then profiles `--frames` more, and prints one JSON line: wall
ms/frame (profiler on), device-busy ms/frame (sum of kernel and memcpy time),
the idle share of the card, the number of device kernels per frame, host and
device span (first to last kernel) of each labelled stage of the step
(`online/...`) and the ten kernels with the most device time.  With
`--window W` the step is the fixed-lag one, and the warm-up runs until the
window slides (W + 2 frames unless `--warmup` says more), so that every
profiled frame absorbs a departing frame.  With `--kitti` the driver is
`slam.pipeline.run_kitti_frames` at chip_smoke.py's kitti_path configuration
(375x1242, six objects, window 16, 96 point slots, 8 object slots, 4
detections) and the stages are its `kitti/...` labels (features, detect_lines,
proposals, step); the warm-up again runs until the window slides.  The line
also gives the blocking host reads per profiled frame.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--window", type=int, default=0,
                    help="fixed-lag window in frames (0 = full-graph step)")
    ap.add_argument("--kitti", action="store_true",
                    help="profile the KITTI driver's interleaved points step")
    ap.add_argument("--out", default="build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    window = KITTI_SETTINGS["window"] if args.kitti else (args.window if args.window > 0 else None)
    if window is not None:
        args.warmup = max(args.warmup, window + 2)
    n = args.warmup + args.frames
    marks = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_frame(i):
        if i == args.warmup - 1:
            torch.cuda.synchronize()
            prof.__enter__()
            marks["t0"] = time.perf_counter()
            marks["s0"] = hostsync.snapshot()["syncs"]
        if i == n - 1:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            marks["s1"] = hostsync.snapshot()["syncs"]
            prof.__exit__(None, None, None)

    if args.kitti:
        from cube_slam_wu_tpu_torch.slam.pipeline import run_kitti_frames

        seq = synth.make_sequence(n_frames=n, **KITTI_WORLD)
        run_kitti_frames(list(zip(seq.images, seq.detections)), seq.K, seq.T_wc[0],
                         on_frame=on_frame, **KITTI_SETTINGS)
    else:
        seq = synth.make_sequence(n_frames=n, size=(480, 640), n_objects=3, seed=0)
        run_online_frames(
            sequence_frames(seq.images, seq.detections, 3), seq.K, seq.T_wc[0], n,
            max_objects=3, max_detections=3, capacity=64, window=window, on_frame=on_frame,
        )
    averages = prof.key_averages()
    is_stage = lambda e: e.key.startswith(("online/", "kitti/"))
    # device-side events; the stage labels also appear there (as spans from a
    # stage's first to its last kernel) and are not kernels
    events = [e for e in averages if e.device_type.name == "CUDA" and not is_stage(e)]
    dev_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    stages = {}
    for e in averages:
        if is_stage(e):
            st = stages.setdefault(e.key, {})
            if e.device_type.name == "CUDA":
                st["device_span_ms_per_frame"] = e.self_device_time_total / 1e3 / args.frames
            else:
                st["host_ms_per_frame"] = e.cpu_time_total / 1e3 / args.frames
    wall_ms = (marks["t1"] - marks["t0"]) * 1e3 / args.frames
    busy_ms = dev_us / 1e3 / args.frames
    smi = nvidia_smi_line()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tag = "_kitti" if args.kitti else (f"_window{window}" if window else "")
    (out / f"profile_step{tag}.txt").write_text(
        averages.table(sort_by="self_cuda_time_total", row_limit=60)
    )
    print(json.dumps({
        "card": smi, "path": "kitti" if args.kitti else "online",
        "frames": args.frames, "warmup": args.warmup, "window": window,
        "host_reads_per_frame": (marks["s1"] - marks["s0"]) / args.frames,
        "stages": stages,
        "wall_ms_per_frame_profiler_on": wall_ms,
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_kernels_per_frame": n_kernels / args.frames,
        "top_kernels": [
            {"name": e.key[:60], "ms_per_frame": e.self_device_time_total / 1e3 / args.frames,
             "calls_per_frame": e.count / args.frames}
            for e in top
        ],
    }))


if __name__ == "__main__":
    main()
