"""Command line of the PyTorch/CUDA port.

  python -m cube_slam_wu_tpu_torch.cli online --base <object_slam/data> --out out/ [--window 16] [--device cpu]
  python -m cube_slam_wu_tpu_torch.cli kitti --seq <dir> --detections <dir> [--poses poses.txt]
      [--pose-feedback [--point-weight 0.3]] [--window 16] [--float64] [--device cpu] --out out/

`online` always runs the fused per-frame step (slam/online.py); `--window W`
makes it the fixed-lag step, which optimises the trailing W frames only.
`kitti` runs the KITTI driver (slam/pipeline.py) over a KITTI-odometry-layout
sequence (image_0/*.png, calib.txt, times.txt, per-frame `x y w h prob`
detection txts) and writes the same files as the JAX package's `kitti`
command.  Both run on the GPU unless `--device cpu` is given, and fail when
there is no GPU.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np


def _write_outputs(out_dir, fr, truth):
    from cube_slam_wu_tpu_torch.utils import io as uio
    from cube_slam_wu_tpu_torch.utils.metrics import ate_rmse, rpe_rmse

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = len(fr.traj_Twc_xyzq)
    uio.write_tum_trajectory(
        out_dir / "output_cam_poses.txt", truth[:n, 0], fr.traj_Twc_xyzq
    )
    np.savetxt(out_dir / "output_obj_poses.txt", fr.cubes_minimal, fmt="%.6f")
    ate = ate_rmse(fr.traj_Twc_xyzq[:, :3], truth[:n, 1:4])
    print(f"ATE RMSE vs truth: {ate:.4f} m")
    if n > 1:
        rpe_t, rpe_r = rpe_rmse(fr.traj_Twc_xyzq, truth[:n, 1:8])
        print(f"RPE RMSE (delta=1): {rpe_t:.4f} m / {rpe_r:.4f} deg")
    print(f"outputs written to {out_dir}")


def cmd_online(args):
    import torch

    from cube_slam_wu_tpu_torch.slam.online import run_online_slam_fused
    from cube_slam_wu_tpu_torch.utils import io as uio

    if not pathlib.Path(args.base).is_dir():
        raise SystemExit(f"error: --base {args.base!r} is not a directory")
    fr = run_online_slam_fused(
        args.base,
        n_frames=args.frames,
        dtype=torch.float64 if args.float64 else torch.float32,
        max_objects=args.max_objects,
        max_detections=args.max_detections,
        iterations=args.iterations,
        bbox_edge_weight=args.bbox_edge_weight,
        window=args.window if args.window and args.window > 0 else None,
        device=args.device,
    )
    truth = uio.read_number_txt(pathlib.Path(args.base) / "truth_cam_poses.txt")
    print(
        f"fused: {fr.syncs_per_frame:.1f} host reads/frame, "
        f"{fr.bytes_up_per_frame / 1e6:.2f} MB up / "
        f"{fr.bytes_down_per_frame:.0f} B down; report {fr.report}"
    )
    _write_outputs(args.out, fr, truth)


def cmd_kitti(args):
    """Multi-object online SLAM over a KITTI-odometry-layout sequence.  Writes
    a KITTI-format trajectory (12-number rows), a TUM-format one, per-object
    cuboids and, when ground truth is given, the ATE."""
    import torch

    from cube_slam_wu_tpu_torch.core.se3 import SE3
    from cube_slam_wu_tpu_torch.slam.pipeline import run_kitti_slam
    from cube_slam_wu_tpu_torch.utils import io as uio
    from cube_slam_wu_tpu_torch.utils import kitti as ukitti
    from cube_slam_wu_tpu_torch.utils.metrics import ate_rmse

    if not pathlib.Path(args.seq).is_dir():
        raise SystemExit(f"error: --seq {args.seq!r} is not a directory")
    if not pathlib.Path(args.detections).is_dir():
        raise SystemExit(f"error: --detections {args.detections!r} is not a directory")
    result = run_kitti_slam(
        args.seq,
        args.detections,
        poses_path=args.poses,
        n_frames=args.frames,
        iterations=args.iterations,
        dtype=torch.float64 if args.float64 else torch.float32,
        max_objects=args.max_objects,
        max_detections=args.max_detections,
        window=args.window if args.window and args.window > 0 else None,
        bbox_edge_weight=args.bbox_edge_weight,
        track_max_age=args.track_max_age if args.track_max_age > 0 else None,
        depth_gate_m=args.depth_gate if args.depth_gate > 0 else None,
        spawn_range_m=(
            "auto" if args.spawn_range < 0 else (args.spawn_range if args.spawn_range > 0 else None)
        ),
        min_meas=args.min_meas,
        range_weight_m=args.range_weight if args.range_weight > 0 else None,
        pose_feedback=args.pose_feedback,
        point_weight=args.point_weight,
        n_points=args.n_points,
        checkpoint_path=args.checkpoint or None,
        checkpoint_every=args.checkpoint_every,
        device=args.device,
    )
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    uio.write_tum_trajectory(
        out_dir / "output_cam_poses.txt", result.timestamps, result.traj_Twc_xyzq
    )
    # KITTI 12-number rows in the cam-forward first-camera world
    Rinv = np.eye(4)
    Rinv[:3, :3] = ukitti.KITTI_TO_ZUP.T
    T = SE3.from_xyzq(torch.as_tensor(result.traj_Twc_xyzq, dtype=torch.float64)).matrix().numpy()
    T[:, 2, 3] -= ukitti.CAMERA_HEIGHT_M
    rows = (Rinv[None] @ T)[:, :3, :4].reshape(len(T), 12)
    np.savetxt(out_dir / "trajectory_kitti.txt", rows, fmt="%.9e")
    np.savetxt(
        out_dir / "output_obj_poses.txt",
        result.cubes_minimal[np.asarray(result.cube_valid)],
        fmt="%.6f",
    )
    if result.frontend_report is not None:
        print("frontend:", result.frontend_report.summary())
    if args.poses:
        seq = ukitti.load_sequence(args.seq, args.poses)
        n = len(result.timestamps)
        ate = ate_rmse(result.traj_Twc_xyzq[:, :3], seq.poses_T_wc[:n, :3, 3])
        print(f"ATE RMSE vs ground truth: {ate:.4f} m")
    print(f"outputs written to {out_dir}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cube_slam_wu_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pn = sub.add_parser("online", help="fused online mono object SLAM")
    pn.add_argument("--base", required=True)
    pn.add_argument("--out", default="out")
    pn.add_argument("--frames", type=int, default=None)
    pn.add_argument("--iterations", type=int, default=5)
    pn.add_argument("--bbox-edge-weight", type=float, default=0.005,
                    help="2D bbox projection-edge weight (0 = reference-"
                         "parity: 3D cuboid edges only)")
    pn.add_argument("--window", type=int, default=0,
                    help="sliding BA window in frames (0 = full graph)")
    pn.add_argument("--max-objects", type=int, default=1)
    pn.add_argument("--max-detections", type=int, default=1)
    pn.add_argument("--float64", action="store_true")
    pn.add_argument("--device", default=None,
                    help="torch device; default: the GPU (fails without one)")
    pn.set_defaults(fn=cmd_online)

    pk = sub.add_parser("kitti", help="multi-object online SLAM over a KITTI-layout sequence")
    pk.add_argument("--seq", required=True, help="sequence dir (image_0/, calib.txt)")
    pk.add_argument("--detections", required=True, help="per-frame yolo txt dir")
    pk.add_argument("--poses", default=None, help="KITTI ground-truth poses txt")
    pk.add_argument("--out", default="out")
    pk.add_argument("--frames", type=int, default=None)
    pk.add_argument("--iterations", type=int, default=5)
    pk.add_argument("--max-objects", type=int, default=8)
    pk.add_argument("--max-detections", type=int, default=4)
    pk.add_argument("--window", type=int, default=16,
                    help="sliding BA window (0 = full-graph re-optimisation)")
    pk.add_argument("--bbox-edge-weight", type=float, default=0.0,
                    help="2D bbox projection-edge weight")
    pk.add_argument("--track-max-age", type=int, default=12,
                    help="retire a track after this many frames without an "
                         "association (0 = never)")
    pk.add_argument("--depth-gate", type=float, default=2.5,
                    help="drop IoU matches whose camera-relative range jumps "
                         "more than this many metres (0 = off)")
    pk.add_argument("--spawn-range", type=float, default=-1.0,
                    help="do not spawn landmarks beyond this range in metres "
                         "(0 = off, negative = auto from intrinsics: the "
                         "range where 1 px of bbox error lifts to 0.6 m of "
                         "depth)")
    pk.add_argument("--min-meas", type=int, default=2,
                    help="report a landmark only after this many accepted "
                         "measurements")
    pk.add_argument("--range-weight", type=float, default=0.0,
                    help="scale measurement weight by (R/range)^2 beyond "
                         "this range R in metres (0 = off)")
    pk.add_argument("--pose-feedback", action="store_true",
                    help="interleave front/back-end: run each frame's "
                         "proposal grid at the tracker's predicted pose")
    pk.add_argument("--point-weight", type=float, default=0.0,
                    help="point-landmark reprojection weight in the joint "
                         "windowed BA (0 = off; needs --pose-feedback and a "
                         "window)")
    pk.add_argument("--n-points", type=int, default=96,
                    help="feature-track slots for --point-weight")
    pk.add_argument("--checkpoint", default="",
                    help="checkpoint npz: saved every --checkpoint-every "
                         "frames, resumed if it exists")
    pk.add_argument("--checkpoint-every", type=int, default=25)
    pk.add_argument("--float64", action="store_true")
    pk.add_argument("--device", default=None,
                    help="torch device; default: the GPU (fails without one)")
    pk.set_defaults(fn=cmd_kitti)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
