"""Command line of the PyTorch/CUDA port.

  python -m cube_slam_wu_tpu_torch.cli online --base <object_slam/data> --out out/ [--window 16] [--device cpu]

`online` always runs the fused per-frame step (slam/online.py); `--window W`
makes it the fixed-lag step, which optimises the trailing W frames only.  It runs on
the GPU unless `--device cpu` is given, and fails when there is no GPU.
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
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
