"""Command line of the PyTorch/CUDA port: the JAX package's commands and
flags, with `--device` and `--float64` on each.

  python -m cube_slam_wu_tpu_torch.cli offline --base <object_slam/data> --out out/ [--save-cloud N]
  python -m cube_slam_wu_tpu_torch.cli online --base <object_slam/data> --out out/
      [--window 16 [--point-weight 0.3]] [--checkpoint ck.npz] [--fused] [--save-cloud N]
  python -m cube_slam_wu_tpu_torch.cli detect-cuboid --image img.jpg --bbox x,y,w,h
      [--edges e.txt] [--calib fx,fy,cx,cy] [--pose T_wc.txt] [--top-k 5]
      [--sample-height] [--sample-roll-pitch] --out out/
  python -m cube_slam_wu_tpu_torch.cli kitti --seq <dir> --detections <dir> [--poses poses.txt]
      [--pose-feedback [--point-weight 0.3]] [--window 16] --out out/
  python -m cube_slam_wu_tpu_torch.cli detect-lines --image img.jpg [--short-recovery] --out out/
  python -m cube_slam_wu_tpu_torch.cli match-lines --image-a a.jpg --image-b b.jpg
      [--max-dist 25] --out out/

`offline` replays the saved cuboids of a TUM-layout folder
(slam/pipeline.py::run_offline_slam).  `online` runs the two-phase driver
(slam/pipeline.py::run_online_slam: the front-end pass, then the incremental
BA), or with `--fused` the fused per-frame step (slam/online.py); `--window W`
makes either a fixed-lag smoother over the trailing W frames.
`detect-cuboid` is the single-image proposal demo.  `kitti` runs the KITTI
driver over a KITTI-odometry-layout sequence.  `detect-lines` writes one
image's segments (saved_edges.txt|jpg); `match-lines` detects and
LBD-matches the segments of two images (line_matches.txt|jpg).  Each writes
the files the JAX package's command writes for the same command line (the TUM
commands: output_cam_poses.txt, output_obj_poses.txt, trajectory_top_view.png
and, with --save-cloud, map_cloud.ply).  Everything runs on the GPU unless
`--device cpu` is given, and fails when there is no GPU.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

# detect-cuboid's intrinsics without --calib (fx, fy, cx, cy): the reference's
# detect_3d_cuboid demo camera
DEMO_CALIB = (529.5, 529.5, 365.0, 265.0)


def _dtype(args):
    import torch

    return torch.float64 if args.float64 else torch.float32


def _write_outputs(out_dir, result, truth):
    """The TUM commands' files: the trajectory, object 0's per-frame history
    (or its final cuboid when the driver keeps none), the top view, then the
    ATE and RPE against the truth rows."""
    from PIL import Image

    from cube_slam_wu_tpu_torch.utils import io as uio
    from cube_slam_wu_tpu_torch.utils import viz
    from cube_slam_wu_tpu_torch.utils.metrics import ate_rmse, rpe_rmse

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    uio.write_tum_trajectory(
        out_dir / "output_cam_poses.txt", result.timestamps, result.traj_Twc_xyzq
    )
    obj_rows = (
        result.cube_history[:, 0, :]
        if result.cube_history is not None
        else result.cube_minimal[None]
    )
    np.savetxt(out_dir / "output_obj_poses.txt", obj_rows, fmt="%.6f")
    img = viz.trajectory_top_view(result.traj_Twc_xyzq[:, :3], truth[:, 1:4])
    Image.fromarray(img).save(out_dir / "trajectory_top_view.png")
    ate = ate_rmse(result.traj_Twc_xyzq[:, :3], truth[:, 1:4])
    print(f"ATE RMSE vs truth: {ate:.4f} m")
    if len(truth) > 1:
        rpe_t, rpe_r = rpe_rmse(result.traj_Twc_xyzq, truth[:, 1:8])
        print(f"RPE RMSE (delta=1): {rpe_t:.4f} m / {rpe_r:.4f} deg")
    print(f"outputs written to {out_dir}")


def _write_point_cloud(out_dir, base, result, every: int):
    """Merged colored point cloud from the dataset's RGB-D pairs at the
    OPTIMIZED camera poses (rviz cloud topic analogue, main_obj.cpp:73-101;
    depth scaling + calib at main_obj.cpp:340-345)."""
    import torch
    from PIL import Image

    from cube_slam_wu_tpu_torch.core.se3 import SE3
    from cube_slam_wu_tpu_torch.slam.online import TUM_K
    from cube_slam_wu_tpu_torch.utils import io as uio
    from cube_slam_wu_tpu_torch.utils import viz

    base = pathlib.Path(base)
    T_wc = SE3.from_xyzq(torch.as_tensor(result.traj_Twc_xyzq, dtype=torch.float64)).matrix().numpy()
    all_xyz, all_rgb = [], []
    for i in range(0, len(result.timestamps), every):
        depth_path = base / "depth_imgs" / f"{i:04d}_depth_raw.png"
        rgb_path = base / "raw_imgs" / f"{i:04d}_rgb_raw.jpg"
        if not depth_path.exists() or not rgb_path.exists():
            continue
        depth = np.asarray(Image.open(depth_path))
        xyz, cols = viz.depth_to_point_cloud(uio.load_image_rgb(rgb_path), depth, TUM_K, T_wc[i])
        all_xyz.append(xyz)
        all_rgb.append(cols)
    if not all_xyz:
        print("point cloud skipped: no depth_imgs/ found")
        return
    viz.write_ply(
        pathlib.Path(out_dir) / "map_cloud.ply", np.concatenate(all_xyz), np.concatenate(all_rgb)
    )
    print(f"point cloud ({sum(len(a) for a in all_xyz)} pts) -> {out_dir}/map_cloud.ply")


def _need_base(args):
    """Fail without the card (unless --device names another) or without the
    folder, before reading any file."""
    from cube_slam_wu_tpu_torch import resolve_device

    resolve_device(args.device)
    if not pathlib.Path(args.base).is_dir():
        raise SystemExit(f"error: --base {args.base!r} is not a directory")


def cmd_offline(args):
    from cube_slam_wu_tpu_torch.slam.pipeline import run_offline_slam
    from cube_slam_wu_tpu_torch.utils import io as uio

    _need_base(args)
    result = run_offline_slam(
        args.base, iterations=args.iterations, dtype=_dtype(args), device=args.device
    )
    truth = uio.read_number_txt(pathlib.Path(args.base) / "truth_cam_poses.txt")
    _write_outputs(args.out, result, truth)
    if args.save_cloud:
        _write_point_cloud(args.out, args.base, result, args.save_cloud)


def cmd_online(args):
    from cube_slam_wu_tpu_torch.slam.pipeline import SlamOutput, run_online_slam
    from cube_slam_wu_tpu_torch.utils import hostsync
    from cube_slam_wu_tpu_torch.utils import io as uio

    _need_base(args)
    window = args.window if args.window and args.window > 0 else None
    truth = uio.read_number_txt(pathlib.Path(args.base) / "truth_cam_poses.txt")
    if args.fused:
        from cube_slam_wu_tpu_torch.slam.online import run_online_slam_fused

        if args.point_weight or args.checkpoint:
            raise SystemExit(
                "error: --fused supports the default online config "
                "(no --point-weight / --checkpoint yet); drop --fused for those"
            )
        fr = run_online_slam_fused(
            args.base,
            n_frames=args.frames,
            dtype=_dtype(args),
            max_objects=args.max_objects,
            max_detections=args.max_detections or args.max_objects,
            iterations=args.iterations,
            bbox_edge_weight=args.bbox_edge_weight,
            window=window,
            device=args.device,
        )
        n = len(fr.traj_Twc_xyzq)
        result = SlamOutput(
            traj_Twc_xyzq=fr.traj_Twc_xyzq,
            cube_minimal=fr.cubes_minimal[0],
            chi2=fr.chi2,
            timestamps=truth[:n, 0],
            cubes_minimal=fr.cubes_minimal,
            cube_valid=fr.cube_valid,
        )
        print(
            f"fused: {fr.syncs_per_frame:.1f} host reads/frame, "
            f"{fr.bytes_up_per_frame / 1e6:.2f} MB up / "
            f"{fr.bytes_down_per_frame:.0f} B down; report {fr.report}"
        )
        _write_outputs(args.out, result, truth[:n])
        return
    before = hostsync.snapshot()
    result = run_online_slam(
        args.base,
        n_frames=args.frames,
        iterations=args.iterations,
        dtype=_dtype(args),
        bbox_edge_weight=args.bbox_edge_weight,
        window=window,
        point_weight=args.point_weight,
        max_objects=args.max_objects,
        max_detections=args.max_detections,
        checkpoint_path=args.checkpoint or None,
        checkpoint_every=args.checkpoint_every,
        device=args.device,
    )
    n = len(result.timestamps)
    reads = hostsync.snapshot()["syncs"] - before["syncs"]
    print(f"two-phase: {reads / n:.1f} host reads/frame; frontend: "
          f"{result.frontend_report.summary()}")
    _write_outputs(args.out, result, truth[:n])
    if args.save_cloud:
        _write_point_cloud(args.out, args.base, result, args.save_cloud)


def cmd_detect_lines(args):
    """Line detection on one image: writes the valid segments to
    saved_edges.txt and their overlay to saved_edges.jpg; returns the
    segments as numpy."""
    if not pathlib.Path(args.image).is_file():
        raise SystemExit(f"error: --image {args.image!r} not found")
    from PIL import Image

    from cube_slam_wu_tpu_torch import resolve_device
    from cube_slam_wu_tpu_torch.ops.detect import (
        DetectConfig,
        detect_line_segments,
        detect_line_segments_recover,
    )
    from cube_slam_wu_tpu_torch.utils import hostsync
    from cube_slam_wu_tpu_torch.utils import io as uio
    from cube_slam_wu_tpu_torch.utils import viz

    dev = resolve_device(args.device)
    gray = hostsync.push(uio.load_image_gray(args.image), dev, _dtype(args))
    if args.short_recovery:
        lines, mask = detect_line_segments_recover(gray, DetectConfig(short_recovery=True))
    else:
        lines, mask = detect_line_segments(gray)
    lines, mask = hostsync.pull((lines, mask))
    lines = lines[mask]
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savetxt(out_dir / "saved_edges.txt", lines, fmt="%.3f")
    rgb = uio.load_image_rgb(args.image)
    Image.fromarray(viz.draw_lines_overlay(rgb, lines)).save(out_dir / "saved_edges.jpg")
    print(f"{len(lines)} lines -> {out_dir}/saved_edges.txt|jpg")
    return lines


def cmd_match_lines(args):
    """Two-image line matching demo (the reference's match_line_descrip
    usage, line_lbd_allclass.cpp:352-369): detect + LBD descriptors on both
    frames, Hamming-match the binarized codes with the mutual check, write a
    drawLineMatches-style side-by-side picture and the (i, j, distance) rows
    of the matches.  Returns the two line sets and the match rows as numpy."""
    for path in (args.image_a, args.image_b):
        if not pathlib.Path(path).is_file():
            raise SystemExit(f"error: image {path!r} not found")
    from PIL import Image

    from cube_slam_wu_tpu_torch import resolve_device
    from cube_slam_wu_tpu_torch.ops.detect import detect_line_segments
    from cube_slam_wu_tpu_torch.ops.lbd import binarize_lbd, lbd_descriptors, match_lines_filtered
    from cube_slam_wu_tpu_torch.utils import hostsync
    from cube_slam_wu_tpu_torch.utils import io as uio
    from cube_slam_wu_tpu_torch.utils import viz

    dev = resolve_device(args.device)
    ga = hostsync.push(uio.load_image_gray(args.image_a), dev, _dtype(args))
    gb = hostsync.push(uio.load_image_gray(args.image_b), dev, _dtype(args))
    la, ma = detect_line_segments(ga)
    lb, mb = detect_line_segments(gb)
    da, va = lbd_descriptors(ga, la, ma)
    db, vb = lbd_descriptors(gb, lb, mb)
    idx, dist, matched = match_lines_filtered(
        binarize_lbd(da), binarize_lbd(db), va & ma, vb & mb, max_dist=args.max_dist
    )
    la, lb, idx, dist, matched = hostsync.pull((la, lb, idx, dist, matched))
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    img = viz.draw_line_matches(
        uio.load_image_rgb(args.image_a), la, uio.load_image_rgb(args.image_b), lb, idx, matched
    )
    Image.fromarray(img).save(out_dir / "line_matches.jpg")
    rows = np.column_stack([np.nonzero(matched)[0], idx[matched], dist[matched]])
    np.savetxt(out_dir / "line_matches.txt", rows, fmt="%d")
    print(f"{int(matched.sum())} matches -> {out_dir}/line_matches.jpg|txt")
    return dict(lines_a=la, lines_b=lb, rows=rows)


def cmd_detect_cuboid(args):
    """The single-image proposal demo.  Prints the winner (and the ranks with
    --top-k > 1), writes cuboid_proposal.jpg, and returns the proposals as
    numpy with their grid indices (`best`) and final scores (`final`)."""
    if not pathlib.Path(args.image).is_file():
        raise SystemExit(f"error: --image {args.image!r} not found")
    import torch
    from PIL import Image

    from cube_slam_wu_tpu_torch import resolve_device
    from cube_slam_wu_tpu_torch.ops.detect import detect_line_segments
    from cube_slam_wu_tpu_torch.ops.proposal import ProposalConfig, detect_cuboid_single
    from cube_slam_wu_tpu_torch.utils import hostsync
    from cube_slam_wu_tpu_torch.utils import io as uio
    from cube_slam_wu_tpu_torch.utils import viz

    dev = resolve_device(args.device)
    dtype = _dtype(args)
    gray = hostsync.push(uio.load_image_gray(args.image), dev, dtype)
    if args.edges:
        edges = uio.read_number_txt(args.edges)
        L = max(128, int(2 ** np.ceil(np.log2(len(edges) + 1))))
        lines = np.zeros((L, 4))
        lines[: len(edges)] = edges[:, :4]
        mask = np.zeros(L, bool)
        mask[: len(edges)] = True
        lines, mask = hostsync.push(lines, dev, dtype), hostsync.push(mask, dev)
    else:
        lines, mask = detect_line_segments(gray)
    fx, fy, cx, cy = _parse_floats(args.calib, 4, "calib") if args.calib else DEMO_CALIB
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    T_wc = (
        np.loadtxt(args.pose)
        if args.pose
        else np.array(
            [
                [1, 0.0011, 0.0004, 0],
                [0, -0.3376, 0.9413, 0],
                [0.0011, -0.9413, -0.3376, 1.35],
                [0, 0, 0, 1.0],
            ]
        )
    )
    bbox = np.asarray(_parse_floats(args.bbox, 4, "bbox"))
    cfg = ProposalConfig(
        max_lines=int(lines.shape[0]),
        sample_cam_roll_pitch=args.sample_roll_pitch,
        sample_bbox_height=args.sample_height,
        nominal_skew_ratio=args.skew,
        max_cuboid_num=max(args.top_k, 1),
    )
    res, internals = detect_cuboid_single(
        gray, *(hostsync.push(a, dev, dtype) for a in (K, T_wc, bbox)), lines, mask, cfg,
        return_internals=True,
    )
    best, final = internals["best"], internals["final"]
    host = hostsync.pull((*res, best, final[best]))
    res = type(res)(*host[: len(res)])
    out = dict(result=res, best=host[-2], final=host[-1])
    if args.top_k > 1:
        for r in range(args.top_k):
            print(
                f"rank {r}: valid={bool(res.valid[r])} "
                f"pos={np.round(res.pos[r], 4)} "
                f"scale={np.round(res.scale[r], 4)} "
                f"rotY={float(res.rotY[r]):.4f} "
                f"err={float(res.normalized_error[r]):.4f}"
            )
        # the winner drives the overlay
        res = type(res)(*(a if f == "cap_overflow" else a[0] for f, a in zip(res._fields, res)))
    print(f"valid: {bool(res.valid)}")
    print(f"pos:   {np.round(res.pos, 4)}")
    print(f"scale: {np.round(res.scale, 4)}")
    print(f"rotY:  {float(res.rotY):.4f}")
    print(f"config:{res.box_config_type}")
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    img = viz.draw_cuboid(
        uio.load_image_rgb(args.image),
        res.corners_2d,
        int(res.box_config_type[0]),
        int(res.box_config_type[1]),
    )
    Image.fromarray(img).save(out_dir / "cuboid_proposal.jpg")
    print(f"overlay -> {out_dir}/cuboid_proposal.jpg")
    return out


def _parse_floats(text, n, name):
    parts = text.split(",")
    try:
        vals = [float(v) for v in parts]
    except ValueError:
        raise SystemExit(
            f"error: --{name} expects {n} comma-separated numbers, got {text!r}"
        )
    if len(vals) != n:
        raise SystemExit(
            f"error: --{name} expects {n} comma-separated numbers, got {len(vals)}"
        )
    return vals


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


def _device_flags(parser):
    parser.add_argument("--float64", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device; default: the GPU (fails without one)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cube_slam_wu_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    po = sub.add_parser("offline", help="offline-mode SLAM over a dataset folder")
    po.add_argument("--base", required=True)
    po.add_argument("--out", default="out")
    po.add_argument("--iterations", type=int, default=5)
    po.add_argument("--save-cloud", type=int, default=0, metavar="N",
                    help="dump map_cloud.ply from every Nth RGB-D pair (0 = off)")
    _device_flags(po)
    po.set_defaults(fn=cmd_offline)

    pn = sub.add_parser("online", help="full online mono SLAM")
    pn.add_argument("--base", required=True)
    pn.add_argument("--out", default="out")
    pn.add_argument("--frames", type=int, default=None)
    pn.add_argument("--iterations", type=int, default=5)
    pn.add_argument("--bbox-edge-weight", type=float, default=0.005,
                    help="2D bbox projection-edge weight (0 = reference-"
                         "parity: 3D cuboid edges only)")
    pn.add_argument("--window", type=int, default=0,
                    help="sliding BA window (0 = full-graph re-optimisation)")
    pn.add_argument("--point-weight", type=float, default=0.0,
                    help="point-landmark reprojection weight in the joint "
                         "windowed BA (0 = off; needs --window)")
    pn.add_argument("--checkpoint", default="",
                    help="front-end checkpoint npz: saved every "
                         "--checkpoint-every frames, resumed if it exists; "
                         "a completed one acts as a front-end cache for "
                         "backend-setting sweeps")
    pn.add_argument("--checkpoint-every", type=int, default=25)
    pn.add_argument("--fused", action="store_true",
                    help="the fused per-frame step (slam/online.py) instead "
                         "of the two-phase driver")
    pn.add_argument("--save-cloud", type=int, default=0, metavar="N",
                    help="dump map_cloud.ply from every Nth RGB-D pair (0 = off)")
    pn.add_argument("--max-objects", type=int, default=1)
    pn.add_argument("--max-detections", type=int, default=None,
                    help="detections per frame (default: --max-objects)")
    _device_flags(pn)
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
    _device_flags(pk)
    pk.set_defaults(fn=cmd_kitti)

    pl = sub.add_parser("detect-lines", help="line detection on one image")
    pl.add_argument("--image", required=True)
    pl.add_argument("--out", default="out")
    pl.add_argument("--short-recovery", action="store_true",
                    help="additive short-segment recovery pass (~2x detector cost)")
    _device_flags(pl)
    pl.set_defaults(fn=cmd_detect_lines)

    pm = sub.add_parser("match-lines", help="detect + LBD-match lines across two images")
    pm.add_argument("--image-a", required=True)
    pm.add_argument("--image-b", required=True)
    pm.add_argument("--max-dist", type=int, default=25)
    pm.add_argument("--out", default="out")
    _device_flags(pm)
    pm.set_defaults(fn=cmd_match_lines)

    pc = sub.add_parser("detect-cuboid", help="single-image cuboid proposal")
    pc.add_argument("--image", required=True)
    pc.add_argument("--bbox", required=True, help="x,y,w,h")
    pc.add_argument("--edges", default=None, help="precomputed edges txt")
    pc.add_argument("--calib", default=None, help="fx,fy,cx,cy")
    pc.add_argument("--pose", default=None, help="4x4 T_wc txt")
    pc.add_argument("--skew", type=float, default=1.0)
    pc.add_argument("--sample-roll-pitch", action="store_true")
    pc.add_argument("--top-k", type=int, default=1,
                    help="return the K best-ranked proposals "
                         "(max_cuboid_num ObjectSet semantics)")
    pc.add_argument("--sample-height", action="store_true",
                    help="sample 3 bbox-height expansions (whether_sample_bbox_height)")
    pc.add_argument("--out", default="out")
    _device_flags(pc)
    pc.set_defaults(fn=cmd_detect_cuboid)
    return p


def main(argv=None):
    """Run one command; returns what the command returns (detect-cuboid: its
    proposals; detect-lines and match-lines: their lines and matches)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
