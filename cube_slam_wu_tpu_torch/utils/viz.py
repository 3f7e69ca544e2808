"""Offline visualization artifacts (replaces the reference's rviz topics).

The reference publishes paths, pose arrays, cuboid MarkerArrays and projected
cuboid images over ROS (object_slam/src/main_obj.cpp:201-475); here the same
information is rendered into numpy images / txt dumps.  Edge tables mirror
get_object_edge_visibility / get_cuboid_draw_edge_markers
(detect_3d_cuboid/src/object_3d_util.cpp:78-166).  Numpy only; the images it
draws are pixel-equal to the JAX package's, so the files the two command
lines write are byte-equal.
"""

from __future__ import annotations

import numpy as np

# universal-layout edge tables (object_3d_util.cpp:84-97), 0-based
_EDGES_CFG1_VP1LEFT = [
    (2, 3), (3, 0), (3, 7),  # hidden
    (0, 1), (1, 2), (1, 5), (0, 4), (2, 6), (4, 5), (5, 6), (6, 7), (7, 4),
]
_EDGES_CFG1_VP1RIGHT = [
    (1, 2), (2, 3), (2, 6),
    (0, 1), (0, 3), (1, 5), (0, 4), (3, 7), (4, 5), (5, 6), (6, 7), (7, 4),
]
_EDGES_CFG2 = [
    (1, 2), (2, 3), (3, 0), (2, 6), (3, 7),
    (0, 1), (1, 5), (0, 4), (4, 5), (5, 6), (6, 7), (7, 4),
]


def _edge_table(config_id: int, vp1_pos: int):
    if config_id == 1:
        return _EDGES_CFG1_VP1LEFT if vp1_pos == 1 else _EDGES_CFG1_VP1RIGHT
    return _EDGES_CFG2


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 2) -> None:
    """Simple Bresenham-ish line rasterizer into an (H, W, 3) uint8 image."""
    h, w = img.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    xs = np.linspace(x0, x1, n)
    ys = np.linspace(y0, y1, n)
    r = thickness // 2
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            xi = np.clip(np.round(xs + dx).astype(int), 0, w - 1)
            yi = np.clip(np.round(ys + dy).astype(int), 0, h - 1)
            img[yi, xi] = color


def draw_cuboid(
    img: np.ndarray,
    corners_2d: np.ndarray,
    config_id: int = 1,
    vp1_pos: int = 1,
    color=(0, 255, 0),
    hidden_color=(0, 120, 0),
) -> np.ndarray:
    """Draw the 12 cuboid edges (hidden edges dimmer), corners_2d is (2, 8)
    in the universal layout (plot_image_with_cuboid analogue)."""
    out = img.copy()
    table = _edge_table(config_id, vp1_pos)
    n_hidden = 3 if config_id == 1 else 5
    for k, (a, b) in enumerate(table):
        c = hidden_color if k < n_hidden else color
        draw_line(out, corners_2d[:, a], corners_2d[:, b], c, 2)
    return out


def draw_lines_overlay(img: np.ndarray, lines: np.ndarray, color=(255, 0, 0)) -> np.ndarray:
    """Overlay detected segments (plot_image_with_edges analogue)."""
    out = img.copy()
    for l in np.asarray(lines):
        draw_line(out, l[:2], l[2:4], color, 2)
    return out


def trajectory_top_view(
    est_xyz: np.ndarray,
    truth_xyz: np.ndarray | None = None,
    size: int = 512,
) -> np.ndarray:
    """Render an XY top-down view of trajectories into an image."""
    img = np.full((size, size, 3), 255, np.uint8)
    pts = [np.asarray(est_xyz)[:, :2]]
    if truth_xyz is not None:
        pts.append(np.asarray(truth_xyz)[:, :2])
    allp = np.concatenate(pts, axis=0)
    lo = allp.min(axis=0) - 0.2
    hi = allp.max(axis=0) + 0.2
    scale = (size - 20) / max(hi - lo)

    def to_px(p):
        return 10 + (p - lo) * scale

    for arr, color in zip(pts, [(200, 30, 30), (30, 30, 200)]):
        px = to_px(arr)
        for a, b in zip(px[:-1], px[1:]):
            draw_line(img, a, b, color, 2)
    return img


def depth_to_point_cloud(
    rgb: np.ndarray,
    depth_u16: np.ndarray,
    K: np.ndarray,
    T_wc: np.ndarray,
    depth_scaling: float = 5000.0,
    near: float = 0.1,
    far: float = 3.0,
    voxel: float | None = 0.02,
):
    """Colored world-frame point cloud from an RGB-D pair
    (depth_to_cloud, object_slam/src/main_obj.cpp:73-101).

    `depth_u16` is the TUM 16-bit depth png (metres = value/depth_scaling,
    main_obj.cpp:341); points outside (near, far) are dropped; `voxel`
    applies the reference's 0.02 m approximate voxel-grid downsample
    (snap-to-voxel + per-voxel mean).  Returns (xyz (N,3), rgb (N,3) uint8).
    """
    depth = np.asarray(depth_u16, dtype=np.float64) / depth_scaling
    H, W = depth.shape
    ys, xs = np.mgrid[0:H, 0:W]
    ok = (depth > near) & (depth < far)
    z = depth[ok]
    x = (xs[ok] - K[0, 2]) / K[0, 0] * z
    y = (ys[ok] - K[1, 2]) / K[1, 1] * z
    pts_c = np.stack([x, y, z], axis=-1)
    xyz = pts_c @ np.asarray(T_wc)[:3, :3].T + np.asarray(T_wc)[:3, 3]
    cols = np.asarray(rgb)[ok].astype(np.float64)
    if voxel:
        key = np.floor(xyz / voxel).astype(np.int64)
        _, inv, counts = np.unique(
            key, axis=0, return_inverse=True, return_counts=True
        )
        n_vox = len(counts)
        acc_xyz = np.zeros((n_vox, 3))
        acc_rgb = np.zeros((n_vox, 3))
        np.add.at(acc_xyz, inv, xyz)
        np.add.at(acc_rgb, inv, cols)
        xyz = acc_xyz / counts[:, None]
        cols = acc_rgb / counts[:, None]
    return xyz, np.clip(np.round(cols), 0, 255).astype(np.uint8)


def write_ply(path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """ASCII PLY dump of a colored point cloud (offline stand-in for the
    reference's rviz PointCloud2 topic, main_obj.cpp:205-222)."""
    n = len(xyz)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")


def draw_line_matches(
    img_a: np.ndarray,
    lines_a: np.ndarray,
    img_b: np.ndarray,
    lines_b: np.ndarray,
    match_idx: np.ndarray,
    matched: np.ndarray,
    max_draw: int = 64,
) -> np.ndarray:
    """Side-by-side match visualization (drawLineMatches, line_lbd/libs/
    draw.cpp): both images stacked horizontally, matched segments drawn in
    a shared per-match colour with a connector between midpoints.

    lines_a/lines_b: (L, 4) [x1 y1 x2 y2]; match_idx: (La,) index into
    lines_b; matched: (La,) bool.  Returns an (H, Wa+Wb, 3) uint8 image.
    """
    a = np.asarray(img_a)
    b = np.asarray(img_b)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    if b.ndim == 2:
        b = np.stack([b] * 3, axis=-1)
    H = max(a.shape[0], b.shape[0])
    out = np.zeros((H, a.shape[1] + b.shape[1], 3), np.uint8)
    out[: a.shape[0], : a.shape[1]] = a.astype(np.uint8)
    out[: b.shape[0], a.shape[1] :] = b.astype(np.uint8)
    off = a.shape[1]
    rng = np.random.default_rng(0)
    drawn = 0
    for i in np.nonzero(np.asarray(matched))[0]:
        if drawn >= max_draw:
            break
        j = int(np.asarray(match_idx)[i])
        color = tuple(int(c) for c in rng.integers(64, 255, size=3))
        la = np.asarray(lines_a)[i]
        lb = np.asarray(lines_b)[j]
        draw_line(out, la[0:2], la[2:4], color)
        draw_line(out, (lb[0] + off, lb[1]), (lb[2] + off, lb[3]), color)
        ma = (la[0:2] + la[2:4]) / 2
        mb = ((lb[0] + lb[2]) / 2 + off, (lb[1] + lb[3]) / 2)
        draw_line(out, ma, mb, color, thickness=1)
        drawn += 1
    return out
