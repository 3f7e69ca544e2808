"""Dataset IO: images, whitespace-separated txt tables, TUM pose files.

Covers the reference's file contracts (read_all_number_txt,
matrix_utils.cpp:209-245; the TUM-format trajectory txts and the
`x y w h prob` YOLO txts under object_slam/data/).  All readers return numpy;
conversion to device tensors happens at the pipeline boundary.
"""

from __future__ import annotations

import pathlib

import numpy as np


def read_number_txt(path, min_cols: int | None = None) -> np.ndarray:
    """Whitespace table -> (rows, cols) float array; skips '#' comments and
    blank lines (read_all_number_txt semantics)."""
    rows = []
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        rows.append([float(tok) for tok in line.split()])
    if not rows:
        return np.zeros((0, min_cols or 0))
    width = max(len(r) for r in rows)
    out = np.zeros((len(rows), width))
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def load_image_gray(path) -> np.ndarray:
    """Load an image as the rounded BT.601 grayscale float array the proposal
    engine expects (see ops.image.rgb_to_gray).  Needs Pillow."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float64)
    gray = img @ np.asarray([0.299, 0.587, 0.114])
    return np.floor(gray + 0.5)


def load_image_rgb(path) -> np.ndarray:
    """Load an image as (H, W, 3) uint8 RGB.  Needs Pillow."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def write_tum_trajectory(path, timestamps, poses_xyzq) -> None:
    """Write TUM rows `t x y z qx qy qz qw` (same schema as the reference's
    output_cam_poses.txt, main_obj.cpp:305-336)."""
    arr = np.concatenate(
        [np.asarray(timestamps)[:, None], np.asarray(poses_xyzq)], axis=1
    )
    header = "timestamp tx ty tz qx qy qz qw"
    np.savetxt(path, arr, fmt="%.6f", header=header)


def detections_from_rows(rows: np.ndarray, n_max: int | None = None):
    """Detection rows `x y w h conf` -> (boxes (N, 4) float64 corners
    [x1 y1 x2 y2], conf (N,), mask (N,) bool); with `n_max` the arrays are
    padded/truncated to exactly n_max rows for fixed-shape pipelines."""
    rows = np.asarray(rows, dtype=np.float64)
    rows = rows.reshape(-1, 5) if rows.size else np.zeros((0, 5))
    boxes = np.column_stack(
        [
            rows[:, 0],
            rows[:, 1],
            rows[:, 0] + rows[:, 2],
            rows[:, 1] + rows[:, 3],
        ]
    )
    conf = rows[:, 4]
    mask = np.ones(len(rows), bool)
    if n_max is not None:
        n = len(rows)
        if n >= n_max:
            order = np.argsort(-conf)[:n_max]  # keep highest-confidence
            boxes, conf, mask = boxes[order], conf[order], mask[order]
        else:
            pad = n_max - n
            boxes = np.vstack([boxes, np.zeros((pad, 4))])
            conf = np.concatenate([conf, np.zeros(pad)])
            mask = np.concatenate([mask, np.zeros(pad, bool)])
    return boxes, conf, mask


def read_detections_txt(path, n_max: int | None = None):
    """Read a per-frame 2D detection file (yolo-style rows `x y w h conf`,
    the reference's filter_2d_obj_txts layout consumed by main_obj.cpp's
    online branch).  Empty files (detector dropout) yield zero valid rows.
    See `detections_from_rows` for the return value."""
    return detections_from_rows(read_number_txt(path), n_max)
