"""The detector's inputs per frame, built alike for the program and for the
maker of the expected answers (`expected/make_expected.py`)."""

from __future__ import annotations

import numpy as np

from harness.world import boxes_from_rows

# the proposal fields pulled per frame and compared
FIELDS = ("valid", "pos", "scale", "rotY", "normalized_error")


def detect_inputs(world, i: int, n_detections: int):
    """(gray u8, boxes (D, 4) [x y w h] 0-based, mask (D,), T_wc (4, 4))."""
    boxes_c, mask = boxes_from_rows(world.detections[i], n_detections)
    xywh = np.stack([boxes_c[:, 0] - 1.0, boxes_c[:, 1] - 1.0,
                     boxes_c[:, 2] - boxes_c[:, 0], boxes_c[:, 3] - boxes_c[:, 1]], axis=-1)
    return world.images[i], xywh, mask, world.T_wc[i]


def proposal_config(ProposalConfig, s: dict, max_lines: int):
    return ProposalConfig(max_lines=max_lines, sample_cam_roll_pitch=s["sample_roll_pitch"],
                          sample_bbox_height=s["sample_height"],
                          nominal_skew_ratio=s["skew"], max_cuboid_num=s["top_k"])
