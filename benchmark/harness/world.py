"""The benchmark's frozen world generator (numpy only).

A copy of the port's `utils/synth.py::make_sequence` with its helpers (commit
fd3f06e) and of the parity tests' `tilt`, so that later changes to the port
cannot move the benchmark's inputs.  It renders sequences of flat-shaded
cuboids on a ground plane seen from a camera driving forward, with the 2D
detector's boxes per frame (rows `x y w h conf`, 1-based x/y as the
reference's txt files hold them).

Conventions: camera x right / y down / z forward, world z-up, camera
CAMERA_HEIGHT_M above ground.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

CAMERA_HEIGHT_M = 1.65  # nominal cam0 height above ground (KITTI setup)

# flat-shade gray levels by face orientation (world axes); distinct levels
# give each cuboid edge a clean intensity step for Canny / line detection
_FACE_SHADE = {"top": 230, "front": 120, "back": 90, "left": 160, "right": 60}
_SKY = 200
_GROUND_NEAR = 170
_GROUND_FAR = 185


class SynthObject(NamedTuple):
    pos: np.ndarray  # (3,) world, z = half-height (sits on ground)
    yaw: float
    scale: np.ndarray  # (3,) half-extents (l, w, h)


class SynthSequence(NamedTuple):
    K: np.ndarray
    T_wc: np.ndarray  # (N, 4, 4) camera-to-world, z-up world
    images: list  # N arrays (H, W) uint8
    detections: list  # N arrays (D_i, 5) [x y w h conf] (1-based x/y, matlab
    # convention like the reference's txts, main_obj.cpp:620 subtracts 1)
    objects: list  # list[SynthObject] ground truth
    timestamps: np.ndarray


def _corners_world(obj: SynthObject) -> np.ndarray:
    """(8, 3) corners: bottom 4 then top 4, counter-clockwise."""
    sx, sy, sz = obj.scale
    c, s = np.cos(obj.yaw), np.sin(obj.yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    local = np.array(
        [
            [dx, dy, dz]
            for dz in (-sz, sz)
            for dx, dy in ((sx, sy), (-sx, sy), (-sx, -sy), (sx, -sy))
        ]
    )
    return obj.pos[None, :] + local @ R.T


# faces as corner index quads + outward normal in object frame
_FACES = [
    ((4, 5, 6, 7), np.array([0, 0, 1.0]), "top"),
    ((0, 1, 5, 4), np.array([0, 1.0, 0]), "front"),
    ((2, 3, 7, 6), np.array([0, -1.0, 0]), "back"),
    ((1, 2, 6, 5), np.array([-1.0, 0, 0]), "left"),
    ((3, 0, 4, 7), np.array([1.0, 0, 0]), "right"),
]


def camera_pose(t: float, speed: float = 1.0, curve: float = 0.0) -> np.ndarray:
    """T_wc at arc-length time t: forward along +y with optional curvature
    (turn rate rad/s), camera level, CAMERA_HEIGHT_M above ground."""
    if abs(curve) > 1e-9:
        r = speed / curve
        heading = curve * t
        x = r * (1 - np.cos(heading))
        y = r * np.sin(heading)
    else:
        heading = 0.0
        x, y = 0.0, speed * t
    hdg = np.array([-np.sin(heading), np.cos(heading), 0.0])
    right = np.array([np.cos(heading), np.sin(heading), 0.0])
    up = np.array([0.0, 0.0, 1.0])
    T = np.eye(4)
    # camera axes in world: x=right, y=down, z=forward(heading)
    T[:3, 0], T[:3, 1], T[:3, 2] = right, -up, hdg
    T[:3, 3] = np.array([x, y, CAMERA_HEIGHT_M])
    return T


def _ground_speckle(T_wc, K, size, amplitude, cell=0.25, max_range=30.0):
    """World-anchored procedural ground texture: each ground pixel's ray is
    intersected with z = 0 and the hit cell hashed to a gray offset — the
    pattern is attached to the WORLD, so it is view-consistent across frames
    (a screen-space noise would be untrackable).  Amplitude fades with range
    so sub-pixel far cells do not alias frame to frame.  Returns (H, W)
    additive offsets (zero above the horizon / beyond range)."""
    H, W = size
    R_wc = T_wc[:3, :3]
    C = T_wc[:3, 3]
    us, vs = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    rays_c = np.stack([us, vs, np.ones_like(us)], axis=-1) @ np.linalg.inv(K).T
    d_w = rays_c @ R_wc.T  # (H, W, 3)
    dz = d_w[..., 2]
    with np.errstate(all="ignore"):
        t = -C[2] / dz
    hit = (dz < -1e-6) & (t > 0) & (t < max_range / np.maximum(1e-6, np.linalg.norm(d_w, axis=-1)))
    Xw = C[None, None, :2] + t[..., None] * d_w[..., :2]
    ix = np.floor(Xw[..., 0] / cell).astype(np.int64)
    iy = np.floor(Xw[..., 1] / cell).astype(np.int64)
    h = ((ix * 73856093) ^ (iy * 19349663)) & 0xFFFF
    val = (h / 65535.0) * 2.0 - 1.0
    rng_m = t * np.linalg.norm(d_w, axis=-1)
    fade = np.clip(1.0 - rng_m / max_range, 0.0, 1.0)
    return np.where(hit, amplitude * val * fade, 0.0)


def render_frame(
    T_wc: np.ndarray, objects, K: np.ndarray, size=(480, 640),
    ground_texture: float = 0.0,
) -> np.ndarray:
    """Flat-shaded render of the cuboid set: painter's algorithm over
    back-face-culled faces.  Returns (H, W) uint8.

    `ground_texture` > 0 adds world-anchored speckle to the ground plane
    (gray-level amplitude): real roads have trackable micro-texture, and a
    perfectly flat-shaded ground starves any point-feature front-end — set
    it when exercising the point-landmark pipeline."""
    H, W = size
    img = np.full((H, W), _SKY, np.float64)
    # ground: rows below the horizon get a gentle depth gradient
    R_cw = T_wc[:3, :3].T
    t_c = -R_cw @ T_wc[:3, 3]
    fy, cy = K[1, 1], K[1, 2]
    rows = np.arange(H, dtype=np.float64)
    # level camera: the ground plane's vanishing line sits at the principal
    # row, so everything below cy is ground
    del fy
    horizon = cy
    ground = rows[:, None] >= horizon
    frac = np.clip((rows[:, None] - horizon) / max(H - horizon, 1.0), 0, 1)
    img = np.where(ground, _GROUND_FAR + (_GROUND_NEAR - _GROUND_FAR) * frac, img)
    if ground_texture > 0.0:
        img = img + _ground_speckle(T_wc, K, size, ground_texture)

    faces = []
    for obj in objects:
        cw = _corners_world(obj)
        cc = cw @ R_cw.T + t_c[None, :]
        if np.any(cc[:, 2] < 0.3):
            continue  # behind / too close: skip the whole object
        uv = (cc @ K.T)
        uv = uv[:, :2] / uv[:, 2:3]
        c, s = np.cos(obj.yaw), np.sin(obj.yaw)
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        for quad, n_local, name in _FACES:
            n_world = Rz @ n_local
            n_cam = R_cw @ n_world
            center_cam = cc[list(quad)].mean(axis=0)
            if np.dot(n_cam, center_cam) >= 0:
                continue  # back-face
            depth = center_cam[2]
            faces.append((depth, uv[list(quad)], _FACE_SHADE[name]))
    faces.sort(key=lambda f: -f[0])

    ys = np.arange(H) + 0.5
    xs = np.arange(W) + 0.5
    for _, quad, shade in faces:
        x0 = max(int(np.floor(quad[:, 0].min())), 0)
        x1 = min(int(np.ceil(quad[:, 0].max())) + 1, W)
        y0 = max(int(np.floor(quad[:, 1].min())), 0)
        y1 = min(int(np.ceil(quad[:, 1].max())) + 1, H)
        if x0 >= x1 or y0 >= y1:
            continue
        gx = xs[x0:x1][None, :]
        gy = ys[y0:y1][:, None]
        # winding-agnostic convex test: inside iff all edge cross-products
        # share a sign (projected quads can wind either way)
        pos = np.ones((y1 - y0, x1 - x0), bool)
        neg = np.ones((y1 - y0, x1 - x0), bool)
        for k in range(4):
            ax, ay = quad[k]
            bx, by = quad[(k + 1) % 4]
            cross = (bx - ax) * (gy - ay) - (by - ay) * (gx - ax)
            pos &= cross >= 0
            neg &= cross <= 0
        inside = pos | neg
        patch = img[y0:y1, x0:x1]
        img[y0:y1, x0:x1] = np.where(inside, float(shade), patch)
    return np.clip(img, 0, 255).astype(np.uint8)


def detect_objects(
    T_wc: np.ndarray,
    objects,
    K: np.ndarray,
    size=(480, 640),
    noise_px: float = 1.0,
    dropout: float = 0.0,
    min_height_px: float = 25.0,
    rng=None,
) -> np.ndarray:
    """Ground-truth 2D detections: projected-corner bboxes with pixel noise
    and optional dropout.  Rows [x y w h conf], 1-based coords like the
    reference's filter_2d_obj_txts (main_obj.cpp:620)."""
    rng = rng or np.random.default_rng(0)
    H, W = size
    R_cw = T_wc[:3, :3].T
    t_c = -R_cw @ T_wc[:3, 3]
    rows = []
    for obj in objects:
        cc = _corners_world(obj) @ R_cw.T + t_c[None, :]
        if np.any(cc[:, 2] < 0.3):
            continue
        uv = cc @ K.T
        uv = uv[:, :2] / uv[:, 2:3]
        x0, y0 = uv.min(axis=0)
        x1, y1 = uv.max(axis=0)
        # only fully-visible objects: a truncated bbox misstates the object
        # extent and breaks single-view depth (the reference consumes
        # pre-FILTERED yolo boxes, "cleaned yolo", main_obj.cpp:614)
        if x0 < 2 or y0 < 2 or x1 > W - 3 or y1 > H - 3:
            continue
        if (x1 - x0) < 10 or (y1 - y0) < min_height_px:
            continue
        if rng.random() < dropout:
            continue
        jit = rng.normal(0, noise_px, 4)
        x0, y0, x1, y1 = x0 + jit[0], y0 + jit[1], x1 + jit[2], y1 + jit[3]
        x0, x1 = np.clip([x0, x1], 0, W - 1)
        y0, y1 = np.clip([y0, y1], 0, H - 1)
        if x1 <= x0 + 5 or y1 <= y0 + 5:
            continue
        rows.append([x0 + 1, y0 + 1, x1 - x0, y1 - y0, 0.9])
    return np.asarray(rows).reshape(-1, 5)


def make_sequence(
    n_frames: int = 60,
    n_objects: int = 4,
    size=(480, 640),
    speed: float = 0.8,
    curve: float = 0.0,
    dt: float = 0.1,
    noise_px: float = 1.0,
    dropout: float = 0.0,
    seed: int = 0,
    objects: list | None = None,
    ground_texture: float = 0.0,
) -> SynthSequence:
    """Generate a full synthetic sequence: objects scattered ahead of the
    trajectory on both road sides (or an explicit `objects` list), camera
    driving forward."""
    rng = np.random.default_rng(seed)
    H, W = size
    K = np.array(
        [[0.75 * W, 0, W / 2.0], [0, 0.75 * W, H / 2.0 - 0.05 * H], [0, 0, 1.0]]
    )
    total_dist = speed * dt * n_frames
    if objects is not None:
        T_wc = np.stack(
            [camera_pose(i * dt, speed, curve) for i in range(n_frames)]
        )
        images = [
            render_frame(T, objects, K, size, ground_texture=ground_texture)
            for T in T_wc
        ]
        detections = [
            detect_objects(
                T, objects, K, size, noise_px=noise_px, dropout=dropout, rng=rng
            )
            for T in T_wc
        ]
        timestamps = np.arange(n_frames) * dt
        return SynthSequence(K, T_wc, images, detections, list(objects), timestamps)
    objects = []
    for i in range(n_objects):
        side = -1.0 if i % 2 == 0 else 1.0
        y = 5.0 + (total_dist + 7.0) * (i + 0.5) / n_objects
        x = side * rng.uniform(1.2, 2.2)
        scale = np.array(
            [rng.uniform(0.5, 1.1), rng.uniform(0.35, 0.6), rng.uniform(0.4, 0.8)]
        )
        yaw = rng.uniform(-0.4, 0.4) + (0.0 if i % 2 else np.pi / 2)
        objects.append(
            SynthObject(np.array([x, y, scale[2]]), float(yaw), scale)
        )

    T_wc = np.stack([camera_pose(i * dt, speed, curve) for i in range(n_frames)])
    images = [
        render_frame(T, objects, K, size, ground_texture=ground_texture)
        for T in T_wc
    ]
    detections = [
        detect_objects(
            T, objects, K, size, noise_px=noise_px, dropout=dropout, rng=rng
        )
        for T in T_wc
    ]
    timestamps = np.arange(n_frames) * dt
    return SynthSequence(K, T_wc, images, detections, objects, timestamps)




def tilt(T, roll_deg: float, pitch_deg: float) -> np.ndarray:
    """Pose(s) T with the camera turned by `roll_deg` about its optical axis
    and `pitch_deg` about its x axis (the images stay as they are).  At an
    exactly level camera the vertical vanishing point is a tie that rounding
    decides; a fraction of a degree breaks it."""
    r, p = np.radians(roll_deg), np.radians(pitch_deg)
    Rx = np.array([[1, 0, 0], [0, np.cos(p), -np.sin(p)], [0, np.sin(p), np.cos(p)]])
    Rz = np.array([[np.cos(r), -np.sin(r), 0], [np.sin(r), np.cos(r), 0], [0, 0, 1]])
    out = np.array(T, dtype=np.float64)
    out[..., :3, :3] = out[..., :3, :3] @ Rx @ Rz
    return out


def boxes_from_rows(rows, n_max: int):
    """Detection rows `x y w h conf` -> (corner boxes (n_max, 4) [x1 y1 x2
    y2], mask (n_max,) bool): the highest-confidence n_max rows, padded with
    zeros (the port's `utils/io.py::detections_from_rows`, copied)."""
    rows = np.asarray(rows, dtype=np.float64)
    rows = rows.reshape(-1, 5) if rows.size else np.zeros((0, 5))
    boxes = np.column_stack(
        [rows[:, 0], rows[:, 1], rows[:, 0] + rows[:, 2], rows[:, 1] + rows[:, 3]]
    )
    conf = rows[:, 4]
    mask = np.ones(len(rows), bool)
    if len(rows) >= n_max:
        order = np.argsort(-conf)[:n_max]
        boxes, mask = boxes[order], mask[order]
    else:
        pad = n_max - len(rows)
        boxes = np.vstack([boxes, np.zeros((pad, 4))])
        mask = np.concatenate([mask, np.zeros(pad, bool)])
    return boxes, mask


WORLD_KEYS = ("n_frames", "n_objects", "size", "speed", "curve", "noise_px", "dropout",
              "ground_texture")


def make_world(cfg: dict, seed: int) -> SynthSequence:
    """The configuration's world rendered from `seed` (or from the settings'
    `world_seed`, where the traffic fixes the world and the seed only orders
    its frames), every pose tilted by the configuration's `tilt_deg` (roll,
    pitch)."""
    kw = {k: cfg[k] for k in WORLD_KEYS}
    kw["size"] = tuple(kw["size"])
    seq = make_sequence(seed=cfg.get("world_seed", seed), **kw)
    return seq._replace(T_wc=tilt(seq.T_wc, *cfg["tilt_deg"]))
