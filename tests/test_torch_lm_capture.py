"""The fixed-lag point LM's capture path, on the CPU (the capture itself
runs on a card only: `tests/test_torch_cuda.py::
test_point_lm_replay_matches_eager_on_card`).

- `point_ba.captured_lm` is plain `point_ba.optimize` on the CPU, bit for
  bit, and counts no capture or replay;
- the device constants of `core/` (`rotations.device_constant`) equal the
  literals they replace in both dtypes, and one first built inside `jacfwd`
  is a plain tensor;
- the point step (`tracker.make_windowed_point_step`) reads bit for bit what
  it read with the literals built on every call.

The drive: a camera 1.65 m above the ground moving 0.12 m a frame, two
cuboids with noisy measurements and 2D boxes, twelve ground points; window
4 over eight frames, so frames 4-7 absorb into the prior.  Port only.
"""

import functools
import math

import numpy as np
import pytest
import torch

from cube_slam_wu_tpu_torch.core import cuboid as cb
from cube_slam_wu_tpu_torch.core import rotations as rot
from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.slam import point_ba, tracker
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph
from cube_slam_wu_tpu_torch.slam.window import CubePrior
from cube_slam_wu_tpu_torch.utils import hostsync
from cube_slam_wu_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

N, O, P, W = 8, 2, 12, 4
K = np.array([[240.0, 0, 160], [0, 240, 115], [0, 0, 1]])
DTYPES = {"f32": torch.float32, "f64": torch.float64}


@functools.cache
def scene(seed=3):
    """Poses, cuboid measurements and boxes, and point tracks (numpy)."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((N, 4, 4))
    for i in range(N):
        gt[i] = np.eye(4)
        gt[i][:3, :3] = [[1, 0, 0], [0, 0, 1], [0, -1, 0]]
        gt[i][:3, 3] = [0.02 * np.sin(i * 0.3), 0.12 * i, 1.65]
    cubes = np.array([[-1.2, 4.0, 0.5, 0, 0, 0.3, 0.5, 0.4, 0.5],
                      [1.4, 5.0, 0.4, 0, 0, 1.0, 0.6, 0.3, 0.4]])
    meas9, bbox = np.zeros((N, O, 9)), np.zeros((N, O, 4))
    has = np.zeros((N, O), bool)
    Kt = torch.as_tensor(K)
    for i in range(N):
        T = SE3.from_matrix(torch.as_tensor(gt[i]))
        for o in range(O):
            if i % 4 == 3 and o == 1:
                continue  # a missed detection
            cube = Cuboid.from_minimal(torch.as_tensor(cubes[o]))
            bbox[i, o] = cube.project_bbox(T.inverse(), Kt).numpy() + rng.normal(0, 1.0, 4)
            m = cube.transform_to(T).to_minimal().numpy()
            m[:3] += rng.normal(0, 0.05, 3)
            m[5] += rng.normal(0, 0.03)
            meas9[i, o], has[i, o] = m, True
    pts_w = np.column_stack([rng.uniform(-3, 3, P), rng.uniform(3, 9, P), np.zeros(P)])
    obs_uv, obs_mask = np.zeros((N, P, 2)), np.zeros((N, P), bool)
    for i in range(N):
        Rcw = gt[i][:3, :3].T
        pc = pts_w @ Rcw.T + (-Rcw @ gt[i][:3, 3])
        uv = pc @ K.T
        uv = uv[:, :2] / uv[:, 2:3]
        ok = (pc[:, 2] > 0.5) & (uv[:, 0] > 5) & (uv[:, 0] < 315) & (uv[:, 1] > 5) & (uv[:, 1] < 235)
        obs_uv[i] = np.where(ok[:, None], uv + rng.normal(0, 0.3, (P, 2)), 0.0)
        obs_mask[i] = ok
    return dict(gt=gt, meas9=meas9, bbox=bbox, has=has, obs_uv=obs_uv, obs_mask=obs_mask)


def drive(dtype):
    """The step over the scene's frames: the carry after every frame."""
    s = scene()
    t = lambda a: torch.as_tensor(a).to(dtype)
    frames = tracker.FrameInput(
        meas=Cuboid.from_minimal(t(s["meas9"])), quality=t(np.where(s["has"], 0.75, 0.0)),
        has_meas=torch.as_tensor(s["has"]), active=torch.ones((N,), dtype=torch.bool),
        bbox=t(s["bbox"]), bbox_weight=t(np.where(s["has"], 0.005, 0.0)),
    )
    first = SE3.from_matrix(t(s["gt"][0]))
    step = tracker.make_windowed_point_step(W, t(K), iterations=3, point_weight=0.3,
                                            soft_gate_alpha=1.0)
    carry = (CameraObjectGraph.empty(N, O, dtype)._replace(K=t(K)), CubePrior.empty(O, dtype),
             tracker.PointState.empty(N, P, dtype))
    no = torch.zeros((P,), dtype=torch.bool)
    out = []
    for i in range(N):
        inp = (i, tree_map(lambda a: a[i], frames), first, t(s["obs_uv"][i]),
               torch.as_tensor(s["obs_mask"][i]), no, torch.ones((P,), dtype=torch.bool))
        carry, outputs = step(carry, inp)
        out.append((carry, outputs))
    return out


def leaves(tree) -> list:
    return tree_flatten(tree)[0]


@pytest.mark.parametrize("dt", DTYPES)
def test_device_constants_equal_the_literals(dt):
    dtype, cpu = DTYPES[dt], torch.device("cpu")
    assert torch.equal(rot._conjugate_signs(dtype, cpu),
                       torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=dtype))
    for a in cb._FACE_ANGLES:
        assert torch.equal(cb._yaw_quat(a, dtype, cpu),
                           rot.quat_from_yaw(torch.tensor(a, dtype=dtype)))
    assert torch.equal(cb._face_table(dtype, cpu),
                       rot.quat_from_yaw(torch.tensor(cb._FACE_ANGLES, dtype=dtype)))
    assert torch.equal(cb._corners_body(dtype, cpu), torch.tensor(cb._CORNERS_BODY, dtype=dtype))
    scale = torch.arange(24, dtype=dtype).reshape(2, 4, 3)
    assert torch.equal(cb._swap_lw(scale), scale[..., [1, 0, 2]])
    # made first inside jacfwd: still a plain tensor, usable outside it
    made = []

    @rot.device_constant
    def const(dtype, device):
        return torch.tensor([2.0, 3.0], dtype=dtype, device=device)

    def f(x):
        made.append(const(dtype, cpu))
        return made[-1] * x

    jac = torch.func.jacfwd(f)(torch.ones(2, dtype=dtype))
    assert torch.equal(jac, torch.diag(torch.tensor([2.0, 3.0], dtype=dtype)))
    assert not torch._C._functorch.is_functorch_wrapped_tensor(made[0])
    assert const(dtype, cpu) is made[0]


class _Checked:
    """A fresh `CapturedLM` that holds each result to eager `optimize`."""

    def __init__(self):
        self.lm = point_ba.CapturedLM()
        self.calls = []

    captures = property(lambda self: self.lm.captures)
    replays = property(lambda self: self.lm.replays)

    def __call__(self, *args, **kw):
        got = self.lm(*args, **kw)
        ref = point_ba.optimize(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(ref)))
        self.calls.append(kw["prior"] is not None and kw["point_huber"] == 2.0)
        self.last = (args, kw)
        return got


def test_captured_lm_on_cpu_is_optimize(monkeypatch):
    """Every frame's LM of the drive (float32, the prior from frame 4, the
    2-px point Huber): `CapturedLM` returns what `optimize` returns, bit for
    bit, and books nothing."""
    checked = _Checked()
    monkeypatch.setattr(point_ba, "captured_lm", checked)
    before = hostsync.snapshot()
    drive(torch.float32)
    booked = hostsync.delta(before, hostsync.snapshot())["by_stage"].get("kitti/step", {})
    assert checked.calls == [True] * N
    assert (checked.lm.captures, checked.lm.replays, checked.lm.graphs) == (0, 0, {})
    assert "lm_replays" not in booked and "lm_captures" not in booked
    # the signature a card keys its graphs by, and the static inputs'
    # round trip (the CPU path returns before either)
    (graph, pts, K), kw = checked.last
    found, spec = tree_flatten((graph, pts, K, kw["prior"]))
    back = tree_unflatten(spec, [t.clone() for t in found])
    again = tree_flatten(back)[1]
    assert hash(spec) == hash(again) and spec == again
    assert [type(x) for x in back] == [type(graph), type(pts), type(K), type(kw["prior"])]
    assert back[1].baseline == pts.baseline and back[1].obs_ur is None
    options = {k: v for k, v in kw.items() if k != "prior"}
    ref = point_ba.optimize(graph, pts, K, prior=kw["prior"], **options)
    got = point_ba.optimize(*back[:3], prior=back[3], **options)
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(ref)))


def _literal_conjugate(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def _literal_rotate(self, yaw_angle):
    q = rot.quat_from_yaw(torch.tensor(yaw_angle, dtype=self.scale.dtype, device=self.scale.device))
    new_pose = SE3(rot.quat_normalize(rot.quat_multiply(self.pose.quat, q.expand(self.pose.quat.shape))),
                   self.pose.trans)
    swap = (abs(abs(float(yaw_angle)) - math.pi / 2) < 1e-9
            or abs(float(yaw_angle) - 3 * math.pi / 2) < 1e-9)
    return Cuboid(new_pose, self.scale[..., [1, 0, 2]] if swap else self.scale)


def _literal_log_error_for_choice(self, other, choice):
    dtype, dev = self.scale.dtype, self.scale.device
    table = rot.quat_from_yaw(torch.tensor(cb._FACE_ANGLES, dtype=dtype, device=dev))
    q = rot.quat_normalize(rot.quat_multiply(other.pose.quat, table[choice]))
    swap = (choice == 0) | (choice == 2)
    scale = torch.where(swap[..., None], other.scale[..., [1, 0, 2]], other.scale)
    return self.log_error(Cuboid(SE3(q, other.pose.trans), scale))


def _literal_corners_3d(self):
    body = torch.tensor(cb._CORNERS_BODY, dtype=self.scale.dtype, device=self.scale.device)
    R = self.pose.rotation_matrix()
    return R @ (self.scale[..., :, None] * body) + self.pose.trans[..., :, None]


def test_point_step_reads_as_with_the_literals(monkeypatch):
    """The step's carry and outputs after every frame in float32, with the
    device constants and with the constants built from literals on every
    call as the code built them before: bit for bit."""
    now = drive(torch.float32)
    for owner, name, literal in ((rot, "quat_conjugate", _literal_conjugate),
                                 (Cuboid, "rotate", _literal_rotate),
                                 (Cuboid, "log_error_for_choice", _literal_log_error_for_choice),
                                 (Cuboid, "corners_3d", _literal_corners_3d)):
        monkeypatch.setattr(owner, name, literal)
    before = drive(torch.float32)
    for i, (a, b) in enumerate(zip(now, before)):
        la, lb = leaves(a), leaves(b)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert torch.equal(x, y), f"frame {i}"
    points = now[-1][0][2]
    assert int(points.point_valid.sum()) >= P // 2
    assert bool(now[-1][0][1].valid.all()), "both objects in the prior"
