"""The capture helper `utils.capture.Captured` and its two users on the CPU
(the capture itself runs on a card only: `tests/test_torch_cuda.py::
test_point_lm_replay_matches_eager_on_card` and
`test_absorb_replay_matches_eager_on_card`).

- `Captured` on CPU tensors is the plain function: its result, no capture,
  no replay, no graph;
- a graph's key (`capture.signature`) tells apart what must not share a
  graph (shapes, dtypes, an option's value) and round-trips the arguments;
- the fixed-lag point step absorbs through `window.captured_absorb` on
  every frame, the frames before the window is full included, bit for bit
  as `window.absorb_frame`, and books no absorption count on the CPU; the
  step without points absorbs every frame through eager `absorb_frame`;
- `captured_absorb` runs whatever the module's `absorb_frame` is when it is
  called.

The drive is `test_torch_lm_capture`'s scene: window 4 over eight frames.
Port only.
"""

import numpy as np
import pytest
import torch
from test_torch_lm_capture import N, O, W, drive, leaves, scene

from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.slam import tracker
from cube_slam_wu_tpu_torch.slam import window as win_mod
from cube_slam_wu_tpu_torch.utils import hostsync
from cube_slam_wu_tpu_torch.utils.capture import Captured, signature
from cube_slam_wu_tpu_torch.utils.tree import tree_unflatten


def _prior_args(dtype=torch.float32, n_objects=O):
    """An absorption's arguments: an empty prior, a frozen pose, the scene's
    frame-4 measurements and the frame-0 ones as estimates."""
    s = scene()
    t = lambda a: torch.as_tensor(a).to(dtype)
    meas = Cuboid.from_minimal(t(s["meas9"][4, :n_objects]))
    est = Cuboid.from_minimal(t(s["meas9"][0, :n_objects]))
    return (win_mod.CubePrior.empty(n_objects, dtype), SE3.from_matrix(t(s["gt"][4])), meas,
            torch.full((n_objects,), 1.5, dtype=dtype), torch.as_tensor(s["has"][4, :n_objects]), est)


def test_captured_on_cpu_is_the_function():
    calls = []

    def fn(tree, x, scale=1.0, shift=None):
        calls.append(scale)
        return (tree[0] * scale + x, tree[1], shift)

    captured = Captured(fn)
    tree = (torch.arange(3.0), None)
    x = torch.ones(3)
    got = captured(tree, x, scale=2.0)
    assert torch.equal(got[0], torch.tensor([1.0, 3.0, 5.0])) and got[1:] == (None, None)
    assert captured(tree, x)[0].tolist() == [1.0, 2.0, 3.0]
    assert calls == [2.0, 1.0]
    assert (captured.captures, captured.replays, captured.graphs) == (0, 0, {})


def test_signature_tells_graphs_apart_and_round_trips():
    args = _prior_args()
    leaves_, spec = signature(args, {})
    # new values of the same shapes share the key
    other = _prior_args()
    assert signature((other[0], *other[1:4], ~other[4], other[5]), {})[1] == spec
    for changed in (signature(args, {"absorb_gate": 5.0})[1],
                    signature(args, {"info_cap": 1e4})[1],
                    signature(_prior_args(torch.float64), {})[1],
                    signature(_prior_args(n_objects=1), {})[1]):
        assert changed != spec
    assert signature(args, {"absorb_gate": 5.0})[1] != signature(args, {"absorb_gate": 3.0})[1]
    back, options = tree_unflatten(*signature(args, {"info_cap": 1e3})[::-1])
    assert dict(options) == {"info_cap": 1e3}
    assert [type(a) for a in back] == [type(a) for a in args]
    assert len(leaves_) == len(leaves(args)) == 18
    assert all(a is b for a, b in zip(leaves(back), leaves(args)))


class _CheckedAbsorb:
    """A fresh `Captured` absorption that holds each result to eager
    `window.absorb_frame` (as it was when built) and counts the calls."""

    def __init__(self):
        self.captured = Captured(win_mod.absorb_frame)
        self.masks = []

    captures = property(lambda self: self.captured.captures)
    replays = property(lambda self: self.captured.replays)

    def __call__(self, *args, **kw):
        got = self.captured(*args, **kw)
        ref = self.captured.fn(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(ref)))
        self.masks.append(bool(args[4].any()))
        return got


def _plain_windowed_drive(dtype):
    """`run_incremental` with window 4 and no points (`make_windowed_step`)
    over the scene."""
    s = scene()
    t = lambda a: torch.as_tensor(a).to(dtype)
    frames = tracker.FrameInput(
        meas=Cuboid.from_minimal(t(s["meas9"])), quality=t(np.where(s["has"], 0.75, 0.0)),
        has_meas=torch.as_tensor(s["has"]), active=torch.ones((N,), dtype=torch.bool),
    )
    return tracker.run_incremental(SE3.from_matrix(t(s["gt"][0])), frames, window=W,
                                   iterations=3, soft_gate_alpha=1.0)


@pytest.mark.parametrize("step", ["point", "plain"])
def test_steps_absorb_every_frame(step, monkeypatch):
    """Every frame of the drive absorbs once (an empty mask before the
    window is full): the point step through `captured_absorb`, bit for bit
    as `absorb_frame`, the step without points through eager
    `absorb_frame`; nothing is captured or booked on the CPU."""
    checked = _CheckedAbsorb()
    monkeypatch.setattr(win_mod, "captured_absorb", checked)
    eager = []

    def counted(*args, **kw):
        eager.append(bool(args[4].any()))
        return checked.captured.fn(*args, **kw)

    monkeypatch.setattr(win_mod, "absorb_frame", counted)
    before = hostsync.snapshot()
    out = drive(torch.float32) if step == "point" else _plain_windowed_drive(torch.float32)
    booked = hostsync.delta(before, hostsync.snapshot())["by_stage"].get("kitti/step", {})
    every = [False] * W + [True] * (N - W)
    assert (checked.masks, eager) == ((every, []) if step == "point" else ([], every))
    assert (checked.captures, checked.replays, checked.captured.graphs) == (0, 0, {})
    assert not any(k.startswith("absorb_") for k in booked)
    assert len(out) == (N if step == "point" else 3)


def test_captured_absorb_runs_the_module_function(monkeypatch):
    seen = []

    def replaced(prior, *args, **kw):
        seen.append(kw)
        return prior

    monkeypatch.setattr(win_mod, "absorb_frame", replaced)
    args = _prior_args()
    assert win_mod.captured_absorb(*args, info_cap=1e3) is args[0]
    assert seen == [{"info_cap": 1e3}]
    assert (win_mod.captured_absorb.captures, win_mod.captured_absorb.replays) == (0, 0)
