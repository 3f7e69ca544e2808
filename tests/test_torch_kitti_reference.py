"""The KITTI driver's per-frame result hook and the benchmark's plain float64
reference of the windowed point step (`benchmark/references/kitti_points.py`)
on the CPU, at a small size of the `kitti_points_w16` cell: its world at
240x320, window 4, 16 point slots, 4 object slots, and the world's 10 frames,
the session ended by the hook after 6 (frames 4 and 5 absorb into the prior).

- the reference agrees with the port's step frame by frame from the same
  carry: in float32 (the production dtype) poses, landmarks and carried
  points within the cell's tolerances; in float64 to 1e-8;
- three broken steps are each caught by at least one of the cell's numbers;
- the hook fires once per frame with the values `SlamOutput` returns, ends
  the run when it returns true, and adds no host read;
- the step's counts are consistent with its LM iterations;
- the run books the same entries, reads and bytes by stage label as the
  driver did before its two frame loops shared one front end;
- the reference loads nothing of the port, of the JAX package or of JAX.
"""

import functools
import importlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from cube_slam_wu_tpu_torch.slam import pipeline, tracker
from cube_slam_wu_tpu_torch.slam import window as win_mod
from cube_slam_wu_tpu_torch.utils import hostsync
from kitti_parity import booked

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"

SMALL = {"size": [240, 320], "n_frames": 10, "window": 4, "n_points": 16, "max_objects": 4}
STOP_AFTER = 6  # frames in the hooked session
PLAIN_FRAMES = 5  # frames of the run without a hook


def bench(module: str):
    """A module of the benchmark: the harness's world, the cell's entry or
    its reference."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    return importlib.import_module(module)


@functools.cache
def settings() -> dict:
    cfg = json.loads((BENCH / "configs" / "kitti_odom07.json").read_text())
    return {**cfg, **SMALL}


@functools.cache
def world():
    return bench("harness.world").make_world(settings(), 0)


def kitti_kw(dtype=torch.float32) -> dict:
    s = settings()
    return dict(pose_feedback=True, point_weight=s["point_weight"], window=s["window"],
                n_points=s["n_points"], max_objects=s["max_objects"],
                max_detections=s["max_detections"], iterations=s["iterations"], dtype=dtype,
                device="cpu")


def frames():
    w = world()
    return [(w.images[i], w.detections[i]) for i in range(len(w.images))]


@functools.cache
def hooked_run():
    """The session ended by the hook after STOP_AFTER frames: (its output,
    the FrameResults, the host reads counted before the run and at each call
    of the hook, what the run booked under `kitti/step`, and its entries,
    reads and bytes by stage label (`kitti_parity.booked`))."""
    torch.set_num_threads(1)
    got, reads = [], []

    def on_result(r):
        got.append(r)
        reads.append(hostsync.snapshot()["syncs"])
        return r.i + 1 == STOP_AFTER

    w = world()
    snap = hostsync.snapshot()
    out = pipeline.run_kitti_frames(frames(), w.K, w.T_wc[0], on_result=on_result, **kitti_kw())
    after = hostsync.snapshot()
    book = hostsync.delta(snap, after)["by_stage"]["kitti/step"]
    return out, got, [snap["syncs"]] + reads, book, booked(snap, after)


def arrays(r):
    entry = bench("entries.kitti_points")
    return (entry.state_arrays(r.carry_before), entry.input_arrays(r.step_input),
            entry.state_arrays(r.carry_after))


@functools.cache
def reference_steps():
    """The reference's state after each frame of the hooked run."""
    ref = bench("references.kitti_points")
    s, K = settings(), world().K
    return [ref.step(*arrays(r)[:2], r.i, K, s["window"], s["iterations"], s["point_weight"])
            for r in hooked_run()[1]]


def misses(after_of, first: int = 0) -> dict:
    """The cell's numbers over the hooked run's frames from `first` on, each
    frame's state after the step given by `after_of(FrameResult)` (plain
    arrays)."""
    ref = bench("references.kitti_points")
    tot = {}
    for r, h in list(zip(hooked_run()[1], reference_steps()))[first:]:
        for k, (m, n) in ref.frame_misses(h, after_of(r), settings()["window"]).items():
            a = tot.setdefault(k, [0, 0])
            a[0], a[1] = a[0] + m, a[1] + n
    return {f"{k}_miss_pct": 100.0 * m / max(n, 1) for k, (m, n) in tot.items()}


def limits() -> dict:
    return json.loads((BENCH / "limits" / "kitti_points_w16.json").read_text())


def port_step(**over):
    s = settings()
    kw = dict(window=s["window"], K=hooked_run()[1][0].carry_after[0].K,
              iterations=s["iterations"], soft_gate_alpha=2.0, point_weight=s["point_weight"])
    kw.update(over)
    return tracker.make_windowed_point_step(**kw)


def cast(tree, dtype):
    """Floating tensors of nested (named) tuples in `dtype`, each pose's
    quaternion normalised there (float32 ones are unit to ~1e-7 only)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if torch.is_floating_point(tree) else tree
    if isinstance(tree, tuple):
        parts = [cast(x, dtype) for x in tree]
        if getattr(tree, "_fields", None) == ("quat", "trans"):
            parts[0] = parts[0] / torch.linalg.norm(parts[0], dim=-1, keepdim=True)
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


def test_reference_agrees_with_the_float32_step():
    """Every frame of the run in float32 (the production dtype): no pose and
    no landmark misses the cell's tolerances, validity is alike, and every
    point carried from the frame before lies within the point tolerance.
    A point that DLT triangulates in the frame itself may part by a few cm:
    at this size its 4 observations span 0.15 m, and the float32 DLT (an
    eigenvector of A^T A) starts it where 5 LM iterations do not close the
    gap; a frame later it agrees to mm.  The session's last frames hold
    landmarks in the prior and points in the solve."""
    ref = bench("references.kitti_points")

    got = misses(lambda r: arrays(r)[2])
    assert got["pose_miss_pct"] == 0.0 and got["cube_miss_pct"] == 0.0, got
    for r, h in zip(hooked_run()[1], reference_steps()):
        before, _, a = arrays(r)
        for k in ("cube_valid", "prior_valid", "point_valid"):
            np.testing.assert_array_equal(a[k], h[k].numpy(), err_msg=f"frame {r.i} {k}")
        carried = a["point_valid"] & before["point_valid"]
        dev = np.linalg.norm(a["points"] - h["points"].numpy(), axis=-1)[carried]
        assert (dev <= ref.POINT_TOL_M).all(), (r.i, dev.max())
    assert a["prior_valid"].any() and a["point_valid"].sum() >= 8


def test_reference_agrees_with_the_float64_step():
    """The port's step in float64 from each frame's carry (cast) against the
    reference: poses, landmarks and points to 1e-8 m, validity alike, the
    same accepted LM iterations where the frame's error is above rounding."""
    entry = bench("entries.kitti_points")
    ref = bench("references.kitti_points")
    step = port_step(K=hooked_run()[1][0].carry_after[0].K.to(torch.float64))
    s = settings()
    for r in hooked_run()[1]:
        before, inp = cast(r.carry_before, torch.float64), cast(r.step_input, torch.float64)
        h = ref.step(entry.state_arrays(before), entry.input_arrays(inp), r.i, world().K,
                     s["window"], s["iterations"], s["point_weight"])
        after, (_, _, stats) = step(before, inp)
        a = entry.state_arrays(after)
        sl = slice(h["start"], h["start"] + s["window"])
        aR = ref.quat_to_R(torch.as_tensor(a["cam_q"][sl])).numpy()
        np.testing.assert_allclose(np.einsum("fji,fj->fi", aR, a["cam_t"][sl]),
                                   np.einsum("fji,fj->fi", h["cam_R"][sl].numpy(),
                                             h["cam_t"][sl].numpy()), atol=1e-8)
        v = a["cube_valid"]
        np.testing.assert_array_equal(v, h["cube_valid"].numpy())
        np.testing.assert_allclose(a["cube_t"][v], h["cube_t"].numpy()[v], atol=1e-8)
        np.testing.assert_allclose(a["cube_s"][v], h["cube_s"].numpy()[v], atol=1e-8)
        pv = a["point_valid"]
        np.testing.assert_array_equal(pv, h["point_valid"].numpy())
        np.testing.assert_allclose(a["points"][pv], h["points"].numpy()[pv], atol=1e-8)
        if r.chi2 > 1e-6:  # at chi2 ~ 0 (frame 0) rounding decides each step
            assert int(stats[0]) == h["accepted"]


def _drop_prior(prior, *a, **k):
    return win_mod.CubePrior.empty(prior.valid.shape[0], prior.H.dtype, prior.H.device)


BROKEN = {
    "point_weight_zeroed": dict(point_weight=0.0),
    "prior_dropped": dict(),
    "four_lm_iterations": dict(iterations=4),
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_step_is_caught(name, monkeypatch):
    """The step broken three ways, from the carry of each frame that absorbs
    into the prior: at least one number over its limit."""
    state_arrays = bench("entries.kitti_points").state_arrays

    if name == "prior_dropped":
        monkeypatch.setattr(win_mod, "absorb_frame", _drop_prior)
    step = port_step(**BROKEN[name])
    got = misses(lambda r: state_arrays(step(r.carry_before, r.step_input)[0]),
                 first=settings()["window"])
    assert any(got[k] > limits()[k] for k in got), got


def test_hook_fires_once_per_frame_with_the_returned_values():
    """One FrameResult per frame in order, its values those of the frame's
    step and of `SlamOutput`; returning true ended the run after that frame
    (SlamOutput over frames 0..5 of the world's 10)."""
    out, got = hooked_run()[:2]
    assert [r.i for r in got] == list(range(STOP_AFTER))
    assert len(out.chi2) == len(out.traj_Twc_xyzq) == len(out.cube_history) == STOP_AFTER
    assert out.frontend_report.n_frames == STOP_AFTER
    for r in got:
        assert r.chi2 == out.chi2[r.i]
        np.testing.assert_array_equal(r.cubes_minimal, out.cube_history[r.i])
        g = r.carry_after[0]
        np.testing.assert_array_equal(r.Tcw, g.cam_Tcw[r.i].matrix().numpy())
        np.testing.assert_array_equal(r.Tcw_prev, g.cam_Tcw[max(r.i - 1, 0)].matrix().numpy())
        np.testing.assert_array_equal(r.cube_pos, g.cube.pose.trans.numpy())
        np.testing.assert_array_equal(r.cube_valid, g.cube_valid.numpy())
        assert r.step_input[0] == r.i
        assert r.i == 0 or r.carry_before is got[r.i - 1].carry_after
    # the last frame's pose is the one the run returns
    T = np.linalg.inv(got[-1].Tcw.astype(np.float64))
    np.testing.assert_allclose(out.traj_Twc_xyzq[-1, :3], T[:3, 3], atol=1e-5)


def test_hook_adds_no_host_read():
    """The same frames without a hook read the host as often: the reads up to
    frame PLAIN_FRAMES - 1's hook, plus the run's final pull."""
    reads = hooked_run()[2]
    w = world()
    before = hostsync.snapshot()["syncs"]
    pipeline.run_kitti_frames(frames(), w.K, w.T_wc[0], n_frames=PLAIN_FRAMES, **kitti_kw())
    assert hostsync.snapshot()["syncs"] - before == reads[PLAIN_FRAMES] - reads[0] + 1


def test_step_counts_add_up_to_the_iterations():
    """Per frame, the LM iterations accepted (the step's stats, handed to
    the hook with the frame's pull) and rejected (booked under `kitti/step`)
    add up to the iterations, and the points in the solve are the valid
    points; the step itself books nothing (it is run again on one frame's
    carry, and gives the same stats)."""
    iters = settings()["iterations"]
    got, book = hooked_run()[1], hooked_run()[3]
    assert all(0 <= r.lm_accepted <= iters for r in got)
    assert book["lm_rejected"] == sum(iters - r.lm_accepted for r in got)
    assert all(r.ba_points == int(r.carry_after[2].point_valid.sum()) for r in got)
    assert book["ba_points"] == sum(r.ba_points for r in got)
    r = got[-1]
    before = hostsync.snapshot()["by_stage"].get("kitti/step")
    _, (_, _, stats) = port_step()(r.carry_before, r.step_input)
    assert hostsync.snapshot()["by_stage"].get("kitti/step") == before
    assert [int(v) for v in stats] == [r.lm_accepted, r.ba_points]


# What the hooked run books by stage label: (entries, syncs, h2d_bytes,
# d2h_bytes) (kitti_parity.booked), recorded from the driver at commit a9456dc,
# before its two frame loops shared one front end.  The per-layer metrics of
# kitti_points_w16 read these labels; a change that alters the reads on purpose
# updates the literals.
BOOKED = {
    "kitti/associate": (6, 0, 1368, 0),
    "kitti/detect_lines": (6, 0, 0, 0),
    "kitti/features": (6, 6, 1360, 1504),
    "kitti/proposals": (6, 0, 0, 0),
    "kitti/step": (6, 0, 1056, 0),
    "lines/hough": (6, 0, 0, 0),
    "lines/merge": (6, 14, 0, 14),
    "lines/runs": (6, 0, 0, 0),
    "other": (0, 13, 461592, 3784),
    "proposals/canny": (6, 84, 0, 84),
    "proposals/edt": (6, 0, 0, 0),
    "proposals/grid": (12, 0, 0, 0),
    "proposals/merge": (6, 11, 0, 11),
    "proposals/rank": (6, 0, 0, 0),
    "proposals/score": (6, 0, 0, 0),
    "step/insert": (6, 0, 0, 0),
    "step/lm": (6, 0, 0, 0),
    "step/points": (6, 0, 0, 0),
}


def test_run_books_the_same_stages_reads_and_bytes():
    assert hooked_run()[4] == BOOKED


def test_on_result_needs_the_interleaved_loop():
    w = world()
    with pytest.raises(ValueError, match="on_result"):
        pipeline.run_kitti_frames(frames(), w.K, w.T_wc[0], on_result=lambda r: False,
                                  **{**kitti_kw(), "pose_feedback": False, "point_weight": 0.0})


def test_reference_loads_nothing_of_the_port_or_jax():
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import references.kitti_points; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH)], capture_output=True,
                         text=True, timeout=120, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "cube_slam_wu_tpu", "cube_slam_wu_tpu_torch"}
