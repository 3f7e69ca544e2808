"""The cell `kitti_points_w16` whole on the CPU at a small size: its world at
240x320 and 8 frames, window 4, 16 point slots, 4 object slots.  Untraced,
it is correct and reports the end-to-end metrics; traced, it reads its eight
per-layer metrics; with the step broken underneath (the point weight zeroed,
or 4 LM iterations where the configuration has 5), it is not correct."""

import time

import pytest

SMALL = {"size": [240, 320], "n_frames": 8, "window": 4, "n_points": 16, "max_objects": 4}
LAYER = {"kitti_frontend_host_ms", "kitti_features_host_ms", "kitti_associate_host_ms",
         "kitti_insert_host_ms", "kitti_points_host_ms", "kitti_lm_host_ms",
         "kitti_lm_rejected_per_frame", "kitti_ba_points_per_frame"}
STEP = ("cube_slam_wu_tpu_torch.slam.tracker", "make_windowed_point_step")


def run_small(seed, trace=False, seconds=16.0):
    from harness import cell

    return cell.run("kitti_points_w16", seed, seconds, trace, time.perf_counter(), device="cpu",
                    overrides=SMALL, log=lambda s: None)


def test_cell_agrees_with_its_reference_on_cpu():
    r = run_small(2**31 + 401)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["checks"]) == {"pose_miss_pct", "cube_miss_pct", "point_miss_pct", "ate_m"}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert set(r["metrics"]) == {"frame_ms", "frame_ms_p90", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


def test_traced_run_reads_the_new_layers_on_cpu():
    r = run_small(2**31 + 402, trace=True, seconds=20.0)
    assert r["correct"]
    assert LAYER <= set(r["metrics"]), set(r["metrics"])
    assert r["metrics"]["kitti_ba_points_per_frame"]["value"] > 0
    assert "breakdown" in r and r["device"]["window_s"] > 0


def points_off(make):
    def wrapped(*a, **k):
        return make(*a, **{**k, "point_weight": 0.0})
    return wrapped


def four_iterations(make):
    def wrapped(window, K, iterations=5, *a, **k):
        return make(window, K, 4, *a, **k)
    return wrapped


@pytest.mark.parametrize("wrap", [points_off, four_iterations], ids=lambda w: w.__name__)
def test_broken_step_is_not_correct(wrap, monkeypatch):
    import importlib

    mod = importlib.import_module(STEP[0])
    monkeypatch.setattr(mod, STEP[1], wrap(getattr(mod, STEP[1])))
    r = run_small(2**31 + 403)
    assert r["correct"] is False and r["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
