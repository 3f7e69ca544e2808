"""The detector's own stages on the CPU: `utils.hostsync` books self time and
enters a profiler range only while the profiler runs; one frame of the
single-image detector on the benchmark's 240x320 world (the cell's settings)
enters each of its nine stages, leaves no read outside them, and the
benchmark's per-layer readers of those stages read what the stages booked.
"""

import importlib.util
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cube_slam_wu_tpu_torch.utils import hostsync

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
SMALL = {"size": [240, 320], "n_frames": 6, "expected": "tum_fr3_w0_240x320"}
LABELS = ("lines/hough", "lines/runs", "lines/merge", "proposals/grid", "proposals/merge",
          "proposals/canny", "proposals/edt", "proposals/score", "proposals/rank")
SELF_MS = {
    "lines_hough_host_ms": "lines/hough", "lines_runs_host_ms": "lines/runs",
    "lines_merge_host_ms": "lines/merge", "proposals_grid_host_ms": "proposals/grid",
    "proposals_merge_host_ms": "proposals/merge", "proposals_canny_host_ms": "proposals/canny",
    "proposals_edt_host_ms": "proposals/edt", "proposals_score_host_ms": "proposals/score",
    "proposals_rank_host_ms": "proposals/rank",
}
READS = {"hysteresis_reads_per_frame": ("proposals/canny",),
         "merge_reads_per_frame": ("lines/merge", "proposals/merge")}


def _nested(prefix: str) -> None:
    with hostsync.stage(f"{prefix}/outer"):
        torch.ones(64).cumsum(0)
        for _ in range(2):
            with hostsync.stage(f"{prefix}/mid"):
                torch.ones(64).cumsum(0)
                with hostsync.stage(f"{prefix}/inner"):
                    torch.ones(64).cumsum(0)


def _assert_self_sums(by: dict, prefix: str) -> None:
    labels = [f"{prefix}/{k}" for k in ("outer", "mid", "inner")]
    total = sum(by[lab]["self_s"] for lab in labels)
    assert total == pytest.approx(by[labels[0]]["host_s"], rel=1e-9, abs=1e-12)
    assert all(by[lab]["self_s"] > 0 for lab in labels)
    assert by[labels[1]]["self_s"] < by[labels[1]]["host_s"]
    assert by[labels[2]]["self_s"] == by[labels[2]]["host_s"]


def test_nested_stages_book_self_time_on_one_thread():
    before = hostsync.snapshot()
    _nested("selftime1")
    _assert_self_sums(hostsync.delta(before, hostsync.snapshot())["by_stage"], "selftime1")


def test_nested_stages_book_self_time_on_two_threads_at_once():
    together = threading.Barrier(2)

    def work(k):
        with hostsync.stage(f"selftime2/{k}/outer"):
            together.wait(timeout=30)
            with hostsync.stage(f"selftime2/{k}/mid"):
                with hostsync.stage(f"selftime2/{k}/inner"):
                    together.wait(timeout=30)
                torch.ones(64).cumsum(0)

    before = hostsync.snapshot()
    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    by = hostsync.delta(before, hostsync.snapshot())["by_stage"]
    for k in range(2):
        _assert_self_sums(by, f"selftime2/{k}")


def _ranges(prof, label: str) -> list:
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() == label and e.is_user_annotation()]


def test_stage_enters_no_profiler_range_without_the_profiler(monkeypatch):
    entered = []
    real = hostsync.record_function
    monkeypatch.setattr(hostsync, "record_function",
                        lambda label: entered.append(label) or real(label))
    with hostsync.stage("noprof/open_before"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(8).sum()
    assert entered == [] and _ranges(prof, "noprof/open_before") == []


def test_stage_is_a_user_annotation_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with hostsync.stage("withprof/stage"):
            torch.ones(8).sum()
    assert len(_ranges(prof, "withprof/stage")) == 1


def _load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"stages_reader_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def frame():
    """One frame of the `tum_detect_cuboid` entry's calls on the 240x320
    expected world: (the detector's counts by `hostsync.delta`, the harness's
    `cell` module)."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness import cell
    from harness import expected as expected_mod
    from harness.frames import detect_inputs, proposal_config

    from cube_slam_wu_tpu_torch.ops.detect import detect_line_segments
    from cube_slam_wu_tpu_torch.ops.proposal import ProposalConfig, detect_cuboids

    c = cell.load_cell("tum_detect_cuboid", overrides=SMALL)
    world, _, differ = expected_mod.load(expected_mod.file_of(c.dir, SMALL["expected"]),
                                         c.settings)
    assert differ == []
    s, dt = c.settings, torch.float32
    gray_u8, xywh, mask, T_wc = detect_inputs(world, 0, s["max_detections"])
    gray = torch.as_tensor(np.ascontiguousarray(gray_u8)).to(dt)
    before = hostsync.snapshot()
    lines, lmask = detect_line_segments(gray)
    cfg = proposal_config(ProposalConfig, s, int(lines.shape[0]))
    detect_cuboids(gray, torch.as_tensor(world.K).to(dt), torch.as_tensor(T_wc).to(dt),
                   torch.as_tensor(xywh).to(dt), torch.as_tensor(mask), lines, lmask, cfg)
    return hostsync.delta(before, hostsync.snapshot()), cell


def test_detector_enters_each_stage_and_reads_only_inside_them(frame):
    d, _ = frame
    by = d["by_stage"]
    for label in LABELS:
        assert by[label]["entries"] == (2 if label == "proposals/grid" else 1), label
    assert by.get(hostsync.OUTSIDE, {}).get("syncs", 0) == 0
    flags = by["proposals/canny"]["syncs"] + by["lines/merge"]["syncs"] + by["proposals/merge"][
        "syncs"]
    assert flags == d["syncs"] > 0
    lines_self = sum(by[lab]["self_s"] for lab in LABELS[:3])
    assert lines_self == pytest.approx(by["lines/runs"]["host_s"], rel=1e-9)


def test_stage_readers_read_what_the_stages_booked(frame):
    d, cell = frame
    ctx = {"stages": cell._per_frame(d, {}, {}, 1)}
    by = d["by_stage"]
    for name, label in SELF_MS.items():
        reader = _load(BENCH / "metrics" / f"{name}.py")
        assert reader.read(ctx) == by[label]["self_s"] * 1e3, name
        assert reader.read({"stages": {}}) is None, name
    for name, labels in READS.items():
        reader = _load(BENCH / "metrics" / f"{name}.py")
        assert reader.read(ctx) == sum(by[lab]["syncs"] for lab in labels), name
        assert reader.read({"stages": {}}) is None, name
