"""The comparison catches a broken timed path: a run on the CPU at a small
size, the program broken underneath, must come out not correct.  One test
per fault the cell can have: half of the frame's boxes left out, an answer
altered where it is produced (the ranked cuboids, the line segments).  The
detector keeps no state from frame to frame, and one card exchanges nothing
between chips, so no other fault applies.  And the control (the program in
a lower precision) must come out not correct too."""

import time

import pytest

from conftest import SMALL

PROPOSALS = ("cube_slam_wu_tpu_torch.ops.proposal", "detect_cuboids")
LINES = ("cube_slam_wu_tpu_torch.ops.detect", "detect_line_segments")


def half_the_boxes(detect):
    def wrapped(gray, K, T_wc, bboxes, bbox_mask, *a, **k):
        keep = bbox_mask.clone()
        keep[keep.shape[0] // 2:] = False
        return detect(gray, K, T_wc, bboxes, keep, *a, **k)
    return wrapped


def cuboids_moved(detect):
    def wrapped(*a, **k):
        res = detect(*a, **k)
        return res._replace(pos=res.pos + 0.01)
    return wrapped


def lines_moved(detect):
    def wrapped(*a, **k):
        lines, mask = detect(*a, **k)
        return lines + 0.5, mask
    return wrapped


def run_broken(monkeypatch, target, wrap):
    import importlib

    from harness import cell

    module, attr = target
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    return cell.run("tum_detect_cuboid", 2**31 + 202, 6.0, False, time.perf_counter(),
                    device="cpu", overrides=SMALL["tum_fr3"], log=lambda s: None)


FAULTS = [(PROPOSALS, half_the_boxes), (PROPOSALS, cuboids_moved), (LINES, lines_moved)]


@pytest.mark.parametrize("target,wrap", FAULTS, ids=[w.__name__ for _, w in FAULTS])
def test_broken_timed_path_is_not_correct(target, wrap, monkeypatch):
    r = run_broken(monkeypatch, target, wrap)
    assert r["correct"] is False and r["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_unbroken_run_is_correct(monkeypatch):
    """The same run with nothing broken (the wrappers' own plumbing intact)."""
    r = run_broken(monkeypatch, PROPOSALS, lambda detect: detect)
    assert r["correct"]


def test_control_is_not_correct_on_cpu():
    """The control at the small size; here TF32 does not exist, so only the
    detector's bfloat16 blur is lowered."""
    import control

    out = control.control_readings("tum_detect_cuboid", 2**31 + 203, device="cpu",
                                   overrides=SMALL["tum_fr3"])
    assert out["frames"] == SMALL["tum_fr3"]["n_frames"]
    assert out["control_not_correct"], out


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3001, 3002, 3003])
def test_control_is_not_correct_on_the_card(card, seed):
    """At the cell's own size, every frame of the world (needs the card)."""
    import control

    out = control.control_readings("tum_detect_cuboid", seed, device=str(card))
    assert out["control_not_correct"], out
