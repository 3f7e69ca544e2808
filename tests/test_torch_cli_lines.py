"""Port parity: `cli detect-lines` and `cli match-lines` against the JAX
package's commands on a 240x320 synthetic pair, and the numpy helpers they
write with (utils/viz.py draw_lines_overlay / draw_line_matches,
utils/metrics.py line_endpoint_stability).

- detect-lines: saved_edges.txt compared as a set of segments (the detector
  is a set function between the packages: counts within 5 %, >= 95 % matched
  within 0.5 px), with and without --short-recovery, both in float32; the
  printed line names the count and the files.  The two-pass detector is also
  held on the second frame, through the same JAX compile.
- match-lines: on IDENTICAL line sets (the JAX command is handed the port's
  detections, so only the descriptors, codes and matcher differ),
  line_matches.txt holds the same (i, j, distance) rows and line_matches.jpg
  is byte-equal.
- the helpers: byte-equal images and equal numbers on the same inputs.
"""

import filecmp

import numpy as np
import pytest
import torch

from torch_parity import assert_same_segment_sets, run_cli_both

import jax.numpy as jnp

from cube_slam_wu_tpu.utils import metrics as jmetrics
from cube_slam_wu_tpu.utils import viz as jviz
from cube_slam_wu_tpu_torch.utils import metrics as tmetrics
from cube_slam_wu_tpu_torch.utils import synth
from cube_slam_wu_tpu_torch.utils import viz as tviz


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Frames 0 and 1 of a 240x320 synthetic drive as lossless PNGs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("pair")
    seq = synth.make_sequence(n_frames=2, n_objects=3, size=(240, 320), seed=1, speed=3.0)
    paths = []
    for i, img in enumerate(seq.images):
        p = root / f"{i:04d}.png"
        Image.fromarray(img).save(p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("extra", [[], ["--short-recovery"]], ids=["plain", "short_recovery"])
def test_cli_detect_lines_matches_jax(pair, tmp_path, capsys, monkeypatch, extra):
    """Both commands detect in float32, the JAX command's dtype without x64
    (this suite enables x64, so its reader's image is handed over as
    float32)."""
    from cube_slam_wu_tpu.utils import io as jio

    read = jio.load_image_gray
    monkeypatch.setattr(jio, "load_image_gray", lambda p: read(p).astype(np.float32))
    (jout, jtext), (pout, ptext) = run_cli_both(
        tmp_path, capsys, ["detect-lines", "--image", pair[0], *extra],
        port_flags=("--device", "cpu"),
    )
    a = np.loadtxt(jout / "saved_edges.txt", ndmin=2)
    b = np.loadtxt(pout / "saved_edges.txt", ndmin=2)
    assert_same_segment_sets(a, b, min_count=8)
    assert ptext.strip() == f"{len(b)} lines -> {pout}/saved_edges.txt|jpg"
    assert jtext.strip().split(" ")[1:3] == ptext.strip().split(" ")[1:3]
    assert (pout / "saved_edges.jpg").stat().st_size > 0


def test_recover_on_the_second_frame_and_its_prefix(pair):
    """`detect_line_segments_recover` on frame 1 (frame 0 goes through the
    command above): 768 slots, the valid set matches JAX's, and the first
    slots are the port's plain detector's output verbatim."""
    from cube_slam_wu_tpu.ops import detect as jdet
    from cube_slam_wu_tpu_torch.ops import detect as tdet
    from cube_slam_wu_tpu_torch.utils import io as tuio

    img = tuio.load_image_gray(pair[1]).astype(np.float32)
    cfg = dict(short_recovery=True)
    jl, jm = jdet.detect_line_segments_recover(jnp.asarray(img), jdet.DetectConfig(**cfg))
    tl, tm = tdet.detect_line_segments_recover(torch.from_numpy(img), tdet.DetectConfig(**cfg))
    assert tl.shape == (768, 4) and np.asarray(jl).shape == (768, 4)
    pl, pm = tdet.detect_line_segments(torch.from_numpy(img), tdet.DetectConfig(**cfg))
    n1 = int(pm.sum())
    assert torch.equal(tl[:n1], pl[:n1]) and bool(tm[:n1].all()) and int(tm.sum()) > n1
    assert_same_segment_sets(np.asarray(jl)[np.asarray(jm)], tl[tm].numpy(), min_count=8)


def test_cli_match_lines_matches_jax(pair, tmp_path, capsys, monkeypatch):
    from cube_slam_wu_tpu.ops import detect as jdet
    from cube_slam_wu_tpu_torch import cli as tcli
    from cube_slam_wu_tpu_torch.ops import detect as tdet
    from cube_slam_wu_tpu_torch.utils import io as tuio

    port_out = tmp_path / "port"
    got = tcli.main(["match-lines", "--image-a", pair[0], "--image-b", pair[1],
                     "--out", str(port_out), "--device", "cpu"])
    ptext = capsys.readouterr().out
    # the JAX command gets the port's detections of the same images
    gray_a = torch.as_tensor(tuio.load_image_gray(pair[0]), dtype=torch.float32)
    np.testing.assert_array_equal(got["lines_a"], tdet.detect_line_segments(gray_a)[0].numpy())

    def fixed(gray, *a, **k):
        g = torch.tensor(np.asarray(gray), dtype=torch.float32)
        lines, mask = tdet.detect_line_segments(g)
        return jnp.asarray(lines.numpy()), jnp.asarray(mask.numpy())

    monkeypatch.setattr(jdet, "detect_line_segments", fixed)
    from cube_slam_wu_tpu import cli as jcli

    jout = tmp_path / "jax"
    jcli.main(["match-lines", "--image-a", pair[0], "--image-b", pair[1], "--out", str(jout)])
    jtext = capsys.readouterr().out
    rows_j = np.loadtxt(jout / "line_matches.txt", ndmin=2).astype(int)
    rows_p = np.loadtxt(port_out / "line_matches.txt", ndmin=2).astype(int)
    assert len(rows_p) >= 8
    np.testing.assert_array_equal(rows_p, got["rows"])
    np.testing.assert_array_equal(rows_j, rows_p)
    assert filecmp.cmp(jout / "line_matches.jpg", port_out / "line_matches.jpg", shallow=False)
    assert ptext.strip() == f"{len(rows_p)} matches -> {port_out}/line_matches.jpg|txt"
    assert jtext.split(" ")[0] == ptext.split(" ")[0]


def test_line_commands_need_the_card_unless_told(pair, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card here")
    from cube_slam_wu_tpu_torch import cli as tcli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["detect-lines", "--image", pair[0], "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["match-lines", "--image-a", pair[0], "--image-b", pair[1],
                   "--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        tcli.main(["detect-lines", "--image", str(tmp_path / "none.png"), "--device", "cpu"])


def test_viz_and_metric_helpers_equal_jax():
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, size=(60, 80, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, size=(50, 70), dtype=np.uint8)
    la = rng.uniform(-5, 85, size=(20, 4))
    lb = la + rng.normal(0, 1.0, size=la.shape)
    np.testing.assert_array_equal(tviz.draw_lines_overlay(rgb, la), jviz.draw_lines_overlay(rgb, la))
    idx = rng.integers(0, 20, size=20)
    matched = rng.random(20) < 0.7
    for img_b in (rgb, gray):
        np.testing.assert_array_equal(
            tviz.draw_line_matches(rgb, la, img_b, lb, idx, matched, max_draw=9),
            jviz.draw_line_matches(rgb, la, img_b, lb, idx, matched, max_draw=9),
        )
    t = tmetrics.line_endpoint_stability(la, lb[::-1])
    j = jmetrics.line_endpoint_stability(la, lb[::-1])
    assert t == j and t[1] > 10
    assert tmetrics.line_endpoint_stability(la[:0], lb) == (float("inf"), 0)
