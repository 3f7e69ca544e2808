"""Port parity: the slice as a whole — the fused online step over a short
synthetic sequence, through the JAX package and through the port on the CPU.

Two drives of the same 6 frames (240x320, three cuboids, 0.5 px box noise):

- in memory with the sequence's own intrinsics and first pose (a
  geometrically consistent scene: three landmarks spawn and are measured in
  every frame).  JAX runs its public `make_online_step` in the loop of its
  `run_online_slam_fused`;
- from a folder in the reference's TUM layout through both packages'
  `run_online_slam_fused`.  That entry point of the JAX package hard-codes
  the TUM intrinsics (principal point below a 240-row frame), so the lifted
  cuboids are far off and only their relative agreement is meaningful there.

The poses handed to both packages are the rendering camera's tilted by a few
tenths of a degree.  With an exactly level camera the vertical vanishing
point lies at infinity for the zero roll/pitch sample, every vertical line
then subtends the same angle up to an ulp of atan2, and the choice of the
supporting edge (an argmax over those angles) follows the last bit of each
framework's atan2: a coin toss neither implementation owns (recorded in
ROADMAP.md).  A real camera is never exactly level.

The fixed-lag path is driven the same way in test_torch_online_window.py.

Tolerances (float32 production dtype): identical `cube_valid` and integer
report counters; trajectory 1e-3 m and 1e-3 on the quaternion; cuboids 5e-3
(relative, where the TUM intrinsics blow the values up).
"""

import numpy as np
import pytest
import torch

import jax_runs
from torch_parity import jax_run_online_frames, to_np

import jax.numpy as jnp

from cube_slam_wu_tpu.slam import online as jonline
from cube_slam_wu_tpu.utils import synth as jsynth
from cube_slam_wu_tpu_torch.ops.detect import DetectConfig
from cube_slam_wu_tpu_torch.slam import online as tonline
from cube_slam_wu_tpu_torch.slam.convert import state_from_numpy
from cube_slam_wu_tpu_torch.utils import io as tuio
from cube_slam_wu_tpu_torch.utils import synth as tsynth

N, O = 6, 3
COUNTERS = ("n_measurements", "dropped", "no_valid_proposal", "cap_fallbacks")


def _objects(mod):
    return [
        mod.SynthObject(np.array([-1.3, 4.5, 0.45]), 1.9, np.array([0.7, 0.45, 0.45])),
        mod.SynthObject(np.array([1.4, 5.5, 0.5]), 0.3, np.array([0.8, 0.5, 0.5])),
        mod.SynthObject(np.array([-0.2, 8.0, 0.6]), 0.25, np.array([0.9, 0.55, 0.6])),
    ]


def _tilt(T, roll_deg=0.4, pitch_deg=0.7):
    r, p = np.radians(roll_deg), np.radians(pitch_deg)
    Rx = np.array([[1, 0, 0], [0, np.cos(p), -np.sin(p)], [0, np.sin(p), np.cos(p)]])
    Rz = np.array([[np.cos(r), -np.sin(r), 0], [np.sin(r), np.cos(r), 0], [0, 0, 1]])
    out = np.array(T, dtype=np.float64)
    out[..., :3, :3] = out[..., :3, :3] @ Rx @ Rz
    return out


@pytest.fixture(scope="module")
def seq():
    kw = dict(n_frames=N, size=(240, 320), noise_px=0.5, speed=0.3)
    s = tsynth.make_sequence(objects=_objects(tsynth), **kw)
    s = s._replace(T_wc=_tilt(s.T_wc))
    j = jsynth.make_sequence(objects=_objects(jsynth), **kw)
    j = j._replace(T_wc=_tilt(j.T_wc))
    for a, b in zip(s.images, j.images):  # the port's generator == JAX's
        np.testing.assert_array_equal(a, b)
    for a, b in zip(s.detections, j.detections):
        np.testing.assert_array_equal(a, b)
    assert all(len(d) == O for d in s.detections)
    return s


@pytest.fixture(scope="module")
def jax_mem(seq):
    return jax_runs.run("online_mem", lambda: jax_run_online_frames(
        seq, N, O, O, dtype=jnp.float32, return_state_at={3}))


def _port_mem(seq, n=N, **kw):
    return tonline.run_online_frames(
        tonline.sequence_frames(seq.images, seq.detections, O), seq.K, seq.T_wc[0], n,
        dtype=torch.float32, max_objects=O, max_detections=O, device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def port_mem(seq):
    return _port_mem(seq)


@pytest.fixture(scope="module")
def port_mem2(seq):
    """The port's default run over the first two frames."""
    return _port_mem(seq, n=2)


def _assert_runs_agree(traj_j, cubes_j, valid_j, report_j, res, cube_tol_rel=False):
    np.testing.assert_array_equal(valid_j, res.cube_valid)
    for k in COUNTERS:
        assert report_j[k] == res.report[k], k
    np.testing.assert_allclose(traj_j[:, :3], res.traj_Twc_xyzq[:, :3], atol=1e-3, rtol=0)
    qa, qb = traj_j[:, 3:], res.traj_Twc_xyzq[:, 3:]
    sign = np.sign(np.sum(qa * qb, axis=-1, keepdims=True))
    np.testing.assert_allclose(qa * sign, qb, atol=1e-3, rtol=0)
    v = valid_j
    if cube_tol_rel:
        np.testing.assert_allclose(cubes_j[v], res.cubes_minimal[v], rtol=5e-3, atol=5e-3)
    else:
        np.testing.assert_allclose(cubes_j[v], res.cubes_minimal[v], atol=5e-3, rtol=0)


def test_whole_slice_in_memory_matches_jax(seq, jax_mem, port_mem):
    assert port_mem.cube_valid.all(), "all three landmarks must spawn"
    assert port_mem.report["n_measurements"] == N * O
    _assert_runs_agree(
        jax_mem["traj"], jax_mem["cubes"], jax_mem["cube_valid"], jax_mem["report"], port_mem
    )
    np.testing.assert_allclose(jax_mem["chi2"], port_mem.chi2, rtol=2e-2, atol=1e-3)
    assert np.isfinite(port_mem.traj_Twc_xyzq).all()


def test_state_handed_over_from_jax_after_4_frames(seq, jax_mem):
    """JAX runs frames 0-3, its state crosses as numpy, the port runs frames
    4 and 5: same end state as JAX running all six."""
    state = state_from_numpy(jax_mem["states"][3], "cpu", torch.float32)
    assert isinstance(state, tonline.OnlineState)
    step = tonline.make_online_step(
        seq.K, seq.T_wc[0], N, torch.float32, max_objects=O, max_detections=O,
        sample_cam_roll_pitch=True, device="cpu",
    )
    frames = list(tonline.sequence_frames(seq.images, seq.detections, O))
    for i in (4, 5):
        gray, boxes, dmask = frames[i]
        state, (pose, rep) = step(
            state, torch.from_numpy(gray), torch.from_numpy(boxes).float(),
            torch.from_numpy(dmask), i,
        )
    traj = to_np(state.graph.cam_Twc().to_xyzq())
    np.testing.assert_allclose(jax_mem["traj"][:, :3], traj[:, :3], atol=1e-3)
    np.testing.assert_allclose(jax_mem["cubes"], to_np(state.graph.cube.to_minimal()), atol=5e-3)
    np.testing.assert_array_equal(jax_mem["cube_valid"], to_np(state.graph.cube_valid))
    # pose output layout: [x y z qw qx qy qz] of frame 5
    np.testing.assert_allclose(to_np(pose)[:3], traj[5, :3], atol=1e-6)
    assert int(rep.n_matched) == O


def test_robust_delta_reaches_the_bundle_adjuster(seq):
    """`robust_delta` of the online step (parity of the kernel itself:
    test_torch_ba_options.py and test_torch_tracker.py)."""
    a = _port_mem(seq, n=3, robust_delta=0.05)
    b = _port_mem(seq, n=3)
    assert np.isfinite(a.traj_Twc_xyzq).all() and a.cube_valid.all()
    assert np.abs(a.traj_Twc_xyzq - b.traj_Twc_xyzq).max() > 1e-7


@pytest.fixture(scope="module")
def folder(seq, tmp_path_factory):
    jseq = jsynth.SynthSequence(*seq)
    return jsynth.write_tum_sequence(jseq, tmp_path_factory.mktemp("tum"))


def test_folder_reader_matches_jax_folder_reader(folder):
    """Both packages' folder readers on the same files, in float64: with the
    hard-coded TUM intrinsics the lifted cuboids lie kilometres away, where a
    float32 bundle adjustment is ill-conditioned (the two packages then drift
    ~2e-3 m apart within four frames); the discrete stages are float32-pinned
    in both either way."""
    n = 4
    jres = jax_runs.run("online_folder_f64", lambda: jonline.run_online_slam_fused(
        str(folder), n_frames=n, dtype=jnp.float64, max_objects=O, max_detections=O
    ))
    tres = tonline.run_online_slam_fused(
        str(folder), n_frames=n, dtype=torch.float64, max_objects=O, max_detections=O,
        device="cpu",
    )
    assert tres.traj_Twc_xyzq.shape == (n, 7)
    _assert_runs_agree(
        to_np(jres.traj_Twc_xyzq), to_np(jres.cubes_minimal), to_np(jres.cube_valid),
        jres.report, tres, cube_tol_rel=True,
    )


def test_in_memory_loop_equals_folder_reader(folder):
    """The port's folder reader is a thin reader on the in-memory loop: the
    decoded files fed in memory give the same bits."""
    n = 3
    truth = tuio.read_number_txt(folder / "truth_cam_poses.txt")
    from cube_slam_wu_tpu_torch.core.se3 import SE3

    T0 = SE3.from_xyzq(torch.as_tensor(truth[0, 1:8]).float()).matrix().double().numpy()

    def frames():
        for i in range(n):
            gray = tuio.load_image_gray(folder / "raw_imgs" / f"{i:04d}_rgb_raw.jpg")
            boxes, _, dmask = tuio.read_detections_txt(
                folder / "filter_2d_obj_txts" / f"{i:04d}_yolo2_0.15.txt", n_max=O
            )
            yield gray.astype(np.uint8), boxes, dmask

    a = tonline.run_online_frames(
        frames(), tonline.TUM_K, T0, n, max_objects=O, max_detections=O, device="cpu"
    )
    b = tonline.run_online_slam_fused(
        str(folder), n_frames=n, max_objects=O, max_detections=O, device="cpu"
    )
    np.testing.assert_array_equal(a.traj_Twc_xyzq, b.traj_Twc_xyzq)
    np.testing.assert_array_equal(a.cubes_minimal, b.cubes_minimal)
    assert a.report == b.report
    # the accounting counts every blocking read: at least the per-frame pull
    # and the overflow flag, plus the final pull
    assert b.syncs_per_frame >= 2.0 + 1.0 / n
    assert b.bytes_up_per_frame >= 240 * 320
    assert b.bytes_down_per_frame > 0


def test_missing_frame_takes_first_frames_shape(folder, tmp_path):
    import shutil

    dst = tmp_path / "tum_gap"
    shutil.copytree(folder, dst)
    (dst / "raw_imgs" / "0001_rgb_raw.jpg").unlink()
    (dst / "filter_2d_obj_txts" / "0001_yolo2_0.15.txt").unlink()
    res = tonline.run_online_slam_fused(
        str(dst), n_frames=3, max_objects=O, max_detections=O, device="cpu"
    )
    assert res.traj_Twc_xyzq.shape == (3, 7) and np.isfinite(res.traj_Twc_xyzq).all()


def test_caps_off_fallback_is_taken_and_exact(seq):
    """Binding caps: the step reads the overflow flag and recomputes with the
    caps off, so the result equals a run that never had caps."""
    tiny = dict(dist_gather_cap=200, dist_gather_cap2=60, merge_cap=4)
    none = dict(dist_gather_cap=0, dist_gather_cap2=0, merge_cap=0)
    a = _port_mem(seq, n=3, proposal_overrides=tiny)
    b = _port_mem(seq, n=3, proposal_overrides=none)
    assert a.report["cap_fallbacks"] >= 2 and a.report["cap_overflow"] > 0
    assert b.report["cap_fallbacks"] == 0
    np.testing.assert_array_equal(a.traj_Twc_xyzq, b.traj_Twc_xyzq)
    np.testing.assert_array_equal(a.cubes_minimal, b.cubes_minimal)
    c = _port_mem(seq, n=3, proposal_overrides=tiny, exact_fallback=False)
    assert c.report["cap_fallbacks"] == 0 and c.report["cap_overflow"] > 0


def test_device_none_without_gpu_raises(seq):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the card here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tonline.make_online_step(seq.K, seq.T_wc[0], N)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tonline.run_online_frames(iter(()), seq.K, seq.T_wc[0], 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tonline.run_online_slam_fused("/nonexistent")
    from cube_slam_wu_tpu_torch import cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["online", "--base", ".", "--out", "unused"])


@pytest.mark.parametrize(
    "kw",
    [
        dict(detect_cfg=DetectConfig(short_recovery=True)),
        dict(detect_cfg=DetectConfig(nfa_validation=True)),
        dict(proposal_overrides=dict(max_cuboid_num=2)),
    ],
    ids=lambda kw: "-".join(f"{k}" for k in kw) + "-" + str(list(kw.values())[0])[:28],
)
def test_unported_online_options_raise(seq, kw, monkeypatch):
    """The detector options, refused before they were ported, now run in the
    step: its line set on frame 0 is what the option's detector gives on
    that frame (the two-pass `detect_line_segments_recover` for
    short_recovery, as JAX online.py:216-225; the NFA-gated
    `detect_line_segments` for nfa_validation), and the frame's proposals
    spawn every landmark.  A ranked ObjectSet (max_cuboid_num > 1) is still
    refused by the step, which takes one proposal per box (in the JAX
    package it fails on the shapes)."""
    if "proposal_overrides" in kw:
        with pytest.raises(ValueError):
            tonline.make_online_step(seq.K, seq.T_wc[0], N, device="cpu", **kw)
        return
    from cube_slam_wu_tpu_torch.ops import detect as tdet

    cfg = kw["detect_cfg"]
    name = "detect_line_segments_recover" if cfg.short_recovery else "detect_line_segments"
    real, seen = getattr(tdet, name), []

    def spy(gray, c, *a, **k):
        out = real(gray, c, *a, **k)
        seen.append((c, out))
        return out

    monkeypatch.setattr(tdet, name, spy)
    res = _port_mem(seq, n=1, **kw)
    assert len(seen) == 1 and seen[0][0] == cfg
    lines, mask = real(torch.as_tensor(seq.images[0]).to(torch.float32), cfg)
    assert torch.equal(seen[0][1][0], lines) and torch.equal(seen[0][1][1], mask)
    assert lines.shape[0] == (768 if cfg.short_recovery else 384)
    assert res.cube_valid.all() and np.isfinite(res.traj_Twc_xyzq).all()


@pytest.mark.parametrize("over", [dict(sample_bbox_height=True), dict(average_top_k=3)],
                         ids=["sample_bbox_height", "average_top_k"])
def test_online_step_takes_the_proposal_options(seq, port_mem2, over):
    """Height sampling and top-k averaging change the proposals the step
    measures (their parity: tests/test_torch_proposal_options.py)."""
    a = _port_mem(seq, n=2, proposal_overrides=over)
    b = port_mem2
    assert np.isfinite(a.traj_Twc_xyzq).all() and a.cube_valid.all()
    assert not np.array_equal(a.cubes_minimal, b.cubes_minimal)


def test_cli_online_on_cpu(folder, tmp_path, capsys):
    from cube_slam_wu_tpu_torch import cli

    out = tmp_path / "out"
    cli.main([
        "online", "--fused", "--base", str(folder), "--out", str(out), "--frames", "2",
        "--max-objects", "3", "--max-detections", "3", "--device", "cpu",
    ])
    text = capsys.readouterr().out
    assert "ATE RMSE vs truth" in text and "host reads/frame" in text
    traj = tuio.read_number_txt(out / "output_cam_poses.txt")
    assert traj.shape == (2, 8)
    # the fixed-lag path through the command line: 4 frames, window 2
    out_w = tmp_path / "out_w"
    cli.main([
        "online", "--fused", "--base", str(folder), "--out", str(out_w), "--frames", "4",
        "--window", "2", "--max-objects", "3", "--max-detections", "3", "--device", "cpu",
    ])
    assert "ATE RMSE vs truth" in capsys.readouterr().out
    traj_w = tuio.read_number_txt(out_w / "output_cam_poses.txt")
    assert traj_w.shape == (4, 8) and np.isfinite(traj_w).all()
    ref = tonline.run_online_slam_fused(
        str(folder), n_frames=4, max_objects=3, max_detections=3, window=2, device="cpu"
    )
    assert ref.prior_valid is not None and ref.prior_valid.any()
    np.testing.assert_allclose(traj_w[:, 1:4], ref.traj_Twc_xyzq[:, :3], atol=1e-5)
