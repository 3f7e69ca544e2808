"""Port parity: the TUM two-phase driver of slam/pipeline.py against the JAX
package's, both reading the same folder (tests/tum_parity.py: 8 frames at
240x320, three objects, seed 1, tilted poses).

`run_online_slam` in float64: the defaults (one object slot, the full
graph), a fixed-lag window with point tracks, the yaw prior, and a front end
resumed from the JAX package's checkpoint (the offline driver, the joint
point polish and `cli offline`: test_torch_pipeline_tum_offline.py;
`cli detect-cuboid`: test_torch_proposal_options.py).  Trajectory within
1e-5 m (the line detector runs in float32 in both packages, as in PR 3's
float64 parity tests), landmarks and their history within 1e-4 m, per-frame
chi2 within 1e-4 relative, validity and every front-end counter exactly
(kitti_parity.assert_outputs_agree).

`cli online` (the two-phase driver) through both packages' `cli.main`, the
port's with --float64 --device cpu: output_cam_poses.txt,
output_obj_poses.txt and trajectory_top_view.png byte-equal.  The JAX
command writes from the JAX driver's default run of the module fixture
(`jax_driver_memo`), the port's command runs its driver.  The port's
`write_tum_sequence` writes folders byte-equal to the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (  # one intra-op thread
    TUM_FILES, assert_same_files, cached_pair, jax_driver_memo, run_cli_both, to_j, to_t,
)
import jax_runs
from kitti_parity import assert_outputs_agree
from tum_parity import N_FRAMES, write_world

from cube_slam_wu_tpu.slam import pipeline as jpipe
from cube_slam_wu_tpu_torch.slam import pipeline as tpipe


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return write_world(tmp_path_factory.mktemp("tum") / "data")


@pytest.fixture(scope="module")
def folder(world):
    return world[0]


@pytest.fixture(scope="module")
def jax_run(folder):
    """The JAX package's default run over the folder, with its front end
    saved as a completed checkpoint (a front-end cache for the back-end
    variants): the run and the checkpoint's bytes are committed."""
    ck = folder.parent / "jax_front.npz"

    def make():
        out = jpipe.run_online_slam(folder, dtype=jnp.float64, checkpoint_path=ck)
        return out, np.frombuffer(ck.read_bytes(), np.uint8)

    out, ck_bytes = jax_runs.run("tum_default_f64", make)
    ck.write_bytes(ck_bytes.tobytes())
    return out, ck


def test_run_online_slam_matches_jax_f64(folder, jax_run):
    """The defaults (one object slot, the full graph), both packages' front
    ends and back ends in full."""
    p = tpipe.run_online_slam(folder, dtype=torch.float64, device="cpu")
    assert_outputs_agree(jax_run[0], p, traj_tol=1e-5, chi2_rtol=1e-4)
    assert p.traj_Twc_xyzq.shape == (N_FRAMES, 7) and p.cube_valid.all()
    assert p.frontend_report.n_frames == N_FRAMES


def test_window_and_point_weight_match_jax_f64(folder, jax_run, tmp_path):
    """A fixed-lag window of 4 with Harris + ZNCC point tracks (32 corners)
    in the windowed BA."""
    j, p = cached_pair(folder, jax_run[1], tmp_path, "tum_window_points_f64",
                       window=4, point_weight=0.3, n_points=32)
    assert_outputs_agree(j, p, traj_tol=1e-5, chi2_rtol=1e-4)
    assert np.abs(p.traj_Twc_xyzq - jax_run[0].traj_Twc_xyzq).max() > 1e-6


def test_yaw_prior_matches_jax_f64(folder):
    """`use_yaw_prior` (one object, one detection): each frame's proposals
    take the track's last yaw as a prior; both front ends in full."""
    j = jax_runs.run("tum_yaw_prior_f64",
                     lambda: jpipe.run_online_slam(folder, dtype=jnp.float64, use_yaw_prior=True))
    p = tpipe.run_online_slam(folder, dtype=torch.float64, device="cpu", use_yaw_prior=True)
    assert_outputs_agree(j, p, traj_tol=1e-5, chi2_rtol=1e-4)
    assert p.cube_valid.all()


def test_resume_from_the_jax_checkpoint(folder, jax_run, tmp_path):
    """The JAX package's front end stops after 4 frames with its checkpoint
    written; the port resumes it over all 8 and ends where JAX's
    uninterrupted run does."""
    from cube_slam_wu_tpu.core.se3 import SE3 as JSE3

    ck = tmp_path / "front.npz"
    truth = np.loadtxt(folder / "truth_cam_poses.txt")
    specs = [(folder / "raw_imgs" / f"{i:04d}_rgb_raw.jpg",
              folder / "filter_2d_obj_txts" / f"{i:04d}_yolo2_0.15.txt") for i in range(4)]
    jpipe.run_online_frontend(specs, tpipe.TUM_K, JSE3.from_xyzq(jnp.asarray(truth[0, 1:8])),
                              jnp.float64, checkpoint_path=ck, checkpoint_every=2)
    p = tpipe.run_online_slam(folder, dtype=torch.float64, device="cpu", checkpoint_path=ck,
                              checkpoint_every=2)
    assert_outputs_agree(jax_run[0], p, traj_tol=1e-5, chi2_rtol=1e-4)


def test_cli_online_two_phase_writes_what_jax_writes(folder, jax_run, tmp_path, capsys,
                                                    monkeypatch):
    jax_driver_memo(monkeypatch, "run_online_slam", jax_run[0], folder)
    (j, _), (p, ptext) = run_cli_both(tmp_path, capsys, ["online", "--base", str(folder)])
    assert_same_files(j, p, TUM_FILES)
    assert np.loadtxt(p / "output_obj_poses.txt").shape == (N_FRAMES, 9)
    assert "two-phase:" in ptext and "host reads/frame" in ptext


def test_write_tum_sequence_is_byte_equal_to_jax(world, tmp_path):
    """The port's TUM writer against the JAX package's (x64 on, where it
    converts the poses in float64 too): every file byte-equal."""
    from cube_slam_wu_tpu.utils import synth as jsynth
    from cube_slam_wu_tpu_torch.utils import synth as tsynth

    _, seq = world
    short = seq._replace(T_wc=seq.T_wc[:3], images=seq.images[:3], detections=seq.detections[:3])
    a = jsynth.write_tum_sequence(jsynth.SynthSequence(*short), tmp_path / "jax")
    b = tsynth.write_tum_sequence(short, tmp_path / "port")
    names = ["truth_cam_poses.txt"] + [f"raw_imgs/{i:04d}_rgb_raw.jpg" for i in range(3)] + [
        f"filter_2d_obj_txts/{i:04d}_yolo2_0.15.txt" for i in range(3)]
    assert_same_files(a, b, names)


def test_point_weight_needs_a_window(folder):
    with pytest.raises(ValueError, match="fixed-lag window"):
        tpipe.run_online_slam(folder, device="cpu", point_weight=0.3)


def test_tum_entry_points_need_the_card_unless_told(folder):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the card here")
    for fn in (tpipe.run_online_slam, tpipe.run_offline_slam):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(folder)


def test_zncc_ties_on_flat_shaded_edges(tmp_path, monkeypatch):
    """ROADMAP queue 3 entry 9: on chip_smoke.py's flat-shaded TUM world
    (480x640, seed 0, through its JPEGs) the ZNCC tracker of frame 3 -> 4
    meets straight edges where the correlation is a plateau.  Fed the same
    corners, the two packages may pick different displacements (three tracks
    here, tens of pixels apart).  Each such pick is a tie: read from both packages' full score
    surfaces, each package's score at the other's pick lies within 1e-5 of
    its own best, and no further below it than the two packages' scores of
    one and the same candidate differ (float32 rounding of the box-sum
    form).  Every track with the same pick agrees to 1e-3 px.  This flips the two-phase
    driver's point tracks, and with them its trajectory, between the
    packages on that world; the parity world above has no such tie."""
    import types

    import jax

    from cube_slam_wu_tpu.slam import features as jfeat
    from cube_slam_wu_tpu_torch.slam import features as tfeat
    from cube_slam_wu_tpu_torch.utils import io as tio
    from cube_slam_wu_tpu_torch.utils import synth as tsynth

    seq = tsynth.make_sequence(n_frames=30, size=(480, 640), n_objects=3, seed=0)
    seq = seq._replace(T_wc=seq.T_wc[:5], images=seq.images[:5], detections=seq.detections[:5])
    folder = tsynth.write_tum_sequence(seq, tmp_path / "tum")  # the JPEGs the driver reads
    grays = [tio.load_image_gray(folder / "raw_imgs" / f"{i:04d}_rgb_raw.jpg").astype(np.float32)
             for i in range(5)]
    uv, mask = jfeat.build_point_tracks([to_j(g) for g in grays[:4]], max_corners=128)
    args = (grays[3], grays[4], np.asarray(uv)[3], np.asarray(mask)[3])
    alive = args[3]
    jn, jt, jz = jax.device_get(jfeat.track_corners(*(to_j(a) for a in args)))

    # each package's (K, D) score surface, as its argmax sees it
    seen = {}
    jnp_seen = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if k[0] != "_"})
    jnp_seen.argmax = lambda z, axis: seen.setdefault("j", z).argmax(axis=axis)
    monkeypatch.setattr(jfeat, "jnp", jnp_seen)
    track_j = jax.jit(lambda *a: (jfeat.track_corners.__wrapped__(*a), seen["j"]))
    (jn2, _, _), zj = jax.device_get(track_j(*(to_j(a) for a in args)))
    np.testing.assert_array_equal(jn2, jn)  # the surface is the one the tracker saw
    first_argmax = tfeat.first_argmax
    monkeypatch.setattr(tfeat, "first_argmax",
                        lambda z, dim: first_argmax(seen.setdefault("t", z.clone()), dim=dim))
    tn, tt, _ = (a.numpy() for a in tfeat.track_corners(*(to_t(a) for a in args)))
    zt = seen["t"].numpy()

    assert np.array_equal(jt, tt)
    for k in np.nonzero(alive)[0]:
        pj, pt = zj[k].argmax(), zt[k].argmax()
        if pj == pt:
            np.testing.assert_allclose(jn[k], tn[k], atol=1e-3)
            continue
        rounding = max(abs(zj[k, pj] - zt[k, pj]), abs(zj[k, pt] - zt[k, pt]))
        gap_j, gap_t = zj[k, pj] - zj[k, pt], zt[k, pt] - zt[k, pj]
        assert 0.0 <= gap_j <= min(rounding, 1e-5), (k, gap_j, rounding)
        assert 0.0 <= gap_t <= min(rounding, 1e-5), (k, gap_t, rounding)
