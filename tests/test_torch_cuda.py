"""Tests of the port that need a CUDA device (marker `cuda`; they skip
without one).  This file imports torch and the port only, so it also runs on
a machine without JAX:

    python3 -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from cube_slam_wu_tpu_torch.ops import cuda_kernels
from cube_slam_wu_tpu_torch.ops import image as timg


@pytest.mark.cuda
def test_edt_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card: bit-equal on
    inputs with edges, rtol 1e-6 on an all-empty input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    before = cuda_kernels.LAUNCHES["edt_row_min"]
    # the production shapes, a width that is no multiple of the kernel's tiles
    # (5 columns per thread, source chunks of 32), a single column, and the
    # widest allowed width
    shapes = ((3, 480, 640), (1, 375, 1242), (2, 97, 131), (1, 5, 1), (1, 40, cuda_kernels.MAX_WIDTH))
    for shape in shapes:
        edge = torch.from_numpy(rng.random(shape) < 0.01).to(dev)
        g2 = torch.clamp(timg._edt_1d_columns(edge), max=1e6) ** 2
        out = cuda_kernels.edt_row_min(g2)
        torch.cuda.synchronize()
        assert torch.equal(out, cuda_kernels.edt_row_min_plain(g2))
    g2 = torch.full((1, 64, 200), 1e12, device=dev)
    torch.testing.assert_close(
        cuda_kernels.edt_row_min(g2), cuda_kernels.edt_row_min_plain(g2),
        rtol=1e-6, atol=0,
    )
    assert cuda_kernels.LAUNCHES["edt_row_min"] == before + len(shapes) + 1
    # beyond the exactness limit K + W^2 + H^2 <= 2^24 the wrapper refuses
    with pytest.raises(ValueError, match="exact"):
        cuda_kernels.edt_row_min(torch.zeros((1, 3000, cuda_kernels.MAX_WIDTH), device=dev))
    with pytest.raises(ValueError, match="width"):
        cuda_kernels.edt_row_min(torch.zeros((1, 2, cuda_kernels.MAX_WIDTH + 1), device=dev))


@pytest.mark.cuda
def test_line_layer_on_card_matches_cpu():
    """The line layer on the card against the CPU: the codes and the four
    matchers bit-equal (integer arithmetic), the claim mask bit-equal in
    float64 on the same inputs, and each detector variant (plain, NFA, the
    two-pass recovery, two octaves) the same set of segments (counts within
    5 %, >= 95 % matched within 0.5 px: atan2 and the float32 sums may differ
    by an ulp between the devices)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's side of the comparison)")
    from tum_parity import segment_match_fraction

    from cube_slam_wu_tpu_torch.ops import detect as tdet
    from cube_slam_wu_tpu_torch.ops import lbd as tlbd
    from cube_slam_wu_tpu_torch.utils import synth

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    words = torch.from_numpy(rng.integers(0, 2**32, size=(40, 8), dtype=np.int64))
    masks = torch.from_numpy(rng.random(40) < 0.8)
    desc = torch.from_numpy(rng.normal(size=(40, 72)).astype(np.float32))
    assert torch.equal(tlbd.binarize_lbd(desc.to(dev)).cpu(), tlbd.binarize_lbd(desc))
    for name, kw in (("hamming_match", {}), ("match_lines_filtered", {}), ("radius_match", {}),
                     ("knn_match", dict(k=2))):
        f = getattr(tlbd, name)
        cpu = f(words[:25], words[10:], masks[:25], masks[10:], **kw)
        card = f(*(a.to(dev) for a in (words[:25], words[10:], masks[:25], masks[10:])), **kw)
        for a, b in zip(cpu, card):
            assert torch.equal(a, b.cpu()), name

    img = torch.from_numpy(
        synth.make_sequence(n_frames=1, n_objects=3, size=(480, 640), seed=0).images[0]
    ).to(torch.float32)
    lines, mask = tdet.detect_line_segments(img)
    psi = torch.rand(img.shape, dtype=torch.float64) * np.pi
    args = (img.shape, psi, lines.double(), mask, 1.5, 8.0)
    assert torch.equal(
        tdet._claimed_mask(*args).cpu(),
        tdet._claimed_mask(*(a.to(dev) if torch.is_tensor(a) else a for a in args)).cpu(),
    )
    variants = {
        "plain": lambda g: tdet.detect_line_segments(g),
        "nfa": lambda g: tdet.detect_line_segments(g, tdet.DetectConfig(nfa_validation=True)),
        "recover": lambda g: tdet.detect_line_segments_recover(
            g, tdet.DetectConfig(short_recovery=True)),
        "octaves": lambda g: tdet.detect_line_segments_octaves(g, n_octaves=2),
    }
    for name, run in variants.items():
        (la, ma), (lb, mb) = run(img), run(img.to(dev))
        a, b = la[ma].numpy(), lb[mb].cpu().numpy()
        assert len(a) >= 8 and abs(len(a) - len(b)) <= 0.05 * len(a), name
        assert min(segment_match_fraction(a, b), segment_match_fraction(b, a)) >= 0.95, name


@pytest.mark.cuda
def test_pose_graph_on_card_matches_cpu():
    """The Sim(3) loop-closure correction (tests/pose_graph_parity.py at the
    JAX test's 40 keyframes and 1.02 per step, float64) on the card against
    the CPU: poses, chi2 and lambda
    within 1e-8 over 10 LM iterations (past about 11 the accept/reject turns
    compare chi2 values that differ by rounding), and the emulated float64
    fused multiply-add of the detector's blur bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's side of the comparison)")
    from pose_graph_parity import loop_problem

    from cube_slam_wu_tpu_torch.core.se3 import SE3
    from cube_slam_wu_tpu_torch.core.sim3 import Sim3
    from cube_slam_wu_tpu_torch.ops import detect as tdet
    from cube_slam_wu_tpu_torch.slam import pose_graph as pg

    n = 40

    def solve(device):
        t = {k: torch.as_tensor(v, dtype=torch.float64, device=device)
             for k, v in loop_problem(n, 1.02).items()}
        one = torch.ones((), dtype=torch.float64, device=device)
        drifted = pg.chain_odometry(Sim3(t["drift_quat"], t["drift_trans"], one.expand(n - 1)),
                                    Sim3(t["start_quat"], t["start_trans"], one))
        res = pg.correct_scale_drift(SE3(drifted.quat, drifted.trans), drifted.scale, n - 1, 0,
                                     Sim3(t["loop_quat"], t["loop_trans"], t["loop_scale"]),
                                     iterations=10)
        return [x.cpu().numpy() for x in (*res.poses, res.chi2, res.lambda_final)]

    cpu, card = solve("cpu"), solve("cuda")
    for a, b in zip(cpu[:-1], card[:-1]):
        np.testing.assert_allclose(b, a, atol=1e-8, rtol=0)
    np.testing.assert_allclose(card[-1], cpu[-1], rtol=1e-8)

    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.normal(size=4096)) for _ in range(3))
    assert torch.equal(tdet.fma64(a, b, c), tdet.fma64(a.cuda(), b.cuda(), c.cuda()).cpu())
    img = torch.from_numpy(rng.integers(0, 256, size=(480, 640)).astype(np.float64))
    assert torch.equal(tdet.gaussian_blur5(img), tdet.gaussian_blur5(img.cuda()).cpu())


@pytest.mark.cuda
def test_sharded_ba_world_one_on_nccl():
    """The factor-sharded BA through a real NCCL group of world size 1 on the
    card is bit-equal to `slam/ba.py::optimize` there: poses, cubes, chi2 and
    lambda_final.  At world size 1 every row is owned and the all-reduce is a
    copy, so the sharded LM does the local LM's arithmetic; a drift in its
    accept rule or damping shows here.  (Ranks beyond one need a card each
    under NCCL; the multi-rank parity runs on the CPU with gloo,
    tests/test_torch_sharded_ba.py.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL runs on the card only)")
    import torch.distributed as dist

    from cube_slam_wu_tpu_torch.parallel import multihost, sharded_ba
    from cube_slam_wu_tpu_torch.slam import ba

    dev = torch.device("cuda", 0)
    multihost.initialize(f"tcp://127.0.0.1:{multihost._free_port()}", 1, 0, dev)
    try:
        group = multihost.global_group()
        assert dist.get_backend(group) == "nccl"
        graph = sharded_ba.replicate(multihost._build_ba_graph(16, torch.float64), group, dev)
        got = sharded_ba.make_sharded_optimize(group, iterations=3)(graph)
        ref = ba.optimize(graph, iterations=3)
        for name, a, b in (("quat", got.cam_Tcw.quat, ref.cam_Tcw.quat),
                           ("trans", got.cam_Tcw.trans, ref.cam_Tcw.trans),
                           ("cube", got.cube.to_minimal(), ref.cube.to_minimal()),
                           ("chi2", got.chi2, ref.chi2),
                           ("lambda_final", got.lambda_final, ref.lambda_final)):
            assert torch.equal(a, b), name
    finally:
        dist.destroy_process_group()


class _Checked:
    """A fresh capture (`utils.capture.Captured`) of `eager` that also runs
    `eager` on every call's inputs, keeps the largest deviation of the
    replay from it, and checks that the result of the call before is
    unchanged (no output of one replay aliases a buffer of the next).

    With `nan_equal` an element that is NaN in both results counts as equal,
    and `both_nan` counts, per leaf (`tree_flatten` order), the calls in
    which it held such an element; without it a NaN fails the check."""

    def __init__(self, captured, eager, nan_equal=False):
        self.captured = captured
        self.eager = eager
        self.nan_equal = nan_equal
        self.worst = 0.0
        self.calls = 0
        self.both_nan = {}
        self.last = None  # (the result handed back, a copy of it)

    @property
    def captures(self):
        return self.captured.captures

    @property
    def replays(self):
        return self.captured.replays

    @staticmethod
    def _leaves(result):
        from cube_slam_wu_tpu_torch.utils.tree import tree_flatten

        return tree_flatten(result)[0]

    def __call__(self, *args, **kw):
        from cube_slam_wu_tpu_torch.utils.tree import tree_map

        got = self.captured(*args, **kw)
        ref = self.eager(*args, **kw)
        if self.last is not None:
            for a, b in zip(*map(self._leaves, self.last)):
                assert torch.equal(a, b), "a replay overwrote the result of the call before"
        for k, (a, b) in enumerate(zip(self._leaves(got), self._leaves(ref))):
            a, b = a.double(), b.double()
            if self.nan_equal:
                both = torch.isnan(a) & torch.isnan(b)
                if bool(both.any()):
                    self.both_nan[k] = self.both_nan.get(k, 0) + 1
                a, b = torch.where(both, 0.0, a), torch.where(both, 0.0, b)
            scale = torch.clamp(torch.amax(torch.abs(b)), min=1e-30)
            dev = float(torch.amax(torch.abs(a - b)) / scale)
            self.worst = max(self.worst, dev)
            assert dev <= 1e-6, (self.calls, dev)
        self.last = (got, tree_map(torch.clone, got))
        self.calls += 1
        return got

    def report(self, what):
        print(f"largest deviation of the replay from eager {what}: {self.worst:.3e}; "
              f"leaves NaN in both (leaf: calls): {self.both_nan}")


def _two_kitti_sessions():
    """A 20-frame `run_kitti_frames` session at `kitti_points_w16`'s shapes
    (window 16, 8 objects, 96 points, float32, the prior from frame 16 on,
    the 2-px Huber), then a second one in the same process that ends after
    frame 2: 23 frames."""
    from tum_parity import tilt

    from cube_slam_wu_tpu_torch.slam import pipeline
    from cube_slam_wu_tpu_torch.utils import synth

    seq = synth.make_sequence(n_frames=20, n_objects=6, size=(240, 320), speed=0.5,
                              curve=0.002, noise_px=0.8, dropout=0.05, seed=4,
                              ground_texture=4.0)
    T_wc = tilt(seq.T_wc, 0.4, 0.7)
    frames = list(zip(seq.images, seq.detections))
    kw = dict(pose_feedback=True, point_weight=0.3, window=16, n_points=96, max_objects=8,
              max_detections=4, iterations=5, dtype=torch.float32, device="cuda")
    first = pipeline.run_kitti_frames(frames, seq.K, T_wc[0], **kw)
    assert np.all(np.isfinite(first.traj_Twc_xyzq))
    pipeline.run_kitti_frames(frames, seq.K, T_wc[0], on_result=lambda r: r.i == 2, **kw)


@pytest.mark.cuda
def test_point_lm_replay_matches_eager_on_card(monkeypatch):
    """The fixed-lag point LM replayed from its CUDA graph against eager
    `point_ba.optimize` on the same inputs, every frame of a 20-frame
    `run_kitti_frames` session at `kitti_points_w16`'s shapes (window 16,
    8 objects, 96 points, float32, the prior from frame 16 on, the 2-px
    Huber): within float32 rounding (rtol 1e-6 of each output's largest
    magnitude; bit-equal is expected); one capture across two sessions of
    one process; no result aliased by the next replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graph capture runs on the card only)")
    from cube_slam_wu_tpu_torch.slam import point_ba

    from cube_slam_wu_tpu_torch.utils.capture import Captured

    checked = _Checked(Captured(point_ba.optimize), point_ba.optimize)
    monkeypatch.setattr(point_ba, "captured_lm", checked)
    _two_kitti_sessions()
    checked.report("optimize")
    assert (checked.captures, checked.replays, checked.calls) == (1, 23, 23)


@pytest.mark.cuda
def test_absorb_replay_matches_eager_on_card(monkeypatch):
    """The prior's absorption replayed from its CUDA graph against eager
    `window.absorb_frame` on the same inputs, every frame of the same two
    sessions (an empty mask before frame 16, the departing frame's edges
    from then on): within float32 rounding (bit-equal is expected); one
    capture across both sessions; no result aliased by the next replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graph capture runs on the card only)")
    from cube_slam_wu_tpu_torch.slam import window
    from cube_slam_wu_tpu_torch.utils.capture import Captured

    checked = _Checked(Captured(window.absorb_frame), window.absorb_frame, nan_equal=True)
    monkeypatch.setattr(window, "captured_absorb", checked)
    _two_kitti_sessions()
    checked.report("absorb_frame")
    assert (checked.captures, checked.replays, checked.calls) == (1, 23, 23)

