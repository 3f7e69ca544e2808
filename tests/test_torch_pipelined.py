"""Port parity: parallel/pipelined.py.  The two-stage front end (line
detection | cuboid proposals, one thread each) must give EXACTLY the
sequential per-frame results (same ops, only the schedule changes), and agree
with the JAX package's `make_pipelined_frontend` on a 2-device virtual mesh.

Stream: JAX's test_pipelined_frontend.py world (5 frames at 192x256, one
fully visible cuboid, detector n_peaks=96, runs_per_peak=4) with per-frame
poses, the sequence's own, tilted by tum_parity.TILT_DEG (ROADMAP queue 3
entry 2).  Against JAX in float32: `valid` equal, pos/scale/rotY within 1e-4
(test_torch_proposal.py's float32 TOL).
"""

import threading

import numpy as np
import pytest
import torch

from torch_parity import to_np
from tum_parity import tilt

from cube_slam_wu_tpu.ops.detect import DetectConfig as JDetectConfig
from cube_slam_wu_tpu.parallel.pipelined import make_pipelined_frontend as jmake
from cube_slam_wu_tpu.parallel.sharded_ba import make_mesh
from cube_slam_wu_tpu_torch.ops.detect import DetectConfig
from cube_slam_wu_tpu_torch.parallel import pipelined
from cube_slam_wu_tpu_torch.utils import synth

DET = dict(n_peaks=96, runs_per_peak=4)
TOL_F32 = 1e-4


@pytest.fixture(scope="module")
def stream():
    obj = synth.SynthObject(np.array([0.3, 3.8, 0.42]), 0.45, np.array([0.55, 0.4, 0.42]))
    seq = synth.make_sequence(n_frames=5, size=(192, 256), speed=0.15, noise_px=0.0, objects=[obj])
    grays = np.stack(seq.images).astype(np.float32)
    bboxes = np.stack([[d[0, 0] - 1.0, d[0, 1] - 1.0, d[0, 2], d[0, 3]]
                       for d in seq.detections]).astype(np.float32)
    T_wcs = tilt(seq.T_wc).astype(np.float32)
    assert not np.allclose(T_wcs[0], T_wcs[-1])  # poses actually vary
    return seq, grays, bboxes, T_wcs


def _port(stream, how):
    seq, grays, bboxes, T_wcs = stream
    if how == "pipelined":
        run = pipelined.make_pipelined_frontend(("cpu", "cpu"), seq.K, seq.T_wc[0],
                                                detect_cfg=DetectConfig(**DET))
    else:
        run = pipelined.make_sequential_frontend("cpu", seq.K, seq.T_wc[0],
                                                 detect_cfg=DetectConfig(**DET))
    return run(grays, bboxes, T_wcs)


@pytest.fixture(scope="module")
def port_pipelined(stream):
    return _port(stream, "pipelined")


@pytest.fixture(scope="module")
def jax_pipelined(stream):
    seq, grays, bboxes, T_wcs = stream
    run = jmake(make_mesh(2), seq.K, seq.T_wc[0], detect_cfg=JDetectConfig(**DET))
    return {k: to_np(v) for k, v in run(grays, bboxes, T_wcs)._asdict().items()}


def test_pipelined_equals_sequential(stream, port_pipelined):
    seq_res = _port(stream, "sequential")
    assert to_np(port_pipelined.valid).sum() >= 3, "need several valid frames"
    for f, a, b in zip(seq_res._fields, port_pipelined, seq_res):
        assert a.shape[0] == len(stream[1]), f
        assert torch.equal(a, b), f


def test_pipelined_matches_jax(port_pipelined, jax_pipelined):
    got = {k: to_np(v) for k, v in port_pipelined._asdict().items()}
    np.testing.assert_array_equal(got["valid"], jax_pipelined["valid"])
    ok = got["valid"]
    assert ok.sum() >= 3
    for f in ("pos", "scale", "rotY"):
        np.testing.assert_allclose(got[f][ok], jax_pipelined[f][ok], rtol=0, atol=TOL_F32, err_msg=f)


@pytest.mark.parametrize("devices", [("cpu",), ("cpu",) * 4, ("cpu", "cuda:0")],
                         ids=["one", "four", "mixed"])
def test_rejects_wrong_devices(stream, devices):
    seq = stream[0]
    with pytest.raises(ValueError, match="devices" if len(devices) != 2 else "two CPU or two CUDA"):
        pipelined.make_pipelined_frontend(devices, seq.K, seq.T_wc[0])


@pytest.mark.parametrize("stage", ["detect", "propose"])
def test_stage_failure_reaches_caller(stream, monkeypatch, stage):
    """A stage that raises stops the other one, and `run` raises its error
    instead of returning partial results; no stage thread is left behind."""
    seq, grays, bboxes, T_wcs = stream
    real = pipelined._Frontend.frame_detect if stage == "detect" else pipelined._Frontend.frame_propose

    def failing(self, ins, t, *rest):
        if t == 2:
            raise FloatingPointError(f"injected failure in {stage} at frame {t}")
        return real(self, ins, t, *rest)

    monkeypatch.setattr(pipelined._Frontend, f"frame_{stage}", failing)
    before = threading.active_count()
    run = pipelined.make_pipelined_frontend(("cpu", "cpu"), seq.K, seq.T_wc[0],
                                            detect_cfg=DetectConfig(**DET))
    with pytest.raises(FloatingPointError, match=f"injected failure in {stage}"):
        run(grays, bboxes, T_wcs)
    assert threading.active_count() == before


def test_host_read_counts_are_thread_safe():
    """The two stage threads count their host reads into the shared
    `utils.hostsync` books: with more threads than cores and a short switch
    interval, no count is lost and each thread's reads land under its own
    stage label (every thread is inside its stage before any reads)."""
    import sys

    from cube_slam_wu_tpu_torch.utils import hostsync

    n_threads, n_reads = 16, 400
    flag = torch.ones((), dtype=torch.bool)
    before = hostsync.snapshot()
    all_in = threading.Barrier(n_threads)

    def work(k):
        with hostsync.stage(f"stress/{k}"):
            all_in.wait(timeout=60)
            for _ in range(n_reads):
                hostsync.host_bool(flag)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    d = hostsync.delta(before, hostsync.snapshot())
    assert d["syncs"] == n_threads * n_reads
    for k in range(n_threads):
        assert d["by_stage"][f"stress/{k}"]["syncs"] == n_reads
        assert d["by_stage"][f"stress/{k}"]["entries"] == 1
