#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, drives the fused online SLAM
step over a synthetic 480x640 sequence through the entry point a user would
call — once re-optimising the full graph every frame (`main_path`), once as
the fixed-lag smoother with a window of 16 frames (`windowed_path`) — checks
the results, and prints one JSON object per phase.  The last line is
`{"ok": true, "device": {...}}`.  Any failing phase ends the script with a
non-zero exit code; without a CUDA device it exits 1 and prints no result.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
    sys.exit(1)

from cube_slam_wu_tpu_torch.ops import cuda_kernels  # noqa: E402
from cube_slam_wu_tpu_torch.slam.online import run_online_frames, sequence_frames  # noqa: E402
from cube_slam_wu_tpu_torch.tools.cardtime import (  # noqa: E402
    g2_from_random, g2_from_rendered, nvidia_smi_line, time_ms,
)
from cube_slam_wu_tpu_torch.utils import synth  # noqa: E402
from cube_slam_wu_tpu_torch.utils.metrics import ate_rmse  # noqa: E402

DEV = torch.device("cuda")

# Published peaks of one H100 SXM (dense, no sparsity): fp32 outside the
# tensor cores and HBM bandwidth.  The bound is stated against these whatever
# the card's power limit, which is printed beside it.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Both paths: the sequence, the sizes and the quality bounds.
N_FRAMES, SIZE, N_OBJECTS, SEED = 30, (480, 640), 3, 0
CAPACITY = 64
WINDOW = 16
# ATE (direct RMSE against the sequence's own T_wc) of the JAX package on the
# CPU on this very sequence: 2.1056 m re-optimising the full graph
# (tests/reference_ate_jax.py: the estimate drifts up to 3.7 m mid-sequence on
# these far-away objects and recovers) and 1.9855 m with the fixed-lag step at
# window 16 (tests/reference_ate_jax_window.py 30 16: 90 measurements, 3/3
# slots, all three objects in the prior, last chi2 26.26).  The port must stay
# within 1.1x of the JAX figure on either path.
ATE_REFERENCE_M = 2.1056
ATE_WINDOW_REFERENCE_M = 1.9855
CPU_AGREE_M = 1e-3
# The two bit-equality runs of each path are cut short (the measured runs are
# not); the windowed ones still absorb departing frames (20 > WINDOW).
SECOND_RUN_FRAMES = {"main_path": 12, "windowed_path": 20}
# The card against the CPU on the windowed path, on drives short enough for
# the CPU that still absorb (window 4, capacity 12, 8 frames): in float32 on
# the first frames of the sequence itself, and in float64 at 240x320.  At
# 240x320 this scene's float32 bundle adjustment is too ill-conditioned for a
# 1e-3 m comparison: this script, when it compared float32 there, read
# 0.0028267 m between card and CPU (NVIDIA H100 80GB HBM3, 700.00 W), while
# the float64 drive below agrees to under 1e-7 m on the same frames: rounding,
# not a fault.  So the float32 comparison runs at the full size.
SMALL = dict(capacity=12, window=4, n_frames=8)
SMALL_F64_SIZE = (240, 320)
CPU_AGREE_F64_M = 1e-6

KERNEL_SHAPES = ((3, 480, 640), (1, 375, 1242), (2, 97, 131), (1, 40, cuda_kernels.MAX_WIDTH))
# Directory of the JAX package that holds the TPU kernels (named in the
# report only; nothing of it is imported).
TPU_PACKAGE_DIR = "cube_slam_wu_" "tpu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def edt_bound_ms(shape):
    """Least time for the row pass at (B, H, W): B*H*W^2 candidates of one
    fused multiply-add (2 operations) and one min against the fp32 peak, and
    input read once + output written once against the memory rate."""
    B, H, W = shape
    ops_ms = 3.0 * B * H * W * W / PEAK_FP32_FLOPS * 1e3
    bytes_ms = 2.0 * B * H * W * 4 / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_kernels():
    per_shape = []
    worst = 0.0
    for k, shape in enumerate(KERNEL_SHAPES):
        # rendered frames at the shapes a camera gives; the widest allowed row
        # from a random edge map
        make = g2_from_random if shape[2] == cuda_kernels.MAX_WIDTH else g2_from_rendered
        g2 = make(shape, seed=k)
        out = cuda_kernels.edt_row_min(g2)
        torch.cuda.synchronize()
        ref = cuda_kernels.edt_row_min_plain(g2)
        err = float((out - ref).abs().max())
        worst = max(worst, err)
        if not torch.equal(out, ref):
            raise RuntimeError(f"edt_row_min != plain at {shape}: max abs err {err}")
        ms = time_ms(lambda: cuda_kernels.edt_row_min(g2))
        plain_ms = time_ms(lambda: cuda_kernels.edt_row_min_plain(g2), launches=5, repeats=5)
        bound, by = edt_bound_ms(shape)
        per_shape.append(dict(shape=list(shape), ms=ms, plain_ms=plain_ms,
                              bound_ms=bound, bound_by=by, bit_equal=True))
    # no edge anywhere: values ~1e6, not exact integers
    empty = torch.full((1, 120, 200), 1e12, device=DEV)
    out = cuda_kernels.edt_row_min(empty)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, cuda_kernels.edt_row_min_plain(empty), rtol=1e-6, atol=0)
    return per_shape, worst


def run_path(seq, n, device, window=None, capacity=CAPACITY, on_frame=None, dtype=torch.float32):
    return run_online_frames(
        sequence_frames(seq.images, seq.detections, N_OBJECTS),
        seq.K, seq.T_wc[0], n, dtype=dtype,
        max_objects=N_OBJECTS, max_detections=N_OBJECTS, capacity=capacity,
        window=window, device=device, on_frame=on_frame,
    )


def phase_path(name, seq, window, ate_reference_m, t_start):
    """Drive one path over the sequence on the card through the entry point,
    with the launch counts set to 0 just before and read just after; check the
    result; return the phase's line and the kernels' launch counts."""
    truth = seq.T_wc[:, :3, 3]
    frames_with_det = sum(1 for d in seq.detections if len(d) > 0)

    short = run_path(seq, 4, None, window)  # device=None: the card; also warms up
    torch.cuda.synchronize()

    clock = {}

    def on_frame(i):
        if i == 2:  # three frames of warm-up
            torch.cuda.synchronize()
            clock["t0"] = time.perf_counter()

    cuda_kernels.reset_launch_counts()
    res = run_path(seq, N_FRAMES, None, window, on_frame=on_frame)
    torch.cuda.synchronize()
    ms_per_frame = (time.perf_counter() - clock["t0"]) * 1e3 / (N_FRAMES - 3)
    launches = dict(cuda_kernels.LAUNCHES)

    traj = res.traj_Twc_xyzq[:N_FRAMES]
    if not (np.isfinite(traj).all() and np.isfinite(res.cubes_minimal).all()):
        raise RuntimeError(f"{name}: trajectory or cuboids not finite")
    if traj.shape != (N_FRAMES, 7) or res.cubes_minimal.shape != (N_OBJECTS, 9):
        raise RuntimeError(f"{name}: unexpected output shapes")
    if not res.cube_valid.all():
        raise RuntimeError(f"{name}: not all slots spawned: {res.cube_valid}")
    if res.report["n_measurements"] <= 0:
        raise RuntimeError(f"{name}: no measurement accepted")
    if launches["edt_row_min"] < frames_with_det:
        raise RuntimeError(
            f"{name}: edt_row_min launched {launches['edt_row_min']} times "
            f"for {frames_with_det} frames with detections"
        )
    if window is None:
        if res.prior_valid is not None:
            raise RuntimeError(f"{name}: the full-graph path carries a prior")
    elif res.prior_valid is None or not res.prior_valid.all():
        raise RuntimeError(f"{name}: the prior has not absorbed every object: {res.prior_valid}")
    ate = ate_rmse(traj[:, :3], truth)
    ate_bound = 1.1 * ate_reference_m
    if not ate < ate_bound:
        raise RuntimeError(f"{name}: ATE {ate} m above the bound {ate_bound} m")

    # the same drive twice on the card must give the same bits (the Hough vote
    # and every selection are deterministic).  These reruns are cut short: they
    # are held against each other in every output, and against the measured
    # run in the per-frame chi2
    k = SECOND_RUN_FRAMES[name]
    again = [run_path(seq, k, "cuda", window) for _ in range(2)]
    for what in ("traj_Twc_xyzq", "cubes_minimal", "cube_valid", "chi2", "prior_valid"):
        a, b = (getattr(r, what) for r in again)
        if not ((a is None and b is None) or np.array_equal(a, b)):
            raise RuntimeError(f"{name}: two runs on the card differ in {what}")
    if again[0].report != again[1].report:
        raise RuntimeError(f"{name}: two runs on the card differ in their counters")
    if not np.array_equal(res.chi2[:k], again[0].chi2):
        diff = float(np.abs(res.chi2[:k] - again[0].chi2).max())
        raise RuntimeError(f"{name}: two runs on the card differ (chi2 by up to {diff})")

    # card against CPU (asked for by name: not a fallback)
    extra = {}
    if window is None:
        cpu = run_path(seq, 4, "cpu")
        cpu_diff = float(np.abs(cpu.traj_Twc_xyzq[:4, :3] - short.traj_Twc_xyzq[:4, :3]).max())
        cpu_what = "first 4 frames"
    else:
        n = SMALL["n_frames"]
        kw = dict(window=SMALL["window"], capacity=SMALL["capacity"])
        card = run_path(seq, n, "cuda", **kw)
        cpu = run_path(seq, n, "cpu", **kw)
        if not (card.prior_valid.any() and cpu.prior_valid.any()):
            raise RuntimeError(f"{name}: the short drive did not absorb")
        cpu_diff = float(np.abs(cpu.traj_Twc_xyzq[:n, :3] - card.traj_Twc_xyzq[:n, :3]).max())
        cpu_what = f"first {n} frames, capacity {SMALL['capacity']}, window {SMALL['window']}"
        small = synth.make_sequence(
            n_frames=n, size=SMALL_F64_SIZE, n_objects=N_OBJECTS, seed=SEED
        )
        card64 = run_path(small, n, "cuda", dtype=torch.float64, **kw)
        cpu64 = run_path(small, n, "cpu", dtype=torch.float64, **kw)
        extra["cpu_vs_card_float64_240x320_m"] = float(
            np.abs(cpu64.traj_Twc_xyzq[:n, :3] - card64.traj_Twc_xyzq[:n, :3]).max()
        )
        if not (card64.prior_valid.any() and cpu64.report == card64.report):
            raise RuntimeError(f"{name}: the float64 drive did not absorb or counts differ")
        if not extra["cpu_vs_card_float64_240x320_m"] < CPU_AGREE_F64_M:
            raise RuntimeError(f"{name}: card and CPU differ in float64: {extra}")
    if not cpu_diff < CPU_AGREE_M:
        raise RuntimeError(f"{name}: card and CPU differ by {cpu_diff} m over {cpu_what}")

    emit({"phase": name, "n_frames": N_FRAMES, "size": list(SIZE), "window": window,
          "ms_per_frame": ms_per_frame, "syncs_per_frame": res.syncs_per_frame,
          "bytes_up_per_frame": res.bytes_up_per_frame,
          "bytes_down_per_frame": res.bytes_down_per_frame,
          "ate_m": ate, "ate_bound_m": ate_bound, "ate_jax_cpu_m": ate_reference_m,
          "report": res.report, "cube_valid": res.cube_valid.tolist(),
          "prior_valid": None if res.prior_valid is None else res.prior_valid.tolist(),
          "chi2_last": float(res.chi2[-1]),
          "cpu_vs_card_m": cpu_diff, "cpu_vs_card_over": cpu_what, **extra,
          "second_run_frames": k, "second_run_bit_equal": True,
          "launches": launches, "frames_with_detections": frames_with_det,
          "seconds_total": time.perf_counter() - t_start})
    return launches


def main() -> int:
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "nvidia_smi": smi})

    # ---- build every kernel of the path (all nvcc processes side by side) --
    names = sorted(cuda_kernels.LAUNCHES)
    handles = [cuda_kernels.start_build(name) for name in names]
    for h in handles:
        cuda_kernels.finish_build(h)
    emit({"phase": "build", "kernels": {k: cuda_kernels.BUILD_LOG[k] for k in names}})

    # ---- each kernel against its plain version, on the card ----------------
    per_shape, worst_err = phase_kernels()
    emit({"phase": "kernels", "edt_row_min": per_shape, "empty_input_rtol": 1e-6})

    # ---- the two paths, each with the launch counts read around it ---------
    seq = synth.make_sequence(n_frames=N_FRAMES, size=SIZE, n_objects=N_OBJECTS, seed=SEED)
    launches_main = phase_path("main_path", seq, None, ATE_REFERENCE_M, t_start)
    launches_win = phase_path("windowed_path", seq, WINDOW, ATE_WINDOW_REFERENCE_M, t_start)

    main_shape = per_shape[0]
    emit({"kernels": [{
        "name": "edt_row_min", "route": "cuda",
        "source": "cube_slam_wu_tpu_torch/csrc/edt_row_min.cu",
        "replaces": TPU_PACKAGE_DIR + "/ops/pallas_kernels.py:71",
        "launches": launches_main["edt_row_min"] + launches_win["edt_row_min"],
        "launches_by_path": {"main_path": launches_main["edt_row_min"],
                             "windowed_path": launches_win["edt_row_min"]},
        "max_abs_err": worst_err,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None, "shape": main_shape["shape"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
