"""Timing on the card and the EDT kernel's input, shared by chip_smoke.py and
the tools."""

from __future__ import annotations

import statistics
import subprocess

import numpy as np
import torch

from cube_slam_wu_tpu_torch.ops import image as image_ops
from cube_slam_wu_tpu_torch.utils import synth


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, launches: int = 20, repeats: int = 7, warmup: int = 3,
            graph: bool = False) -> float:
    """Time of one call: `launches` calls enqueued back to back between one
    pair of CUDA events, divided by the count; median over `repeats` such
    runs.  Eagerly, a call shorter than the host's cost of enqueuing it reads
    that cost.  With `graph` the calls are captured once in a CUDA graph and
    each run replays it, so the time is the kernels' own on the card (`fn`
    must be capturable: no host read, no synchronisation)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(launches):
            fn()

    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            run()
        run = captured.replay
        run()
        torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return statistics.median(times)


def g2_from_rendered(shape, seed: int, device="cuda") -> torch.Tensor:
    """`edt_row_min`'s input at (B, H, W): rendered frames through the port's
    own Canny and column pass (squared, clamped column distances)."""
    B, H, W = shape
    seq = synth.make_sequence(n_frames=B, n_objects=3, size=(H, W), seed=seed, speed=2.0)
    gray = torch.from_numpy(np.stack(seq.images)).to(device).to(torch.float32)
    edges = image_ops.canny(gray, 80.0, 200.0)
    if not bool(edges.flatten(1).any(dim=1).all()):
        raise RuntimeError(f"rendered frames at {shape} must all have edges")
    g = image_ops._edt_1d_columns(edges)
    return (torch.clamp(g, max=1e6) ** 2).contiguous()


def g2_from_random(shape, seed: int, density: float = 0.01, device="cuda") -> torch.Tensor:
    """`edt_row_min`'s input at (B, H, W) from a seeded random edge map (for
    shapes no camera renders, such as the widest allowed row)."""
    rng = np.random.default_rng(seed)
    edges = torch.from_numpy(rng.random(shape) < density).to(device)
    g = image_ops._edt_1d_columns(edges)
    return (torch.clamp(g, max=1e6) ** 2).contiguous()
