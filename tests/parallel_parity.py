"""Rank workers of the parallel parity tests (tests/test_torch_sharded_*.py).

Imports torch and the port only, never JAX: each rank is a fresh process
(`RankRun`, the `spawn` start method), which imports this module and the
port and joins a gloo group on the CPU.  Each rank writes what it computed to
`<dir>/rank<r>.npz`; `RankRun.result` returns those files' contents in rank
order.
"""

from __future__ import annotations

import pathlib
import socket
import time

import numpy as np
import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankRun:
    """For each group size W in `worlds`, `fn(rank, W, port, dir, *args)` in
    W spawned processes on a fresh port, every group at the same time.  The
    processes start at construction, so the caller can work meanwhile;
    `result()` waits for them and returns {W: [rank 0's outputs, rank 1's,
    ...]}.  It raises if a rank fails or the run takes longer than
    `timeout_s` from its start (the survivors are then killed)."""

    def __init__(self, fn, worlds, args: tuple, out_dir, timeout_s: float = 120.0):
        self.name = fn.__name__
        self.deadline = time.monotonic() + timeout_s
        self.timeout_s = timeout_s
        self.dirs = {w: pathlib.Path(out_dir) / f"world{w}" for w in worlds}
        self.ctxs = {}
        try:
            for w, d in self.dirs.items():
                d.mkdir(parents=True, exist_ok=True)
                self.ctxs[w] = mp.start_processes(fn, args=(w, free_port(), str(d), *args),
                                                  nprocs=w, join=False, start_method="spawn")
        except BaseException:
            self._kill()
            raise

    def _kill(self):
        for ctx in self.ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)

    def result(self) -> dict:
        try:
            for ctx in self.ctxs.values():
                while not ctx.join(timeout=0.5):
                    if time.monotonic() > self.deadline:
                        raise TimeoutError(f"{self.name}: the ranks took over {self.timeout_s} s")
        finally:
            self._kill()
        out = {}
        for w, d in self.dirs.items():
            out[w] = []
            for r in range(w):
                with np.load(d / f"rank{r}.npz") as z:
                    out[w].append({k: z[k] for k in z.files})
        return out


def foreign_modules() -> list:
    """The modules of JAX or of the JAX package loaded in this process."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cube_slam_wu_tpu"))


def _join(rank, world, port):
    # the whole parallel package, as a rank imports it
    from cube_slam_wu_tpu_torch.parallel import multihost, pipelined, sharded_ba, sharded_proposal  # noqa: F401

    torch.set_num_threads(1)
    multihost.initialize(f"tcp://127.0.0.1:{port}", world, rank, "cpu")
    return multihost.global_group()


def ba_rank(rank, world, port, out_dir, graph_np, iteration_counts):
    """The factor-sharded BA of the graph (nested dicts of numpy, float64)
    at each iteration count; rank 0's graph is what every rank optimises."""
    import torch.distributed as dist

    from cube_slam_wu_tpu_torch.parallel import sharded_ba
    from cube_slam_wu_tpu_torch.slam import ba, convert
    from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph

    group = _join(rank, world, port)
    graph = convert.state_from_numpy(graph_np, "cpu", torch.float64, kind=CameraObjectGraph)
    graph = sharded_ba.replicate(graph, group, "cpu")
    out = {"foreign_modules": np.array(foreign_modules(), dtype=str)}
    for it in iteration_counts:
        for name, res in (("sharded", sharded_ba.make_sharded_optimize(group, iterations=it)(graph)),
                          ("local", ba.optimize(graph, iterations=it))):
            out[f"{name}{it}_chi2"] = res.chi2.numpy()
            out[f"{name}{it}_lambda"] = res.lambda_final.numpy()
            out[f"{name}{it}_quat"] = res.cam_Tcw.quat.numpy()
            out[f"{name}{it}_trans"] = res.cam_Tcw.trans.numpy()
            out[f"{name}{it}_cube"] = res.cube.to_minimal().numpy()
            out[f"{name}{it}_scale"] = res.cube.scale.numpy()
    dist.destroy_process_group()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)


def proposal_rank(rank, world, port, out_dir, inputs, cases):
    """`detect_cuboid_sharded` on `inputs` (gray, K, T_wc, bbox, lines, mask
    as numpy, float64) for each case {name: ProposalConfig kwargs}, and the
    port's `detect_cuboid_single` beside it."""
    import torch.distributed as dist

    from cube_slam_wu_tpu_torch.ops import proposal as prop
    from cube_slam_wu_tpu_torch.parallel.sharded_proposal import detect_cuboid_sharded

    group = _join(rank, world, port)
    args = [torch.as_tensor(np.array(a)) for a in inputs]
    out = {"foreign_modules": np.array(foreign_modules(), dtype=str)}
    for name, kw in cases.items():
        cfg = prop.ProposalConfig(**kw)
        for how, res in (("sharded", detect_cuboid_sharded(*args, cfg, group)),
                         ("single", prop.detect_cuboid_single(*args, cfg))):
            for field, v in res._asdict().items():
                out[f"{name}/{how}/{field}"] = v.numpy()
    dist.destroy_process_group()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
