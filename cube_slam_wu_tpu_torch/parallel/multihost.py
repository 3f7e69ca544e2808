"""Multi-process execution on `torch.distributed`.

The reference is a single C++ process with no distributed compute at all
(SURVEY.md section 2.9 / 5.8 — its ROS pub/sub is viz-only,
object_slam/src/main_obj.cpp:205-222).  The scale-out here:

- `initialize` joins one process group of N processes, one rank per device:
  `gloo` for ranks on the CPU, `nccl` for ranks on CUDA devices (NCCL takes
  one rank per device, so N ranks on CUDA need N cards);
- the programs of this package (parallel/sharded_ba.py's factor reduction,
  parallel/sharded_proposal.py's roll/pitch split and dp batches) take that
  group explicitly and run their rank's block; the reductions and gathers
  are `torch.distributed` collectives over it;
- inputs that every process holds (made from the same seed) are cut with
  `local_rows`: each rank materialises only its rows; replicated state is
  broadcast from rank 0 (`replicate_tree`).

This module provides the initialisation and group helpers, a validation
worker (`worker_main`) that runs the dp-sharded proposal batch and the
factor-sharded BA across the process boundary and asserts equality with a
purely local run in the same process, and `launch()`, which spawns N OS
processes (gloo on the CPU, or NCCL with one card per rank) so that the
multi-process path is testable on one machine:

    python -c "from cube_slam_wu_tpu_torch.parallel import multihost; \\
               print(multihost.launch(3, device='cpu'))"
"""

from __future__ import annotations

import argparse
import datetime
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from cube_slam_wu_tpu_torch.utils.tree import tree_map

# How long a rank waits in a collective or at the rendezvous before failing.
TIMEOUT_S = 120


def initialize(init_method: str, world_size: int, rank: int, device) -> None:
    """Join the process group (idempotent per process): `nccl` bound to
    `device` when it is a CUDA device, `gloo` when the caller names the CPU.
    `device` has no default: the rank's device is always stated.
    `init_method` is e.g. `tcp://127.0.0.1:29500`."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    kw = dict(init_method=init_method, world_size=world_size, rank=rank,
              timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device, **kw)
    else:
        dist.init_process_group("gloo", **kw)


def global_group():
    """The group of every process that joined through `initialize`."""
    rank_world(None)
    return dist.group.WORLD


def rank_world(group) -> tuple:
    """(this process's rank in `group`, the group's size); `None` is the
    global group.  Raises when no process group exists: the parallel
    functions never fall back to a world of one on their own."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call "
            "cube_slam_wu_tpu_torch.parallel.multihost.initialize first"
        )
    return dist.get_rank(group), dist.get_world_size(group)


def local_rows(value, group, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of `value`'s `dim` axis (rank r of W
    takes rows [r*n/W, (r+1)*n/W)), copied out on `value`'s device; `value`
    (a tensor or an array) is the same on every rank."""
    rank, world = rank_world(group)
    value = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    n = value.shape[dim]
    if n % world:
        raise ValueError(f"local_rows: {n} rows do not split over {world} ranks")
    block = n // world
    return value.narrow(dim, rank * block, block).contiguous()


def replicate_tree(tree, group, device):
    """Rank 0's `tree` (nested NamedTuples of tensors) on `device` on every
    rank: each leaf is broadcast from rank 0, in the same order on every
    rank, so the replicas are equal by construction.  Bool leaves travel as
    uint8."""
    rank_world(group)
    src = dist.get_global_rank(group, 0) if group is not None else 0

    def broadcast(leaf):
        t = leaf.to(device)
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.clone(memory_format=torch.contiguous_format)
        dist.broadcast(wire, src=src, group=group)
        return wire.to(torch.bool) if t.dtype == torch.bool else wire

    return tree_map(broadcast, tree)


def allgather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` concatenated along axis 0, in rank order, on every
    rank.  Bool tensors travel as uint8."""
    _, world = rank_world(group)
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    wire = wire.contiguous()
    parts = [torch.empty_like(wire) for _ in range(world)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim=0)
    return out.to(torch.bool) if x.dtype == torch.bool else out


# ---------------------------------------------------------------------------
# validation worker: dp proposal + factor-sharded BA across processes
# ---------------------------------------------------------------------------

# The cuboids of `_build_ba_graph`, one row per object: [x y z roll pitch yaw
# l w h] (the first two are the JAX package's two).
_BA_CUBES = (
    (0.5, 2.0, 0.3, 0, 0, 0.7, 0.4, 0.3, 0.3),
    (-0.6, 2.5, 0.25, 0, 0, -0.4, 0.3, 0.25, 0.25),
    (0.1, 3.2, 0.35, 0, 0, 0.2, 0.5, 0.35, 0.35),
)


def _build_ba_graph(F: int, dtype=torch.float64, device="cpu", n_objects: int = 2):
    """Small multi-object graph with a known-good structure: F frames, every
    frame observing every object, odometry between neighbours, the poses
    perturbed by 0.01 in every tangent coordinate.  At `n_objects=2` it is the
    JAX package's `_build_ba_graph(F, dtype)` (the same numbers from the same
    seed)."""
    from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
    from cube_slam_wu_tpu_torch.core.se3 import SE3
    from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph

    O = n_objects
    if not 1 <= O <= len(_BA_CUBES):
        raise ValueError(f"_build_ba_graph: n_objects must be 1..{len(_BA_CUBES)}")
    rng = np.random.default_rng(1)
    graph = CameraObjectGraph.empty(F, O, dtype, device)
    tang = torch.as_tensor(rng.normal(size=(F, 6)) * 0.05).to(device, dtype)
    Tcw = SE3.exp(tang)
    odom = [SE3.identity((), dtype, device)]
    for i in range(1, F):
        odom.append(Tcw[i].compose(Tcw[i - 1].inverse()))
    odom = SE3(torch.stack([o.quat for o in odom]), torch.stack([o.trans for o in odom]))
    cubes = Cuboid.from_minimal(torch.tensor(_BA_CUBES[:O], dtype=dtype, device=device))
    Tcw_b = SE3(Tcw.quat[:, None, :].expand(F, O, 4), Tcw.trans[:, None, :].expand(F, O, 3))
    cube_b = Cuboid(
        SE3(cubes.pose.quat[None].expand(F, O, 4), cubes.pose.trans[None].expand(F, O, 3)),
        cubes.scale[None].expand(F, O, 3),
    )
    meas_b = cube_b.transform_to(Tcw_b.inverse())
    ones = lambda *s: torch.ones(s, dtype=torch.bool, device=device)  # noqa: E731
    return graph._replace(
        cam_Tcw=SE3.exp(tang + 0.01),
        cube=cubes,
        frame_mask=ones(F),
        cube_valid=ones(O),
        odom=odom,
        odom_mask=torch.arange(F, device=device) > 0,
        cube_meas=meas_b,
        cube_meas_weight=torch.full((F, O), 1.8, dtype=dtype, device=device),
        cube_meas_mask=ones(F, O),
    )


def worker_main(argv=None) -> None:
    """Entry for one process of the multi-process validation run.

    Asserts, across a REAL process boundary:
    1. the dp-sharded proposal batch (B = world-size boxes, each rank running
       `detect_cuboids` on its rows, then `allgather`) == this process's own
       local run of the whole batch;
    2. the factor-sharded BA (all-reduced normal equations) == local
       `slam.ba.optimize`.
    """
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True, help="host:port of rank 0's rendezvous")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", choices=("cpu", "cuda"), required=True,
                   help="cuda: an NCCL rank on card <process-id>; cpu: a gloo rank")
    args = p.parse_args(argv)

    # fault-injection hook for the launch() liveness test: the named worker
    # dies BEFORE joining the process group, so the remaining workers block
    # at the rendezvous — launch() must detect the death and fail fast
    # instead of hanging until the rendezvous timeout.
    if os.environ.get("CUBESLAM_MH_DIE_BEFORE_INIT") == str(args.process_id):
        print(f"[multihost p{args.process_id}] injected pre-init death", flush=True)
        sys.exit(3)

    device = torch.device("cuda", args.process_id) if args.device == "cuda" else torch.device("cpu")
    initialize(f"tcp://{args.coordinator}", args.num_processes, args.process_id, device)
    try:
        line = _validate(args, device)
    finally:
        dist.destroy_process_group()
    pathlib.Path(args.out).write_text(line + "\n")
    print(f"[multihost p{args.process_id}] {line}", flush=True)


def _validate(args, device) -> str:
    from cube_slam_wu_tpu_torch.ops.proposal import ProposalConfig, detect_cuboids
    from cube_slam_wu_tpu_torch.parallel import sharded_ba
    from cube_slam_wu_tpu_torch.parallel.sharded_proposal import detect_cuboids_dp
    from cube_slam_wu_tpu_torch.slam import ba as local_ba
    from cube_slam_wu_tpu_torch.utils import synth

    dtype = torch.float64
    group = global_group()
    _, world = rank_world(group)

    # ---- 1. dp-sharded proposal batch across the process boundary ----------
    cfg = ProposalConfig(max_lines=16, max_top_samples=8)
    gray, K, T_wc, bbox, lines, mask = synth.proposal_demo_inputs(
        dtype, img_hw=(192, 256), n_lines=16, device=device
    )
    B = world
    shift = torch.arange(B, dtype=dtype, device=device)[:, None] * torch.tensor(
        [1.0, 0.5, 0.0, 0.0], dtype=dtype, device=device)
    bbox_b = bbox[None] + shift
    box_mask = torch.ones(B, dtype=torch.bool, device=device)
    res = detect_cuboids_dp(gray, K, T_wc, bbox_b, box_mask, lines, mask, cfg, group)
    ref = detect_cuboids(gray, K, T_wc, bbox_b, box_mask, lines, mask, cfg)
    valid, ref_valid = res.valid.cpu().numpy(), ref.valid.cpu().numpy()
    np.testing.assert_array_equal(valid, ref_valid)
    both = valid & ref_valid
    if both.sum() < B - 1:
        raise AssertionError(f"expected valid proposals, got {both.sum()} of {B}")
    np.testing.assert_allclose(res.pos.cpu().numpy()[both], ref.pos.cpu().numpy()[both],
                               rtol=1e-8, atol=1e-8)

    # ---- 2. factor-sharded BA with an all-reduce across processes ----------
    # chi2 is held after one iteration (about 1e-9 to 1e-8 on this graph):
    # from the second on it nears float64's rounding floor, where the order of
    # the sums alone moves its digits.  lambda_final is held at both counts:
    # a reduction that summed every row on every rank would scale the normal
    # equations, chi2 and lambda by the world size and leave the step alone.
    F = 2 * world
    graph = sharded_ba.replicate(_build_ba_graph(F, dtype), group, device)
    ba = {}
    for it in (1, 3):
        out = sharded_ba.make_sharded_optimize(group, iterations=it)(graph)
        ref_ba = local_ba.optimize(graph, iterations=it)
        ba[it] = (float(out.chi2), float(ref_ba.chi2))
        np.testing.assert_allclose(float(out.lambda_final), float(ref_ba.lambda_final),
                                   rtol=1e-9, atol=0)
    np.testing.assert_allclose(*ba[1], rtol=1e-9, atol=0)
    np.testing.assert_allclose(out.cam_Tcw.trans.cpu().numpy(),
                               ref_ba.cam_Tcw.trans.cpu().numpy(), rtol=0, atol=1e-10)
    return (f"OK p{args.process_id}/{args.num_processes} device={device.type} "
            f"proposals_valid={int(both.sum())}/{B} ba_chi2_1it={ba[1][0]!r} (local {ba[1][1]!r}) "
            f"ba_chi2_3it={ba[3][0]:.6e} (local {ba[3][1]:.6e})")


def _free_port() -> int:
    """Ask the OS for a currently-free TCP port (bind to 0, read it back).
    A stale worker or TIME_WAIT on a fixed port would make the rendezvous
    hang until its timeout instead of failing fast; a fresh ephemeral port
    per launch avoids the collision class."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(
    num_processes: int,
    device: str,
    out_dir: str | None = None,
    port: int | None = None,
    timeout_s: float = 300,
    fail_fast_grace_s: float = 10.0,
) -> list[str]:
    """Spawn `num_processes` OS processes running `worker_main` (NCCL ranks
    on cards 0..N-1 with `device="cuda"`, or gloo ranks with `device="cpu"`)
    and return the per-process result lines.  Raises on any worker failure.  The
    rendezvous port is picked fresh from the OS by default; pass `port` only
    to pin it.

    Liveness supervision: workers are POLLED, not joined one after another —
    if any worker dies while others are still running (e.g. one crashed
    before joining the group, leaving the rest blocked at the rendezvous),
    the survivors are killed after `fail_fast_grace_s` and a RuntimeError
    naming the dead worker is raised in seconds instead of hanging until
    the rendezvous timeout."""
    import tempfile
    import time

    if device not in ("cpu", "cuda"):
        raise ValueError(f"launch: device must be 'cpu' or 'cuda', not {device!r}")
    if device == "cuda" and num_processes > torch.cuda.device_count():
        raise ValueError(
            f"launch: {num_processes} NCCL ranks need {num_processes} CUDA devices, "
            f"found {torch.cuda.device_count()}: NCCL takes one rank per device "
            "(run the ranks on the CPU with device='cpu')"
        )
    port = port if port is not None else _free_port()
    out_dir = out_dir or tempfile.mkdtemp(prefix="cubeslam_mh_")
    repo = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH")) if p)
    # one intra-op thread per rank: several ranks share the host's cores, and
    # MKL's batched float32 3x3 LU was seen to stall with several threads
    env["OMP_NUM_THREADS"] = "1"

    procs, outs, log_files, log_paths = [], [], [], []
    try:
        for pid in range(num_processes):
            out_path = os.path.join(out_dir, f"worker_{pid}.txt")
            log_path = os.path.join(out_dir, f"worker_{pid}.log")
            outs.append(out_path)
            log_paths.append(log_path)
            cmd = [
                sys.executable, "-m", "cube_slam_wu_tpu_torch.parallel.multihost",
                "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", str(num_processes),
                "--process-id", str(pid),
                "--out", out_path,
                "--device", device,
            ]
            lf = open(log_path, "w")
            log_files.append(lf)
            procs.append(subprocess.Popen(cmd, env=env, stdout=lf, stderr=subprocess.STDOUT))

        def read_log(pid):
            try:
                if not log_files[pid].closed:
                    log_files[pid].flush()
                with open(log_paths[pid]) as f:
                    return f.read()[-4000:]
            except OSError:
                return "<no log>"

        def kill_all():
            for q in procs:
                if q.poll() is None:
                    q.kill()
            for q in procs:
                try:
                    q.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass

        deadline = time.monotonic() + timeout_s
        first_death = None  # (pid, rc, time)
        while True:
            running = [pr.poll() is None for pr in procs]
            failed = [pid for pid, pr in enumerate(procs)
                      if pr.poll() is not None and pr.returncode != 0]
            if failed and first_death is None:
                first_death = (failed[0], procs[failed[0]].returncode, time.monotonic())
            if not any(running):
                break
            if first_death is not None and time.monotonic() - first_death[2] > fail_fast_grace_s:
                pid, rc, _ = first_death
                kill_all()
                raise RuntimeError(
                    f"multihost worker {pid} died (rc={rc}) while {sum(running)} worker(s) "
                    f"were still running; killed survivors.  Worker {pid} log:\n{read_log(pid)}"
                )
            if time.monotonic() > deadline:
                kill_all()
                raise TimeoutError(
                    f"multihost launch exceeded {timeout_s}s; killed all workers.  "
                    f"Worker 0 log:\n{read_log(0)}"
                )
            time.sleep(0.25)

        results = []
        for pid, (pr, out_path) in enumerate(zip(procs, outs)):
            if pr.returncode != 0 or not os.path.exists(out_path):
                raise RuntimeError(
                    f"multihost worker {pid} failed (rc={pr.returncode}):\n{read_log(pid)}"
                )
            with open(out_path) as f:
                results.append(f.read().strip())
        return results
    finally:
        for q in procs:  # never leave a worker behind, whatever raised
            if q.poll() is None:
                q.kill()
                q.wait()
        for lf in log_files:
            lf.close()


if __name__ == "__main__":
    worker_main()
