"""parallel/multihost.py: real multi-process runs of the port.

`launch` spawns N OS processes (`python -m
cube_slam_wu_tpu_torch.parallel.multihost`), each a gloo rank on the CPU, on
a fresh rendezvous port.  Every worker asserts across the process boundary
that the dp-sharded proposal batch equals its own local run of the whole
batch (`valid` exactly, pos within 1e-8) and that the factor-sharded BA
equals the local `slam/ba.py::optimize` (chi2 after one iteration rtol 1e-9,
atol 0; translations after three atol 1e-10, the JAX package's multi-process
tolerances; lambda_final rtol 1e-9 after one and after three); a worker whose
check fails exits non-zero and `launch` raises.
"""

import os
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from cube_slam_wu_tpu_torch.parallel import multihost


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """launch(2) and launch(3), run at the same time (each on its own port)."""
    with ThreadPoolExecutor(2) as pool:
        runs = {n: pool.submit(multihost.launch, num_processes=n, device="cpu",
                               out_dir=str(tmp_path_factory.mktemp(f"mh{n}")), timeout_s=240)
                for n in (2, 3)}
        # launch kills its workers after timeout_s; the wait on its thread
        # has a bound of its own
        return {n: f.result(timeout=300) for n, f in runs.items()}


@pytest.mark.parametrize("n", [2, 3])
def test_launch_gloo_processes(launched, n):
    results = launched[n]
    assert len(results) == n
    for pid, line in enumerate(results):
        assert line.startswith(f"OK p{pid}/{n} device=cpu"), line
        assert f"proposals_valid={n}/{n}" in line, line
        assert "ba_chi2_1it=" in line and "ba_chi2_3it=" in line, line


def test_worker_death_fails_fast(tmp_path, monkeypatch):
    """Liveness: a worker that dies BEFORE joining the process group leaves
    the others blocked at the rendezvous; launch() must detect the death and
    raise in bounded time (seconds), not sit out the rendezvous timeout."""
    monkeypatch.setenv("CUBESLAM_MH_DIE_BEFORE_INIT", "1")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker 1 died"):
        multihost.launch(num_processes=2, device="cpu", out_dir=str(tmp_path),
                         timeout_s=120, fail_fast_grace_s=2.0)
    elapsed = time.monotonic() - t0
    assert elapsed < 30, f"fail-fast took {elapsed:.0f}s"
    assert os.environ.get("CUBESLAM_MH_DIE_BEFORE_INIT") == "1"


def test_launch_cuda_needs_a_card_per_rank(tmp_path, monkeypatch):
    """NCCL takes one rank per device: more CUDA ranks than cards is refused
    up front (no quiet switch to gloo or to the CPU)."""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank per device"):
        multihost.launch(num_processes=2, device="cuda", out_dir=str(tmp_path))
    with pytest.raises(ValueError, match="device must be"):
        multihost.launch(num_processes=2, device="tpu", out_dir=str(tmp_path))
