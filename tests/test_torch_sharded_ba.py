"""Port parity: parallel/sharded_ba.py against the JAX package's
`make_sharded_optimize`.

The graph is the JAX bundle-adjustment tests' `_make_synthetic(F=8,
n_active=8, noise=0.1, seed=2)`, carried across as numpy.  JAX runs it on a
2-device virtual mesh, the port on 2 and 3 gloo ranks (spawned processes,
tests/parallel_parity.py), in float64.

Tolerances: against JAX, chi2 rtol 1e-9, translations and cube scales atol
1e-10, compared after 2 LM iterations: from 3 iterations on, this exactly
consistent graph's chi2 sits at float64's rounding floor (about 1e-17, then
1e-30), where the two packages' sums differ in every digit.  The ranks of one
run are bit-equal.  The sharded result is held against the port's own
`slam/ba.py::optimize` after 2 iterations (chi2 rtol 1e-9, atol 0) and after 5
(translations and scales atol 1e-10).  lambda_final is held at rtol 1e-9
against JAX's and against the local LM's, after 2 and after 5 iterations: a
reduction that dropped the owned-row mask would sum every row on every rank,
scale J^T J, J^T r, chi2 and lambda by the world size and leave the step as it
was, so lambda is what shows it.
"""

import numpy as np
import pytest
import torch

from parallel_parity import RankRun, ba_rank
from torch_parity import jax_tree_to_numpy, to_np

from test_ba import _make_synthetic
from cube_slam_wu_tpu.parallel import sharded_ba as jsb
from cube_slam_wu_tpu_torch.parallel import sharded_ba as tsb

JAX_ITERS = 2
LOCAL_ITERS = 5


@pytest.fixture(scope="module")
def graph():
    return _make_synthetic(F=8, n_active=8, noise=0.1, seed=2)[0]


@pytest.fixture(scope="module")
def runs(graph, tmp_path_factory):
    """(the port's ranks at 2 and 3, JAX's result); the ranks run while JAX
    compiles."""
    ranks = RankRun(ba_rank, (2, 3), (jax_tree_to_numpy(graph), (JAX_ITERS, LOCAL_ITERS)),
                    tmp_path_factory.mktemp("ba"))
    mesh = jsb.make_mesh(2)
    res = jsb.make_sharded_optimize(mesh, iterations=JAX_ITERS)(jsb.replicate_to_mesh(graph, mesh))
    ref = dict(chi2=to_np(res.chi2), trans=to_np(res.cam_Tcw.trans), scale=to_np(res.cube.scale),
               lam=to_np(res.lambda_final))
    return ranks.result(), ref


@pytest.fixture(scope="module")
def port_ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_result(runs):
    return runs[1]


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_ba_matches_jax(port_ranks, jax_result, world):
    got = port_ranks[world][0]
    it = JAX_ITERS
    assert jax_result["chi2"] > 1e-9  # far above the rounding floor
    np.testing.assert_allclose(got[f"sharded{it}_chi2"], jax_result["chi2"], rtol=1e-9, atol=0)
    np.testing.assert_allclose(got[f"sharded{it}_trans"], jax_result["trans"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[f"sharded{it}_scale"], jax_result["scale"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[f"sharded{it}_lambda"], jax_result["lam"], rtol=1e-9, atol=0)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_ba_ranks_bit_equal(port_ranks, world):
    first = port_ranks[world][0]
    for other in port_ranks[world][1:]:
        for k, v in first.items():
            if k.startswith("sharded"):
                np.testing.assert_array_equal(other[k], v, err_msg=k)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_ba_matches_local_optimize(port_ranks, world):
    got = port_ranks[world][0]
    it = JAX_ITERS
    assert got[f"local{it}_chi2"] > 1e-9  # far above the rounding floor
    np.testing.assert_allclose(got[f"sharded{it}_chi2"], got[f"local{it}_chi2"], rtol=1e-9, atol=0)
    for it in (JAX_ITERS, LOCAL_ITERS):
        np.testing.assert_allclose(got[f"sharded{it}_lambda"], got[f"local{it}_lambda"],
                                   rtol=1e-9, atol=0)
    it = LOCAL_ITERS
    np.testing.assert_allclose(got[f"sharded{it}_trans"], got[f"local{it}_trans"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[f"sharded{it}_scale"], got[f"local{it}_scale"], rtol=0, atol=1e-10)


def test_sharded_functions_need_a_process_group():
    """Without a process group the parallel functions raise (they never run
    as a world of one on their own) and name the initialiser."""
    from cube_slam_wu_tpu_torch.ops.proposal import ProposalConfig
    from cube_slam_wu_tpu_torch.parallel import multihost
    from cube_slam_wu_tpu_torch.parallel.sharded_proposal import (
        detect_cuboid_sharded, detect_cuboids_dp,
    )
    from cube_slam_wu_tpu_torch.utils import synth

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        tsb.make_sharded_optimize(None)
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        tsb.make_group()
    ins = synth.proposal_demo_inputs(torch.float64, device="cpu")
    cfg = ProposalConfig(max_lines=16)
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        detect_cuboid_sharded(*ins, cfg, None)
    gray, K, T, bbox, lines, mask = ins
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        detect_cuboids_dp(gray, K, T, bbox[None], torch.ones(1, dtype=torch.bool), lines, mask,
                          cfg, None)
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        multihost.local_rows(np.zeros((4, 2)), None)


@pytest.mark.parametrize("world", [2, 3])
def test_parallel_parity_imports_no_jax(port_ranks, world):
    """The rank workers (tests/parallel_parity.py and the port's whole
    `parallel` package, in freshly spawned processes) import nothing of JAX
    or of the JAX package."""
    for rank_out in port_ranks[world]:
        assert rank_out["foreign_modules"].size == 0, rank_out["foreign_modules"]
