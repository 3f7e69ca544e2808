"""Port parity: `tracker.run_incremental`'s windowed branch with point
observations (`point_obs`, through `make_windowed_point_step`) in float64
against the JAX package, as test_torch_run_incremental.py holds the other
two branches, with its tolerances.
"""

import pytest

from test_torch_run_incremental import check_branch


@pytest.mark.parametrize("branch", ["points"])
def test_run_incremental_branches_f64(branch):
    check_branch(branch)
