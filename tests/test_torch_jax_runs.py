"""The committed outputs of the JAX package's driver runs (tests/jax_runs.py)
are what the JAX package gives: `make_jax_runs.main` writes a fresh set
(7-13 minutes on 8 CPU cores, hence slow), held here to the committed
one leaf by leaf, integers and masks exactly.
"""

import pytest

import make_jax_runs
from jax_runs import DATA, load
from torch_parity import assert_tree_close, tree_np


@pytest.mark.slow
def test_committed_jax_runs_are_what_the_jax_package_gives(tmp_path):
    make_jax_runs.main(tmp_path)
    names = sorted(p.name for p in DATA.glob("*.npz"))
    assert names == sorted(p.name for p in tmp_path.glob("*.npz"))
    for name in names:
        fresh, committed = load(tmp_path / name), load(DATA / name)
        assert_tree_close(tree_np(fresh), tree_np(committed), atol=1e-6, rtol=1e-6, path=name)
