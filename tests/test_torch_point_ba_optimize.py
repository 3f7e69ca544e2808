"""Port parity: the joint camera-object-point bundle adjuster's LM run
with the point Huber kernel, the graph's Huber kernel and the fixed-lag
prior, in float64, against the JAX package on the graph of
test_torch_point_ba.py and with its tolerances.
"""

import pytest

from test_torch_point_ba import check_optimize


@pytest.mark.parametrize("dt,opts", [("f64", {"point_huber": 2.0, "robust_delta": 0.5, "prior": True})])
def test_optimize(dt, opts):
    check_optimize(dt, opts)
