"""Port parity: the joint camera-object-point bundle adjuster's LM run in
float32, the production dtype, with the point Huber kernel, against the JAX
package on the graph of test_torch_point_ba.py and with its tolerances
(float32: 5e-3 relative on chi2, 2e-3 on poses, 2e-2 on points).
"""

import pytest

from test_torch_point_ba import check_optimize


@pytest.mark.parametrize("dt,opts", [("f32", {"point_huber": 2.0})])
def test_optimize(dt, opts):
    check_optimize(dt, opts)
