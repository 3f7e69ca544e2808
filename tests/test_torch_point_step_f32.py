"""Port parity: the point-augmented fixed-lag step in float32, the
production dtype, on the drive of test_torch_point_step.py and with its
tolerances (float32: 2e-3 on poses and cuboids, 5e-2 on points, 2e-2
relative on chi2; masks exactly).
"""

import pytest

from test_torch_point_step import check_every_frame


@pytest.mark.parametrize("dt", ["f32"])
def test_windowed_point_step_every_frame(dt):
    check_every_frame(dt)
