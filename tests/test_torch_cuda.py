"""Tests of the port that need a CUDA device (marker `cuda`; they skip
without one).  This file imports torch and the port only, so it also runs on
a machine without JAX:

    python3 -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from cube_slam_wu_tpu_torch.ops import cuda_kernels
from cube_slam_wu_tpu_torch.ops import image as timg


@pytest.mark.cuda
def test_edt_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card: bit-equal on
    inputs with edges, rtol 1e-6 on an all-empty input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    before = cuda_kernels.LAUNCHES["edt_row_min"]
    # the production shapes, a width that is no multiple of the kernel's tiles
    # (5 columns per thread, source chunks of 32), a single column, and the
    # widest allowed width
    shapes = ((3, 480, 640), (1, 375, 1242), (2, 97, 131), (1, 5, 1), (1, 40, cuda_kernels.MAX_WIDTH))
    for shape in shapes:
        edge = torch.from_numpy(rng.random(shape) < 0.01).to(dev)
        g2 = torch.clamp(timg._edt_1d_columns(edge), max=1e6) ** 2
        out = cuda_kernels.edt_row_min(g2)
        torch.cuda.synchronize()
        assert torch.equal(out, cuda_kernels.edt_row_min_plain(g2))
    g2 = torch.full((1, 64, 200), 1e12, device=dev)
    torch.testing.assert_close(
        cuda_kernels.edt_row_min(g2), cuda_kernels.edt_row_min_plain(g2),
        rtol=1e-6, atol=0,
    )
    assert cuda_kernels.LAUNCHES["edt_row_min"] == before + len(shapes) + 1
    # beyond the exactness limit K + W^2 + H^2 <= 2^24 the wrapper refuses
    with pytest.raises(ValueError, match="exact"):
        cuda_kernels.edt_row_min(torch.zeros((1, 3000, cuda_kernels.MAX_WIDTH), device=dev))
    with pytest.raises(ValueError, match="width"):
        cuda_kernels.edt_row_min(torch.zeros((1, 2, cuda_kernels.MAX_WIDTH + 1), device=dev))
