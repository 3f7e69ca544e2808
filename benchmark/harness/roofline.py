"""Peaks of the card and the operation and byte counts of the port's kernels.

Peaks: NVIDIA's data sheet for the H100 SXM (dense rates, at the full power
limit of 700 W).  A share of a roofline is the least time the card could
take for a launch, the larger of its operations over the peak rate and its
bytes over the memory rate, divided by the launch's time in the device trace.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def edt_row_min_bound_s(shape) -> float:
    """Least time of one `edt_row_min` launch at (B, H, W) (copied from the
    port's `chip_smoke.edt_bound_ms`): B*H*W^2 candidates of one fused
    multiply-add (2 operations) and one min, at the float32 rate, against the
    input read once and the output written once.  It counts the min at the
    float32 rate, as if the DPX three-input min the kernel uses issued at
    that rate."""
    *lead, H, W = shape
    B = 1
    for n in lead:
        B *= n
    ops_s = 3.0 * B * H * W * W / PEAK_FP32_FLOPS
    bytes_s = 2.0 * B * H * W * 4 / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s)
