"""`edt_row_min_roofline`: the `edt_row_min` kernel's share of its roofline in
the profiled stretch, in percent: the least time of its launches (operations
and bytes from the launch shape, `harness.roofline.edt_row_min_bound_s`)
over their time in the device trace.  The shape is the program's record of
the kernel's last launch (`ops.cuda_kernels.LAUNCH_SHAPES`), which holds for
every launch of a cell that launches one shape, as each cell here does."""

from harness.roofline import edt_row_min_bound_s
from harness.trace import count


def read(ctx):
    tr, shape = ctx["trace"], ctx["launch_shapes"].get("edt_row_min")
    if tr is None or shape is None:
        return None
    times = count(tr, "edt_row_min")
    if not times or sum(times) <= 0:
        return None
    return 100.0 * len(times) * edt_row_min_bound_s(shape) / sum(times)
