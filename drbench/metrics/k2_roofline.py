"""K2's share of its roofline over the traced calls: the summed bound of
every launch (9 fp32 operations a cell-step for 5 taps) over the summed
device time of K2's kernels."""

from drbench.metrics_common import kernel_roofline
from drbench.peaks import k2_bound_ms


def read(ctx):
    return kernel_roofline(ctx, "stencil_blocked",
                               "stencil_iterate_blocked", k2_bound_ms)
