"""K1's share of its roofline over the traced calls: the summed bound of
every launch (three bf16 tensor-core passes over the composed band) over
the summed device time of K1's kernels."""

from drbench.metrics_common import kernel_roofline
from drbench.peaks import k1_bound_ms


def read(ctx):
    return kernel_roofline(ctx, "stencil_matmul",
                               "stencil_iterate_matmul", k1_bound_ms)
