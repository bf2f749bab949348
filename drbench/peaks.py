"""The yardstick's peaks and the operation and byte counts of the kernels
the benchmark holds against them.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A roofline bound is the larger
of bytes / bandwidth and operations / peak rate, each input byte read
once and each output byte written once, whatever a kernel reads again.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12


def bound(bytes_moved, flops, peak=FP32_FLOP_PER_S):
    """The least milliseconds the chip could take, and what bounds it
    (``"bytes"`` or ``"operations"``)."""
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def radius(weights):
    return (len(weights) - 1) // 2


def k1_bound_ms(n, weights, steps):
    """K1, one launch composing ``steps`` steps over ``n`` f32 cells:
    three bf16 tensor-core passes over the composed band, 2 operations a
    tap, ``2R + 1`` taps with R = steps * radius."""
    taps = 2 * steps * radius(weights) + 1
    return bound(8 * n, 3 * 2 * taps * n, BF16_TC_FLOP_PER_S)


def k2_bound_ms(n, weights, steps):
    """K2, one launch of ``steps`` steps over ``n`` f32 cells: 2 x taps - 1
    fp32 operations a cell-step (the multiplies and the adds)."""
    return bound(8 * n, (2 * len(weights) - 1) * steps * n)


def plain_step_bound_ms(n):
    """One plain step over ``n`` f32 cells: the field read once and the
    new field written once (its operations are far below the fp32 rate)."""
    return bound(8 * n, 0)
