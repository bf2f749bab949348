"""The 90th percentile of the milliseconds of every call in the window,
each from its start to its end on the card's clock (CUDA events around
the call, read after the window)."""

from drbench.harness import quantile


def read(ctx):
    return quantile(ctx.call_ms, 0.9) if ctx.call_ms else None
