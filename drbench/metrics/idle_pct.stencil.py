"""The card's idle share over the traced stencil calls, in percent."""

from drbench.metrics_common import idle_pct


def read(ctx):
    return idle_pct(ctx)
