"""Milliseconds on the card a traced call of the work launched under the
port's ``rows.copy`` ranges: the plain step's row clones, the scan's
rebuilt output row, K1's and K2's fresh output rows."""

from drbench.metrics_spans import device_ms


def read(ctx):
    return device_ms(ctx, lambda n: n == "rows.copy", "rowcopy_ms.stencil")
