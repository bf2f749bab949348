"""Milliseconds on the card a traced call of the work launched under the
port's ``halo.exchange`` ranges: the ghost exchange of each step or
block."""

from drbench.metrics_spans import device_ms


def read(ctx):
    return device_ms(ctx, lambda n: n == "halo.exchange",
                     "exchange_ms.stencil")
