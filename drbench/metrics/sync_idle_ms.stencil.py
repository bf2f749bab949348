"""Milliseconds a traced stencil call of the card's idle gaps that begin
inside the port's ``sync.*`` ranges (the dot's host read)."""

from drbench.metrics_spans import sync_idle_ms


def read(ctx):
    return sync_idle_ms(ctx)
