"""Milliseconds a traced Q3 call of the card's idle gaps that begin
inside the port's ``sync.*`` ranges (the relational ops' count reads)."""

from drbench.metrics_spans import sync_idle_ms


def read(ctx):
    return sync_idle_ms(ctx)
