"""Milliseconds of ``groupby_aggregate`` on the card a traced call: the device time
of the operations launched inside the benchmark's ``drbench.groupby`` spans
(every ``groupby`` op of the call), matched by correlation id."""

from drbench.metrics_common import span_device_ms


def read(ctx):
    return span_device_ms(ctx, "groupby")
