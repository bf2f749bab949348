"""Milliseconds of ``join`` on the card a traced call: the device time
of the operations launched inside the benchmark's ``drbench.join`` spans
(every ``join`` op of the call), matched by correlation id."""

from drbench.metrics_common import span_device_ms


def read(ctx):
    return span_device_ms(ctx, "join")
