"""The plain step's share of its byte bound: n x 8 bytes a step at the
HBM rate, over the device time of the operations launched under the
benchmark's ``drbench.stencil_iterate`` spans."""

from drbench.peaks import plain_step_bound_ms


def read(ctx):
    if ctx.trace is None:
        return None
    spans = ctx.trace.spans("drbench.stencil_iterate")
    dev = [ctx.trace.device_us_under(s) for s in spans]
    if not dev or any(d is None for d in dev):
        return None
    steps = sum(op["steps"] for op in ctx.traffic["ops"]
                if op["op"] == "stencil_iterate")
    if not steps or any(op["op"].startswith("stencil_iterate_")
                        for op in ctx.traffic["ops"]):
        return None
    bound_us = plain_step_bound_ms(ctx.config["n"])[0] * 1e3 * steps
    return 100.0 * bound_us * len(dev) / sum(dev)
