"""Milliseconds of memcpy and memset on the card a traced call: the ring
exchanges, the plain step's row clones and the host reads."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.dev:
        return None
    us = ctx.trace.cat_us(("gpu_memcpy", "gpu_memset"))
    return us / ctx.traced_calls / 1e3
