"""Arithmetic the per-layer metric readers share."""


def passes(op):
    """Steps of each launch one step op makes: full blocks, then the
    rest."""
    block = op.get("k_block") or op.get("time_block") or 1
    full, rest = divmod(op["steps"], block)
    return [block] * full + ([rest] if rest else [])


def idle_pct(ctx):
    """The card's idle share of the traced window, in percent; None
    without device events."""
    if ctx.trace is None or not ctx.trace.dev:
        return None
    return 100.0 * ctx.trace.idle_share()


def span_device_ms(ctx, op_name):
    """Device milliseconds a traced call of the operations launched
    under the benchmark's ``drbench.<op_name>`` spans (every such op of
    the call); None without them."""
    if ctx.trace is None:
        return None
    dev = [ctx.trace.device_us_under(s)
           for s in ctx.trace.spans("drbench." + op_name)]
    if not dev or any(d is None for d in dev):
        return None
    return sum(dev) / ctx.traced_calls / 1e3


def kernel_roofline(ctx, counter, op_name, bound_ms):
    """The summed bound of the launches that the traffic's ``op_name``
    ops make over the traced calls, over the summed device time of the
    kernels of ``counter``; None without them.  The launches found must
    be the launches the traffic implies."""
    if ctx.trace is None:
        return None
    us, found = ctx.trace.kernel_us(counter)
    if not found:
        return None
    nsts = [nst for op in ctx.traffic["ops"] if op["op"] == op_name
            for nst in passes(op)] * ctx.traced_calls
    if found != len(nsts):
        raise ValueError(f"{counter}: {found} launches in the trace, "
                         f"{len(nsts)} implied by the traffic")
    w, n = ctx.config["weights"], ctx.config["n"]
    bound_us = sum(bound_ms(n, w, nst)[0] for nst in nsts) * 1e3
    return 100.0 * bound_us / us
