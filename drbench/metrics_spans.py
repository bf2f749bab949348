"""What the readers of the port's own spans share.

``dr_tpu_torch.obs.span`` opens a ``torch.profiler`` range while a
capture records, so a traced call carries the port's ranges
(``sync.<site>``, ``rows.copy``, ``halo.exchange``,
``relational.<op>[.<phase>]``) as ``user_annotation`` events on the
device trace's clock, nested inside the benchmark's ``drbench.<op>``
ranges.  A family whose ops open ranges of other names lists their
prefixes as ``SPANS`` in ``families/<kind>.py``.  The readers take the
device time of the work launched under a set of ranges, or the idle gaps
that begin inside one.

A trace with no device events (a run on the CPU), or with none of the
port's ranges at all (a program without them), reads None.  A trace that
has the port's ranges but none that a metric names raises: the port and
the metric disagree.
"""

from bisect import bisect_right

from drbench import harness
from drbench.trace import LAUNCH_CATS, _union

#: name prefixes of the port's profiler ranges in every family
PORT = ("sync.", "rows.", "halo.", "relational.")


def prefixes(ctx):
    """The port's range prefixes in a run of ``ctx``: ``PORT`` and the
    ``SPANS`` that the configuration's family names."""
    cfg = getattr(ctx, "config", None)
    if not cfg:
        return PORT
    fam = harness.family(harness.ROOT, cfg["kind"])
    return PORT + tuple(getattr(fam, "SPANS", ()))


def _port_ranges(ctx):
    names = prefixes(ctx)
    return [s for s in ctx.trace.host if s["cat"] == "user_annotation"
            and s["name"].startswith(names)]


def _ranges(ctx, match, what):
    """The port's ranges whose name ``match`` accepts; None without
    device events or without any of the port's ranges, an error where
    there are port ranges but none for ``what``."""
    if ctx.trace is None or not ctx.trace.dev:
        return None
    port = _port_ranges(ctx)
    if not port:
        return None
    got = [s for s in port if match(s["name"])]
    if not got:
        raise ValueError(f"{what}: the trace holds {len(port)} of the "
                         "port's ranges, none of them this metric's")
    return got


class _Within:
    """The union of the spans' intervals, as sorted disjoint pieces: a
    nested or repeated range counts once.  ``t in within`` says whether
    time ``t`` lies in a piece."""

    def __init__(self, spans):
        self.starts, self.ends = [], []
        for s0, s1 in sorted((float(s["ts"]),
                              float(s["ts"]) + float(s["dur"]))
                             for s in spans):
            if self.ends and s0 <= self.ends[-1]:
                self.ends[-1] = max(self.ends[-1], s1)
            else:
                self.starts.append(s0)
                self.ends.append(s1)

    def __contains__(self, t):
        i = bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def device_ms(ctx, match, what):
    """Device milliseconds a traced call of the work launched inside the
    matching ranges: the launches' correlation ids, then the union of
    their device intervals, so work under nested ranges counts once."""
    spans = _ranges(ctx, match, what)
    if spans is None:
        return None
    within = _Within(spans)
    view = ctx.trace
    corr = {h["args"]["correlation"] for h in view.host
            if h["cat"] in LAUNCH_CATS and "correlation" in h.get("args", {})
            and float(h["ts"]) in within}
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in view.dev if e.get("args", {}).get("correlation") in corr]
    return _union(dev)[0] / ctx.traced_calls / 1e3


def sync_idle_ms(ctx):
    """Milliseconds a traced call of the device's idle gaps that begin
    inside a ``sync.*`` range: the card drains while the host waits on
    the read, then stays dry until the host launches again."""
    spans = _ranges(ctx, lambda n: n.startswith("sync."), "sync_idle_ms")
    if spans is None:
        return None
    within = _Within(spans)
    us = sum(g for g, a, _ in ctx.trace.gaps if a in within)
    return us / ctx.traced_calls / 1e3
