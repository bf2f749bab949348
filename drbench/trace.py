"""Reading a ``torch.profiler`` Chrome trace: the device's busy and idle
time, the device operations by kernel, the longest idle gaps with the
host work under them, and the device time of the operations that one
host span launched.

The busy time is the union of the kernel, memcpy and memset intervals;
the window runs from the first device event's start to the last one's
end.  Kernels are named by the ``__global__`` functions of the port's
CUDA sources, mapped to the port's K-numbers.
"""

import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the Chrome-trace categories of host work that a gap can overlap
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the port's launch counters (``ops/kernels.py``) and their K-numbers
K_OF = {"stencil_matmul": "K1", "stencil_blocked": "K2",
        "chunked_dot": "K3", "chunked_cumsum": "K4",
        "stencil2d_blocked": "K5", "bitonic_sort": "K6", "segred": "K7",
        "flash_update": "K9"}
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*"
                     r"(\w+)\s*\(")


def global_kernels(sources):
    """``__global__`` function name -> launch counter, from
    ``{counter: source text}``."""
    out = {}
    for counter, text in sources.items():
        for m in _GLOBAL.finditer(text):
            out[m.group(1)] = counter
    return out


def kernel_base(name):
    """The function name of a kernel as the profiler gives it
    (demangled): ``void (anonymous namespace)::scan_tiles<float>(float
    const*, ...)`` -> ``scan_tiles``."""
    s = name.replace("(anonymous namespace)::", "")
    s = s.split("(", 1)[0].split("<", 1)[0].strip()
    return s.split("::")[-1].split()[-1] if s else name


def _union(intervals):
    """Total length of the union of ``(start, end)`` intervals, and the
    gaps between its pieces as ``(length, start, end)``."""
    busy, gaps = 0.0, []
    ivs = sorted(intervals)
    if not ivs:
        return 0.0, gaps
    cur_s, cur_e = ivs[0]
    for s, e in ivs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, gaps


class TraceView:
    """One Chrome trace, read once.  Times are microseconds."""

    def __init__(self, events, kernels=None):
        self.kernels = kernels or {}
        self.dev = sorted((e for e in events
                           if e.get("cat") in DEVICE_CATS and "dur" in e),
                          key=lambda e: float(e["ts"]))
        self.host = [e for e in events
                     if e.get("cat") in HOST_CATS and "dur" in e]
        ivs = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in self.dev]
        self.busy_us, self.gaps = _union(ivs)
        self.window_us = (max(e for _, e in ivs) - ivs[0][0]) if ivs else 0.0
        self.t0 = ivs[0][0] if ivs else 0.0

    @classmethod
    def load(cls, path, kernels=None):
        with open(path, encoding="utf-8") as fh:
            return cls(json.load(fh)["traceEvents"], kernels)

    def counter_of(self, e):
        """The port's launch counter of a kernel event, or None."""
        if e.get("cat") != "kernel":
            return None
        return self.kernels.get(kernel_base(e["name"]))

    def label(self, e):
        c = self.counter_of(e)
        if c is not None:
            return f"{K_OF.get(c, c)} {kernel_base(e['name'])}"
        return f"{e['cat']} {e['name'][:70]}"

    def idle_share(self):
        return 1.0 - self.busy_us / self.window_us if self.window_us else None

    def kernel_us(self, counter):
        """Summed device microseconds and launches of one counter's
        kernels."""
        evs = [e for e in self.dev if self.counter_of(e) == counter]
        return sum(float(e["dur"]) for e in evs), len(evs)

    def cat_us(self, cats):
        return sum(float(e["dur"]) for e in self.dev if e["cat"] in cats)

    def top_ops(self, top=10):
        """The ``top`` device operations by total time: ``[label, us, n]``."""
        by = {}
        for e in self.dev:
            t, c = by.get(self.label(e), (0.0, 0))
            by[self.label(e)] = (t + float(e["dur"]), c + 1)
        ops = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
        return [[k, t, c] for k, (t, c) in ops]

    def longest_gaps(self, top=10):
        """The ``top`` longest idle gaps: ``[host ops under it, us]``."""
        out = []
        for g, a, b in sorted(self.gaps, reverse=True)[:top]:
            over = {}
            for h in self.host:
                hs = float(h["ts"])
                ov = min(hs + float(h["dur"]), b) - max(hs, a)
                if ov > 0:
                    key = f"{h['cat']}:{h['name'][:60]}"
                    over[key] = over.get(key, 0.0) + ov
            names = [k for k, _ in sorted(over.items(),
                                          key=lambda kv: -kv[1])[:3]]
            out.append([f"at +{a - self.t0:.0f}us: "
                        + ("; ".join(names) or "no host op"), g])
        return out

    def spans(self, name):
        """The host annotation events named ``name``."""
        return [e for e in self.host
                if e["cat"] == "user_annotation" and e["name"] == name]

    def device_us_under(self, span):
        """Device busy microseconds of the operations launched inside one
        host span (matched by the launch's correlation id), or None when
        the trace carries no correlation ids."""
        s0 = float(span["ts"])
        s1 = s0 + float(span["dur"])
        corr = {h["args"]["correlation"] for h in self.host
                if h["cat"] in LAUNCH_CATS
                and "correlation" in h.get("args", {})
                and s0 <= float(h["ts"]) <= s1}
        if not corr:
            return None
        ivs = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in self.dev
               if e.get("args", {}).get("correlation") in corr]
        return _union(ivs)[0] if ivs else None
