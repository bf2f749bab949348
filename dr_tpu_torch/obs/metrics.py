"""Metrics registry: counters, gauges and bucketed histograms
(counterpart of ``dr_tpu/obs/metrics.py``).

Handles (:func:`counter` / :func:`gauge` / :func:`histogram`) always
record, whether tracing is armed or not; the armed-gated conveniences
(``count`` / ``gauge_set`` / ``observe``) live in ``dr_tpu_torch.obs``.
:func:`snapshot` renders the registry as a compact JSON-serializable
dict: histograms give count, sum, min, max, the non-empty log-spaced
bucket counts and p50 / p95 / p99 from a bounded reservoir of recent
samples.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge",
           "histogram", "snapshot", "reset", "DEFAULT_BUCKETS"]

#: log-spaced bucket upper bounds (unit-agnostic); an implicit +inf
#: bucket catches the rest
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0,
    1000.0, 5000.0)

#: bounded per-histogram sample reservoir for percentile estimates
_RESERVOIR = 512


class Counter:
    """A counter with a locked add: ``value += n`` is a read-add-store
    that can drop increments across threads."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        # a plain store is atomic under the GIL
        self.value = float(v)


class Histogram:
    """Bucketed histogram plus a bounded reservoir of recent samples."""

    __slots__ = ("name", "bounds", "bucket_counts", "count", "total",
                 "vmin", "vmax", "_samples", "_lock")

    def __init__(self, name: str, buckets: Optional[Tuple[float, ...]]
                 = None):
        self.name = name
        self.bounds = tuple(buckets) if buckets else DEFAULT_BUCKETS
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self._samples: deque = deque(maxlen=_RESERVOIR)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if self.vmin is None or v < self.vmin:
                self.vmin = v
            if self.vmax is None or v > self.vmax:
                self.vmax = v
            i = 0
            for b in self.bounds:
                if v <= b:
                    break
                i += 1
            self.bucket_counts[i] += 1
            self._samples.append(v)

    def snapshot(self) -> dict:
        with self._lock:
            s = sorted(self._samples)
            out = {"count": self.count,
                   "sum": round(self.total, 6),
                   "min": (None if self.vmin is None
                           else round(self.vmin, 6)),
                   "max": (None if self.vmax is None
                           else round(self.vmax, 6)),
                   "buckets": {("le_%g" % b): c for b, c in
                               zip(self.bounds, self.bucket_counts)
                               if c},
                   }
            if self.bucket_counts[-1]:
                out["buckets"]["le_inf"] = self.bucket_counts[-1]
        for p, q in (("p50", 50), ("p95", 95), ("p99", 99)):
            out[p] = (round(s[min(len(s) - 1,
                                  int(round(q / 100.0 * (len(s) - 1))))],
                            6) if s else None)
        return out


_lock = threading.Lock()
_counters: Dict[str, Counter] = {}
_gauges: Dict[str, Gauge] = {}
_hists: Dict[str, Histogram] = {}


def counter(name: str) -> Counter:
    c = _counters.get(name)
    if c is None:
        with _lock:
            c = _counters.setdefault(name, Counter(name))
    return c


def gauge(name: str) -> Gauge:
    g = _gauges.get(name)
    if g is None:
        with _lock:
            g = _gauges.setdefault(name, Gauge(name))
    return g


def histogram(name: str, buckets: Optional[Tuple[float, ...]] = None
              ) -> Histogram:
    h = _hists.get(name)
    if h is None:
        with _lock:
            h = _hists.setdefault(name, Histogram(name, buckets))
    return h


def snapshot() -> dict:
    """Compact JSON-serializable dump of the registry (empty sections
    are left out)."""
    out: dict = {}
    with _lock:
        cs = {n: c.value for n, c in _counters.items() if c.value}
        gs = {n: g.value for n, g in _gauges.items()}
        hs = list(_hists.values())
    if cs:
        out["counters"] = cs
    if gs:
        out["gauges"] = gs
    rendered = {h.name: h.snapshot() for h in hs if h.count}
    if rendered:
        out["histograms"] = rendered
    return out


def reset() -> None:
    """Zero every registered metric in place (tests).  Registrations are
    kept: a module may hold a handle, and dropping the entry would stop
    its numbers reaching snapshots."""
    with _lock:
        cs = list(_counters.values())
        for g in _gauges.values():
            g.value = 0.0
        hs = list(_hists.values())
    for c in cs:
        # under the counter's own lock, so a concurrent add is not lost
        # into the zeroed value
        with c._lock:
            c.value = 0
    for h in hs:
        with h._lock:
            h.bucket_counts = [0] * (len(h.bounds) + 1)
            h.count = 0
            h.total = 0.0
            h.vmin = h.vmax = None
            h._samples.clear()
