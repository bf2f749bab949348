"""``dr_tpu_torch.obs``: tracing and metrics (counterpart of
``dr_tpu/obs``).

* **spans and events** (``recorder``): a thread-aware span recorder over
  a bounded ring, armed by ``DR_GPU_TRACE=1`` or :func:`arm`.  The
  relational ops (``relational.join`` / ``groupby`` / ``histogram`` /
  ``top_k`` with their ``relational.phase`` children), the re-layout
  (``redistribute`` with its ``redistribute.phase`` children) and the
  ``drlog`` debug lines record into it.  Timestamps are the host's
  clock: device time comes from ``dr_tpu_torch.utils.profiling``.
* **metrics** (``metrics``): counters, gauges, bucketed histograms.
  Handles always record; :func:`count` / :func:`gauge_set` /
  :func:`observe` here are armed-gated.
* **exporters** (``export``): Chrome trace-event JSON into
  ``DR_GPU_TRACE_DIR`` (written at process exit when armed from the
  environment) and the compact :func:`snapshot`.

With tracing off every entry point is one check of a module global and
allocates nothing per event (``recorder.events_recorded`` does not
move).
"""

from __future__ import annotations

from . import export, metrics, recorder
from .export import chrome_trace, metrics_snapshot, trace_dir, write
from .recorder import (arm, armed, begin, complete, current, end, event,
                       events, events_recorded, flow, install, now,
                       reset as _reset_ring, size, span, tail)

__all__ = ["arm", "armed", "begin", "complete", "count", "current",
           "end", "event", "events", "events_recorded", "export",
           "export_chrome_trace", "flow", "gauge_set", "install",
           "metrics", "now", "observe", "recorder", "reset", "size",
           "snapshot", "span", "tail", "trace_dir", "chrome_trace",
           "metrics_snapshot", "write"]


# ------------------------------------------------------- armed-gated metrics

def count(name: str, n: int = 1) -> None:
    """Armed-gated counter bump (one check when tracing is off)."""
    if recorder._armed:
        metrics.counter(name).add(n)


def gauge_set(name: str, v: float) -> None:
    if recorder._armed:
        metrics.gauge(name).set(v)


def observe(name: str, v: float) -> None:
    """Armed-gated histogram observation."""
    if recorder._armed:
        metrics.histogram(name).observe(v)


def snapshot() -> dict:
    """The compact observability snapshot: the metrics registry and the
    trace ring's accounting."""
    return export.metrics_snapshot()


def export_chrome_trace(path=None) -> str:
    """Write the Chrome trace JSON (default into :func:`trace_dir`);
    returns the path written."""
    return export.write(path)


def reset() -> None:
    """Clear the trace ring and the metrics registry (tests)."""
    _reset_ring()
    metrics.reset()
