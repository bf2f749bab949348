"""Exporters: Chrome trace-event JSON and the compact metrics snapshot
(counterpart of ``dr_tpu/obs/export.py``).

The trace file is the Chrome ``traceEvents`` object format (open it in
``chrome://tracing`` or https://ui.perfetto.dev, or summarize it with
``tools/trace_view.py``).  Recorded events are already one dict per
Chrome event, so export adds the shared ``pid`` and the thread-name
metadata events.

:func:`metrics_snapshot` is the metrics registry plus the recorder's
ring accounting.  The JAX package's snapshot also carries ``dispatches``
and ``compiles`` from ``spmd_guard``; those two keys come with the
port's ``spmd_guard`` and are not in this snapshot.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import List, Optional

from ..utils.env import env_str
from . import metrics, recorder

__all__ = ["trace_dir", "chrome_trace", "write", "metrics_snapshot"]


def trace_dir() -> str:
    """``DR_GPU_TRACE_DIR``, or the system temp dir."""
    return env_str("DR_GPU_TRACE_DIR") or tempfile.gettempdir()


def chrome_trace(events: Optional[List[dict]] = None) -> dict:
    """Render recorded events as a Chrome ``traceEvents`` object."""
    if events is None:
        events = recorder.events()
    pid = os.getpid()
    out = []
    for tid, name in sorted(recorder.thread_names().items()):
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": name}})
    for ev in events:
        e = dict(ev)
        e["pid"] = pid
        out.append(e)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"producer": "dr_tpu_torch.obs",
                          "events_recorded": recorder.events_recorded()}}


def write(path: Optional[str] = None,
          events: Optional[List[dict]] = None) -> str:
    """Write the Chrome trace JSON; the default path is
    ``<trace_dir>/dr_tpu_torch_trace_<pid>.json``.  The file appears
    whole or not at all: it is written to a temporary file in the same
    directory and renamed over ``path``.  Returns the path."""
    if path is None:
        path = os.path.join(trace_dir(),
                            f"dr_tpu_torch_trace_{os.getpid()}.json")
    doc = chrome_trace(events)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               prefix=".trace-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
            fh.write("\n")
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def metrics_snapshot() -> dict:
    """The compact observability snapshot: the metrics registry and the
    ring accounting."""
    snap = metrics.snapshot()
    snap["trace_armed"] = recorder.armed()
    if recorder.armed():
        snap["events_recorded"] = recorder.events_recorded()
        snap["events_buffered"] = recorder.size()
    return snap
