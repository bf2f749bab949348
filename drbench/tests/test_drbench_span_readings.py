"""The per-layer readers on recorded traces: each reads exactly what it
read when the trace was recorded.

``traces/<cell>.json`` holds one traced CPU run of the cell at its tiny
size through the harness (``record``): the profiler's ranges as they
were, and a stand-in device (each host op launches one kernel over its
own interval, so the readers have device work under the port's ranges),
with the value each of the cell's per-layer readers gave on it, read by
the readers of the tree that recorded it.  A change to the readers'
shared code that should read the same must read bit for bit the same.
"""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from drbench import harness
from drbench.tests.conftest import SEED, TINY
from drbench.trace import TraceView

ROOT = Path(__file__).resolve().parents[2]
TRACES = Path(__file__).resolve().parent / "traces"
MAN = harness.manifest(ROOT)


def record(cell):
    """One traced CPU run of ``cell``: ``{"annotations": [[name, ts,
    dur]], "ops": [[ts, dur]]}``, the profiler's ranges and the host ops
    that no other op holds, in microseconds from the first."""
    from drbench import trace
    w, _ = harness.cell(MAN, cell)
    events = []
    load = trace.TraceView.load

    def keep(path, kernels=None):
        with open(path, encoding="utf-8") as fh:
            events.extend(json.load(fh)["traceEvents"])
        return load(path, kernels)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace.TraceView, "load", keep)
        harness.run(cell, SEED, 0.2, True, time.perf_counter(),
                    device="cpu", config_override=TINY[w["config"]])
    spans = [e for e in events if "dur" in e
             and e.get("cat") in ("user_annotation", "cpu_op")]
    t0 = min(float(e["ts"]) for e in spans)
    ops, end = [], None
    for ts, dur in sorted((float(e["ts"]), float(e["dur"])) for e in spans
                          if e["cat"] == "cpu_op"):
        if end is None or ts + dur > end:
            ops.append([round(ts - t0, 3), dur])
            end = ts + dur if end is None else max(end, ts + dur)
    return {"annotations": [[e["name"], round(float(e["ts"]) - t0, 3),
                             float(e["dur"])] for e in spans
                            if e["cat"] == "user_annotation"],
            "ops": ops}


def view(rec):
    """The recorded ranges with one launch and one kernel a host op."""
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts,
               "dur": dur, "args": {}} for n, ts, dur in rec["annotations"]]
    for i, (ts, dur) in enumerate(rec["ops"]):
        events += [{"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "ts": ts, "dur": 0,
                    "args": {"correlation": i}},
                   {"ph": "X", "cat": "kernel", "name": "k", "ts": ts,
                    "dur": dur, "args": {"correlation": i}}]
    return TraceView(events, harness.port_kernels())


def readings(cell, rec):
    """What each of the cell's per-layer readers reads on ``rec``."""
    w, cfg_entry = harness.cell(MAN, cell)
    tr = harness.traffic(ROOT, w["traffic"])
    ctx = SimpleNamespace(
        config=dict(harness.config(ROOT, cfg_entry), **TINY[w["config"]]),
        traffic=tr, trace=view(rec), traced_calls=tr["trace_calls"])
    return {m["name"]: harness.reader(ROOT, m["name"])(ctx)
            for m in harness.metrics_of(MAN, cell, True)}


@pytest.mark.parametrize("cell", sorted(p.stem for p in
                                        TRACES.glob("*.json")))
def test_readers_read_as_recorded(cell):
    rec = json.loads((TRACES / f"{cell}.json").read_text())
    assert readings(cell, rec) == rec["readings"]


def test_every_span_reader_reads_a_recorded_trace():
    """The recordings give every reader of the port's spans something to
    read, so the comparison above is not of None with None."""
    read = {}
    for p in TRACES.glob("*.json"):
        for name, v in json.loads(p.read_text())["readings"].items():
            if v is not None:
                read.setdefault(name, []).append(p.stem)
    for m in ("sync_idle_ms.stencil", "sync_idle_ms.tpch",
              "rowcopy_ms.stencil", "exchange_ms.stencil",
              "join_sort_ms.q3", "join_merge_ms.q3"):
        assert m in read, m


@pytest.mark.parametrize("cell", sorted(p.stem for p in
                                        TRACES.glob("*.json")))
def test_a_fresh_recording_reads_where_the_stored_one_does(cell):
    """The port as it is still opens the ranges the stored recording
    gives each reader: a reader that read a number there reads one on a
    fresh recording, and one that read None reads None."""
    stored = json.loads((TRACES / f"{cell}.json").read_text())["readings"]
    fresh = readings(cell, record(cell))
    assert {k: v is None for k, v in fresh.items()} == \
        {k: v is None for k, v in stored.items()}
