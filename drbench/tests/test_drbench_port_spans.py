"""The readers of the port's own spans (``drbench/metrics_spans.py`` and
its six metrics), on hand-built Chrome traces and on a trace of the port
itself."""

import json
import random
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from drbench import harness
from drbench.trace import TraceView

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["sync_idle_ms.stencil", "sync_idle_ms.tpch", "rowcopy_ms.stencil",
       "exchange_ms.stencil", "join_sort_ms.q3", "join_merge_ms.q3"]


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _launch(ts, corr):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr)


def _kernel(ts, dur, corr):
    return _ev("kernel", "void k(float*)", ts, dur, correlation=corr)


def _ctx(events, calls=1):
    return SimpleNamespace(trace=TraceView(events), traced_calls=calls)


def _read(metric, ctx):
    return harness.reader(ROOT, metric)(ctx)


def test_the_six_entries_resolve_to_readers():
    per = {m["name"]: m for m in MAN["per_layer"]}
    assert [m["name"] for m in MAN["per_layer"]][-len(NEW):] == NEW
    for name in NEW:
        m = per[name]
        assert (m["unit"], m["better"], m["source"]) == \
            ("ms", "lower", "device_trace")
        assert callable(harness.reader(ROOT, name))
        cells = {w["name"] for w in MAN["workloads"]}
        assert set(m["workloads"]) <= cells


def test_a_gap_counts_where_it_begins_inside_a_sync_range():
    events = [
        _ev("user_annotation", "drbench.dot", 0, 60),
        _ev("user_annotation", "sync.dot", 20, 30),
        _kernel(0, 25, 1), _launch(1, 1),
        # idle 25-40: begins inside sync.dot (20-50)
        _kernel(40, 10, 2), _launch(39, 2),
        # idle 50-70: begins at sync.dot's end, still inside
        _kernel(70, 10, 3), _launch(69, 3),
        # idle 80-100: begins outside any sync range
        _kernel(100, 10, 4), _launch(99, 4),
    ]
    ctx = _ctx(events)
    assert _read("sync_idle_ms.stencil", ctx) == pytest.approx(35 / 1e3)
    assert _read("sync_idle_ms.tpch", _ctx(events, calls=5)) == \
        pytest.approx(7 / 1e3)


@pytest.mark.parametrize("seed", range(8))
def test_sync_idle_never_exceeds_the_idle_time(seed):
    rng = random.Random(seed)
    events, t = [], 0.0
    for i in range(40):
        t += rng.uniform(0, 30)
        dur = rng.uniform(1, 20)
        events.append(_kernel(t, dur, i))
        t += dur
    for _ in range(15):  # overlapping and nested sync ranges
        a = rng.uniform(0, t)
        events.append(_ev("user_annotation",
                          rng.choice(["sync.dot", "sync.count"]), a,
                          rng.uniform(0, 60)))
    calls = rng.randint(1, 4)
    ctx = _ctx(events, calls)
    idle_ms = sum(g for g, _, _ in ctx.trace.gaps) / calls / 1e3
    got = _read("sync_idle_ms.tpch", ctx)
    assert 0 <= got <= idle_ms + 1e-12


def test_nested_rows_copy_counts_once():
    events = [
        _ev("user_annotation", "drbench.stencil_iterate", 0, 100),
        _ev("user_annotation", "rows.copy", 10, 50),
        _ev("user_annotation", "rows.copy", 20, 10),   # nested in the first
        _launch(12, 1), _launch(22, 2), _launch(70, 3),
        _kernel(30, 10, 1), _kernel(35, 10, 2),        # overlap 35-40
        _kernel(80, 7, 3),                             # outside rows.copy
        _ev("gpu_memcpy", "Memcpy DtoD", 50, 4, correlation=1),
    ]
    ctx = _ctx(events, calls=2)
    # [30, 45] and [50, 54] under rows.copy; the kernel at 80 is not
    assert _read("rowcopy_ms.stencil", ctx) == pytest.approx(19 / 2 / 1e3)
    # the benchmark's own span still holds everything
    span, = ctx.trace.spans("drbench.stencil_iterate")
    assert ctx.trace.device_us_under(span) == 26.0


def test_join_phases_split_sort_and_merge():
    events = [
        _ev("user_annotation", "drbench.join", 0, 300),
        _ev("user_annotation", "relational.join", 0, 290),
        _ev("user_annotation", "relational.join.sort_left", 0, 50),
        _ev("user_annotation", "relational.join.sort_right", 60, 40),
        _ev("user_annotation", "relational.join.partition_plan", 110, 20),
        _ev("user_annotation", "relational.join.merge", 140, 100),
        _ev("user_annotation", "sync.count", 230, 10),
        _launch(5, 1), _launch(65, 2), _launch(115, 3), _launch(150, 4),
        _launch(235, 5), _launch(295, 6),
        _kernel(10, 30, 1), _kernel(70, 20, 2), _kernel(120, 5, 3),
        _kernel(160, 40, 4), _kernel(236, 1, 5), _kernel(296, 2, 6),
    ]
    ctx = _ctx(events)
    assert _read("join_sort_ms.q3", ctx) == pytest.approx(50 / 1e3)
    assert _read("join_merge_ms.q3", ctx) == pytest.approx(46 / 1e3)
    assert _read("exchange_ms.stencil", _ctx(events + [
        _ev("user_annotation", "halo.exchange", 294, 3)])) == \
        pytest.approx(2 / 1e3)


@pytest.mark.parametrize("metric", NEW)
def test_port_ranges_without_the_metrics_raise(metric):
    other = "relational.top_k" if metric.startswith("sync_idle") \
        else "sync.other"
    events = [_ev("user_annotation", "drbench.x", 0, 50),
              _ev("user_annotation", other, 0, 50),
              _launch(1, 1), _kernel(2, 5, 1), _kernel(20, 5, 2)]
    with pytest.raises(ValueError, match=metric.split(".")[0]):
        _read(metric, _ctx(events))


@pytest.mark.parametrize("metric", NEW)
def test_a_trace_without_port_ranges_or_device_reads_none(metric):
    # a program without the spans (the benchmark's own ranges only)
    plain = [_ev("user_annotation", "drbench.x", 0, 50), _launch(1, 1),
             _kernel(2, 5, 1), _kernel(20, 5, 2)]
    assert _read(metric, _ctx(plain)) is None
    # a run on the CPU: the port's ranges, no device events
    cpu = [_ev("user_annotation", "sync.dot", 0, 5),
           _ev("user_annotation", "rows.copy", 0, 5)]
    assert _read(metric, _ctx(cpu)) is None
    assert _read(metric, SimpleNamespace(trace=None, traced_calls=1)) \
        is None


def test_a_family_names_range_prefixes_of_its_own(monkeypatch):
    """A family's ``SPANS`` make its ranges the port's: the shared
    readers read under them, where without the family they read None."""
    from drbench import metrics_spans
    events = [_ev("user_annotation", "drbench.sort", 0, 100),
              _ev("user_annotation", "sort.merge", 10, 40),
              _ev("user_annotation", "sync.sort.count", 60, 10),
              _launch(12, 1), _kernel(20, 25, 1),
              _launch(61, 2), _kernel(62, 3, 2), _kernel(90, 5, 3)]
    stencil = SimpleNamespace(trace=TraceView(events), traced_calls=1,
                              config={"kind": "stencil1d"})
    assert metrics_spans.prefixes(stencil) == metrics_spans.PORT
    with pytest.raises(ValueError):
        metrics_spans.device_ms(stencil, lambda n: n == "sort.merge", "x")
    monkeypatch.setattr(harness, "family",
                        lambda root, kind: SimpleNamespace(SPANS=("sort.",)))
    ctx = SimpleNamespace(trace=TraceView(events), traced_calls=1,
                          config={"kind": "sort"})
    assert metrics_spans.prefixes(ctx) == metrics_spans.PORT + ("sort.",)
    assert metrics_spans.device_ms(ctx, lambda n: n == "sort.merge",
                                   "x") == pytest.approx(25 / 1e3)
    assert metrics_spans.sync_idle_ms(ctx) == pytest.approx(25 / 1e3)


def test_the_port_records_every_range_the_readers_name(tmp_path):
    """A profiler trace of the port's own calls on the CPU carries the
    ranges each reader names (one stand-in device event makes it read)."""
    import dr_tpu_torch as dt
    from torch.profiler import ProfilerActivity, profile, record_function
    dt.init(["cpu"] * 2)
    try:
        rng = np.random.default_rng(5)
        w = (0.05, 0.25, 0.4, 0.25, 0.05)
        hb = dt.halo_bounds(1024, 1024, periodic=True)
        a = dt.distributed_vector.from_array(
            rng.standard_normal(4096).astype(np.float32), halo=hb)
        b = dt.distributed_vector(4096, np.float32, hb)
        k = dt.distributed_vector.from_array(
            rng.integers(0, 20, 64).astype(np.int32))
        v = dt.distributed_vector.from_array(
            rng.standard_normal(64).astype(np.float32))
        rk = dt.distributed_vector.from_array(np.arange(20, dtype=np.int32))
        rv = dt.distributed_vector.from_array(np.ones(20, np.float32))
        outs = [dt.distributed_vector(64, t)
                for t in (np.int32, np.float32, np.float32)]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for op in ("stencil", "join"):
                with record_function("drbench." + op):
                    if op == "stencil":
                        dt.stencil_iterate(a, b, w, 1)
                        dt.stencil_iterate_blocked(a, w, 4, time_block=4)
                        dt.dot(a, a)
                    else:
                        dt.join(k, v, rk, rv, *outs)
        path = tmp_path / "t.json"
        prof.export_chrome_trace(str(path))
    finally:
        dt.final()
    events = json.loads(path.read_text())["traceEvents"]
    ctx = _ctx(events + [_kernel(0, 1, -1)])
    for metric in NEW:
        assert _read(metric, ctx) is not None, metric
