"""dr_tpu_torch.obs (recorder, metrics, Chrome export) and the spans of
the port's relational ops, re-layout and ``drlog``, against dr_tpu.obs.

Both packages make the same calls on the same numpy-seeded data (8 CPU
ranks for the port) with tracing armed; the tests compare span names,
``relational.phase`` / ``redistribute.phase`` names and their order,
attribute keys, counter values, metrics snapshot shapes and Chrome-export
event shapes.  The JAX package's trace also holds the dispatch and
fault-site events of its ``spmd_guard`` and ``faults``, which the port
does not have yet, so its events are filtered by category.  They mirror
``tests/test_obs.py`` and ``tests/test_relational.py``'s
``test_relational_obs_spans``; the results of every op are compared
between the packages and between the port's traced and untraced runs,
bit for bit (float sums within the reference test's ``rtol=1e-5,
atol=1e-6``)."""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu import obs as jobs
from dr_tpu.parallel.runtime import Runtime as JRuntime
from dr_tpu.utils import env as jenv
from dr_tpu.utils.logging import Logger as JLogger
from dr_tpu_torch import obs as tobs
from dr_tpu_torch.parallel.redistribute import plan_moves
from dr_tpu_torch.parallel.runtime import Runtime as TRuntime
from dr_tpu_torch.utils import env as tenv
from dr_tpu_torch.utils.env import env_override
from dr_tpu_torch.utils.logging import Logger as TLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 8

_spec = importlib.util.spec_from_file_location(
    "trace_view", os.path.join(REPO, "tools", "trace_view.py"))
trace_view = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_view)


@pytest.fixture(autouse=True)
def _port_ranks():
    dt.init(["cpu"] * P)
    yield
    dt.final()


@pytest.fixture
def traced():
    """Arm both recorders for one test; leave both disarmed and clean."""
    for o in (jobs, tobs):
        o.arm(True)
        o.reset()
    yield
    for o in (jobs, tobs):
        o.arm(False)
        o.reset()


def _shape(evs):
    """(phase, name, category, attribute keys) of each event, in order."""
    return [(e["ph"], e["name"], e.get("cat", ""),
             tuple(sorted(e.get("args", {})))) for e in evs]


def _phases(evs, name):
    return [e["args"]["phase"] for e in evs if e["name"] == name]


def _pair(arr):
    return (dr_tpu.distributed_vector.from_array(arr),
            dt.distributed_vector.from_array(arr))


def _outs(n, dtype):
    return (dr_tpu.distributed_vector(n, dtype),
            dt.distributed_vector(n, dtype))


def _assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# ---------------------------------------------------------------------------
# the environment reads (dr_tpu/utils/env.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw", [None, "", " 7 ", "0", "-3", "1", "x1",
                                 "2.5", "1e3"])
def test_env_parsing_matches_reference(raw):
    var = "DR_GPU_TEST_ENV_VALUE"
    with env_override(**{var: raw}):
        for name in ("env_int", "env_float", "env_str", "env_flag",
                     "env_raw"):
            args = {"env_int": (5, 0), "env_float": (1.5,),
                    "env_str": ("d",)}.get(name, ())
            assert getattr(tenv, name)(var, *args) == \
                getattr(jenv, name)(var, *args), (name, raw)
    assert var not in os.environ


def test_env_override_restores_exactly():
    os.environ["DR_GPU_TEST_KEEP"] = "a"
    try:
        with env_override(DR_GPU_TEST_KEEP=None, DR_GPU_TEST_NEW="b"):
            assert "DR_GPU_TEST_KEEP" not in os.environ
            assert os.environ["DR_GPU_TEST_NEW"] == "b"
        assert os.environ["DR_GPU_TEST_KEEP"] == "a"
        assert "DR_GPU_TEST_NEW" not in os.environ
    finally:
        os.environ.pop("DR_GPU_TEST_KEEP", None)


# ---------------------------------------------------------------------------
# off is a true no-op (test_obs.py:58, :81)
# ---------------------------------------------------------------------------

def test_tracing_off_is_true_noop():
    assert not tobs.armed()
    e0, snap0 = tobs.events_recorded(), tobs.snapshot()
    rng = np.random.default_rng(1)
    k = dt.distributed_vector.from_array(
        rng.integers(0, 5, 64).astype(np.float32))
    v = dt.distributed_vector.from_array(
        rng.standard_normal(64).astype(np.float32))
    ok, ov = dt.distributed_vector(64), dt.distributed_vector(64)
    dt.groupby_aggregate(k, v, ok, ov)
    dt.histogram(v, dt.distributed_vector(4, np.int32), -2.0, 2.0)
    dt.redistribute(v, [64] + [0] * (P - 1))
    TLogger().debug("quiet {}", 1)
    tobs.count("t.off")
    assert tobs.events_recorded() == e0
    assert tobs.events() == []
    assert tobs.snapshot() == snap0  # no counter moved
    # the disarmed span is one shared object: no allocation per call
    assert tobs.span("x") is tobs.span("y")
    assert tobs.begin("x") == 0
    assert tobs.now() == 0


def test_span_ending_after_disarm_records_nothing():
    deltas = []
    for o in (jobs, tobs):
        o.arm(True)
        o.reset()
        sid = o.begin("straggler")
        with o.span("cm-straggler") as sp:
            o.arm(False)
            r0 = o.events_recorded()
        o.end(sid)
        deltas.append((o.events_recorded() - r0, o.events(),
                       type(sp).__name__))
        o.reset()
    assert deltas[0] == deltas[1] == (0, [], "Span")


# ---------------------------------------------------------------------------
# recording (test_obs.py:107, :164, :235)
# ---------------------------------------------------------------------------

def _nest(o):
    with o.span("outer", cat="t") as sp:
        assert o.current() == sp.sid
        with o.span("inner", cat="t"):
            o.event("tick", cat="t", k=1)
        sp.set(extra=2)
    sid = o.begin("cross", cat="t", a=1)
    o.end(sid, b=2)
    o.complete("done", o.now(), cat="t", parent=sid, c=3)
    o.flow(sid, "s")
    o.flow(sid, "f")
    return o.events()


def test_span_nesting_and_events(traced):
    want, got = _nest(jobs), _nest(tobs)
    assert _shape(got) == _shape(want)
    outer = next(e for e in got if e["name"] == "outer")
    inner = next(e for e in got if e["name"] == "inner")
    assert inner["args"]["parent"] == outer["id"]
    assert outer["args"]["extra"] == 2
    tick = next(e for e in got if e["name"] == "tick")
    assert tick["ph"] == "i" and tick["args"]["k"] == 1
    assert (outer["ts"] <= inner["ts"] and
            inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])
    cross = next(e for e in got if e["name"] == "cross")
    assert cross["args"] == {"a": 1, "b": 2}
    done = next(e for e in got if e["name"] == "done")
    assert done["args"] == {"c": 3, "parent": cross["id"]}
    assert [e["bp"] for e in got if e["ph"] == "f"] == ["e"]


def test_log_debug_mirrors_into_trace(traced):
    JLogger().debug("hello {}", 41 + 1)
    TLogger().debug("hello {}", 41 + 1)
    hits = [[e for e in o.events() if e["name"] == "log.debug"]
            for o in (jobs, tobs)]
    assert _shape(hits[1]) == _shape(hits[0])
    assert hits[1][0]["args"]["msg"] == hits[0][0]["args"]["msg"] \
        == "hello 42"
    assert hits[1][0]["args"]["loc"].startswith("test_torch_obs.py:")
    TLogger().debug("x" * 300)
    assert len(tobs.events()[-1]["args"]["msg"]) == 200


def test_ring_buffer_caps_memory():
    tails = []
    with env_override(DR_TPU_TRACE_BUF="128", DR_GPU_TRACE_BUF="128"):
        for o in (jobs, tobs):
            o.arm(True)  # re-reads the cap
            try:
                o.reset()
                r0 = o.events_recorded()
                for i in range(1000):
                    o.event("spin", i=i)
                evs = o.events()
                tails.append((o.events_recorded() - r0, len(evs),
                              evs[-1]["args"]["i"],
                              o.tail(5)[-1]["args"]["i"], o.size()))
            finally:
                o.arm(False)
                o.reset()
    assert tails[0] == tails[1] == (1000, 128, 999, 999, 128)
    with env_override(DR_TPU_TRACE_BUF=None, DR_GPU_TRACE_BUF="7"):
        tobs.arm(True)  # floor 16
        tobs.arm(False)
    assert tobs.recorder._ring.maxlen == 16
    for o in (jobs, tobs):  # back to the default cap
        o.arm(True)
        o.arm(False)
    assert tobs.recorder._ring.maxlen == 65536


def test_trace_tail_default_and_env(traced):
    for i in range(60):
        tobs.event("e", i=i)
    assert len(tobs.tail()) == 40
    with env_override(DR_GPU_TRACE_TAIL="7", DR_TPU_TRACE_TAIL="3"):
        assert [e["args"]["i"] for e in tobs.tail()] == list(range(53, 60))


# ---------------------------------------------------------------------------
# metrics (test_obs.py:361)
# ---------------------------------------------------------------------------

def _fill_metrics(om):
    om.counter("t.c").add(3)
    om.gauge("t.g").set(1.5)
    h = om.histogram("t.h")
    for v in (0.02, 0.2, 2.0, 20.0, 200.0, 9000.0):
        h.observe(v)
    return h


def test_metrics_registry_shapes(traced):
    hj, ht = _fill_metrics(jobs.metrics), _fill_metrics(tobs.metrics)

    def mine(snap):  # other tests of the process register metrics too
        return {sec: {k: v for k, v in d.items() if k.startswith("t.")}
                for sec, d in snap.items()}

    snap = tobs.metrics.snapshot()
    assert mine(snap) == mine(jobs.metrics.snapshot())
    hs = snap["histograms"]["t.h"]
    assert hs["count"] == 6 and hs["min"] == 0.02 and hs["max"] == 9000.0
    assert sum(hs["buckets"].values()) == 6 and hs["buckets"]["le_inf"] == 1
    assert hs["p50"] == 2.0  # the reservoir's round(0.5 * 5)-th sample
    assert tobs.metrics.DEFAULT_BUCKETS == jobs.metrics.DEFAULT_BUCKETS
    # the compact snapshot: the JAX one's keys less spmd_guard's two
    full = tobs.snapshot()
    assert set(jobs.snapshot()) - set(full) == {"dispatches", "compiles"}
    assert full["trace_armed"] and full["events_buffered"] == tobs.size()
    # the armed-gated conveniences
    tobs.count("t.c", 2)
    tobs.gauge_set("t.g", 4.0)
    tobs.observe("t.h", 1.0)
    snap = tobs.snapshot()
    assert snap["counters"]["t.c"] == 5 and snap["gauges"]["t.g"] == 4.0
    # reset zeroes in place without orphaning held handles
    tobs.reset()
    ht.observe(1.0)
    assert tobs.snapshot()["histograms"]["t.h"]["count"] == 1
    assert hj.count == 6


# ---------------------------------------------------------------------------
# Chrome export and tools/trace_view.py (test_obs.py:385, :414, :420)
# ---------------------------------------------------------------------------

def _traced_calls(m, o, k, v, outs, log):
    """A groupby, a re-layout, a debug line and a span, traced."""
    m.groupby_aggregate(k, v, *outs)
    m.redistribute(v, None)
    log.debug("exported {}", 1)
    with o.span("user", cat="t", x=1):
        o.event("mark", cat="t")


def test_chrome_export_and_trace_view_smoke(traced, tmp_path, capsys):
    rng = np.random.default_rng(5)
    k = _pair(rng.integers(0, 6, 48).astype(np.float32))
    v = _pair(rng.standard_normal(48).astype(np.float32))
    outs = _outs(48, np.float32), _outs(48, np.float32)
    docs = []
    for i, (m, o, lg) in enumerate(((dr_tpu, jobs, JLogger()),
                                    (dt, tobs, TLogger()))):
        _traced_calls(m, o, k[i], v[i], (outs[0][i], outs[1][i]), lg)
        docs.append(o.chrome_trace())
    cats = ("relational", "redistribute", "log", "t")
    want = [e for e in docs[0]["traceEvents"] if e.get("cat") in cats]
    path = tobs.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    evs = doc["traceEvents"]
    got = [e for e in evs if e.get("cat") in cats]
    assert _shape(got) == _shape(want)
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    meta = [e for e in evs if e["ph"] == "M"]
    assert meta and {e["name"] for e in meta} == {"thread_name"}
    assert all(sorted(e) == ["args", "name", "ph", "pid", "tid"]
               for e in meta)
    assert len(evs) - len(meta) == tobs.size()
    assert all(e["pid"] == os.getpid() for e in evs)
    assert doc["otherData"]["producer"] == "dr_tpu_torch.obs"
    assert sorted(doc) == sorted(docs[0])
    assert not list(tmp_path.glob(".trace-*"))  # the temporary is gone
    assert trace_view.main([path]) == 0
    out = capsys.readouterr().out
    assert "spans by self-time" in out and "relational.groupby" in out
    assert "events by site" in out


def test_trace_view_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert trace_view.main([str(bad)]) == 2


def test_trace_dir_env(tmp_path, traced):
    mine, theirs = tmp_path / "gpu", tmp_path / "tpu"
    mine.mkdir()
    theirs.mkdir()
    with env_override(DR_GPU_TRACE_DIR=str(mine),
                      DR_TPU_TRACE_DIR=str(theirs)):
        tobs.event("x")
        path = tobs.export_chrome_trace()
    assert os.path.dirname(path) == str(mine) and os.path.exists(path)
    assert not list(theirs.iterdir())


def test_install_arms_only_from_its_own_variable():
    with env_override(DR_TPU_TRACE="1", DR_GPU_TRACE=None):
        assert tobs.install() is False and not tobs.armed()


# ---------------------------------------------------------------------------
# re-layout spans and the bytes counter (test_obs.py:449-469)
# ---------------------------------------------------------------------------

def _redistribute_trace(m, o, v, dist, **kw):
    o.reset()
    m.redistribute(v, dist, **kw)
    evs = [e for e in o.events() if e.get("cat") == "redistribute"]
    return evs, o.metrics.counter("redistribute.bytes_moved").value


@pytest.mark.parametrize("dist", [lambda n: [n] + [0] * (P - 1),
                                  lambda n: [3, 0, 5, 9, 1, 0, n - 18, 0],
                                  lambda n: None],
                         ids=["rank0", "uneven", "even"])
def test_redistribute_span_phases_and_bytes_counter(traced, dist):
    n = 4 * P + 3
    src = np.arange(n, dtype=np.float32)
    vj, vt = _pair(src)
    if dist(n) is None:  # start from rank 0 so the even layout moves
        for m, v in ((dr_tpu, vj), (dt, vt)):
            m.redistribute(v, [n] + [0] * (P - 1))
    layout0 = vt.layout
    ej, bj = _redistribute_trace(dr_tpu, jobs, vj, dist(n))
    et, bt = _redistribute_trace(dt, tobs, vt, dist(n))
    assert _shape(et) == _shape(ej)
    assert _phases(et, "redistribute.phase") == ["plan", "exchange",
                                                 "rebind"]
    span = next(e for e in et if e["name"] == "redistribute")
    assert span["args"]["impl"] == "collective"
    assert span["args"]["n"] == n and span["args"]["nshards"] == P
    _, moved = plan_moves(layout0, vt.layout)
    assert bt == bj == moved * 4 and moved > 0
    np.testing.assert_array_equal(np.concatenate(
        [r.numpy() for r in vt.rows]), np.asarray(vj._data))


def test_redistribute_host_route_span(traced):
    src = np.arange(10, dtype=np.float32)
    vj, vt = _pair(src)
    small_j = JRuntime(mesh=Mesh(np.asarray(jax.devices()[1:3]), ("x",)))
    ej, bj = _redistribute_trace(dr_tpu, jobs, vj, [4, 6], runtime=small_j)
    et, bt = _redistribute_trace(dt, tobs, vt, [4, 6],
                                 runtime=TRuntime(["cpu"] * 2))
    assert _shape(et) == _shape(ej)
    assert [e["args"].get("impl") for e in et
            if e["name"] == "redistribute"] == ["host"]
    assert _phases(et, "redistribute.phase") == ["host_staged"]
    assert bt == bj == 0  # the host-staged route counts no bytes
    np.testing.assert_array_equal(dt.to_numpy(vt), src)


# ---------------------------------------------------------------------------
# relational spans (test_relational.py:700-730)
# ---------------------------------------------------------------------------

def _relational_calls(m, ins, outs):
    kv, vv = ins
    ok, ov, jk, jl, jr, hb, tv, ti = outs
    ng = m.groupby_aggregate(kv, vv, ok, ov)
    rows = m.join(kv, vv, kv, vv, jk, jl, jr)
    m.histogram(vv, hb, -2.0, 2.0)
    m.top_k(vv, tv, ti)
    return int(ng), int(rows)


def _relational_outs():
    return [_outs(32, np.float32), _outs(32, np.float32),
            _outs(256, np.float32), _outs(256, np.float32),
            _outs(256, np.float32), _outs(4, np.int32),
            _outs(3, np.float32), _outs(3, np.int32)]


def _rel_inputs(seed=26, n=32, hi=5):
    rng = np.random.default_rng(seed)
    return (_pair(rng.integers(0, hi, n).astype(np.float32)),
            _pair(rng.standard_normal(n).astype(np.float32)))


def test_relational_obs_spans(traced):
    kv, vv = _rel_inputs()
    outs = _relational_outs()
    res, evs = [], []
    for i, (m, o) in enumerate(((dr_tpu, jobs), (dt, tobs))):
        o.reset()
        res.append(_relational_calls(m, (kv[i], vv[i]),
                                     [x[i] for x in outs]))
        evs.append([e for e in o.events() if e.get("cat") == "relational"])
    assert res[0] == res[1]
    for x in outs:
        if x is outs[1]:  # the groupby's float sums
            np.testing.assert_allclose(dt.to_numpy(x[1]),
                                       dr_tpu.to_numpy(x[0]),
                                       rtol=1e-5, atol=1e-6)
        else:
            _assert_bits(dt.to_numpy(x[1]), dr_tpu.to_numpy(x[0]))
    assert _shape(evs[1]) == _shape(evs[0])
    names = {e["name"] for e in evs[1]}
    assert {"relational.groupby", "relational.join",
            "relational.histogram", "relational.top_k"} <= names
    phases = _phases(evs[1], "relational.phase")
    assert phases == _phases(evs[0], "relational.phase")
    assert phases == ["sort", "aggregate", "sort_left", "sort_right",
                      "merge"]
    # each phase hangs under its op's span, and the span carries results
    spans = {e["id"]: e for e in evs[1] if e["name"] != "relational.phase"}
    for e in evs[1]:
        if e["name"] == "relational.phase":
            assert e["args"]["parent"] in spans
    by = {e["name"]: e["args"] for e in spans.values()}
    assert by["relational.groupby"]["groups"] == res[1][0]
    assert by["relational.join"]["rows"] == res[1][1]
    merge = next(e for e in evs[1] if e["args"].get("phase") == "merge")
    assert merge["args"]["route"] == "broadcast"


def test_relational_spans_change_no_result():
    kv, vv = _rel_inputs(seed=27, n=40, hi=12)
    rows = []
    for armed in (False, True):
        tobs.arm(armed)
        try:
            outs = [x[1] for x in _relational_outs()]
            res = _relational_calls(dt, (kv[1], vv[1]), outs)
            a = dt.join_auto(kv[1], vv[1], kv[1], vv[1], how="outer")
            g = dt.groupby_auto(kv[1], vv[1], agg="mean")
        finally:
            tobs.arm(False)
            tobs.reset()
        rows.append((res, [dt.to_numpy(x) for x in outs],
                     a.count, a.arrays(), g.count, g.arrays()))
    off, on = rows
    assert off[0] == on[0] and off[2] == on[2] and off[4] == on[4]
    for a, b in zip(off[1] + off[3] + off[5], on[1] + on[3] + on[5]):
        _assert_bits(b, a)


@pytest.mark.parametrize("how", ["inner", "right", "outer"])
def test_join_partition_route_phases(traced, how):
    """Above the broadcast threshold (forced to 0) the merge takes the
    partition route in both packages: ``partition_plan`` before
    ``merge``."""
    rng = np.random.default_rng(28)
    lk = _pair(rng.integers(0, 40, 64).astype(np.int32))
    lv = _pair(rng.standard_normal(64).astype(np.float32))
    rk = _pair(rng.integers(20, 60, 48).astype(np.int32))
    rv = _pair(rng.standard_normal(48).astype(np.float32))
    outs = [_outs(512, np.int32), _outs(512, np.float32),
            _outs(512, np.float32)]
    res, evs = [], []
    with env_override(DR_TPU_JOIN_BROADCAST_MAX="0",
                      DR_GPU_JOIN_BROADCAST_MAX="0"):
        for i, (m, o) in enumerate(((dr_tpu, jobs), (dt, tobs))):
            o.reset()
            res.append(int(m.join(lk[i], lv[i], rk[i], rv[i],
                                  *[x[i] for x in outs], how=how,
                                  fill=-1.0)))
            evs.append([e for e in o.events()
                        if e.get("cat") == "relational"])
    assert res[0] == res[1]
    for x in outs:
        _assert_bits(dt.to_numpy(x[1]), dr_tpu.to_numpy(x[0]))
    assert _shape(evs[1]) == _shape(evs[0])
    assert _phases(evs[1], "relational.phase") == [
        "sort_left", "sort_right", "partition_plan", "merge"]
    join = next(e for e in evs[1] if e["name"] == "relational.join")
    assert join["args"]["how"] == ("left" if how == "right" else how)
    assert [e["args"]["route"] for e in evs[1]
            if e["args"].get("phase") == "merge"] == ["partition"]


def test_empty_join_and_auto_tier_spans(traced):
    """The empty join records its ``empty`` phase in both packages; the
    auto tier's spans carry ``auto=True`` and, in the port, a
    ``cap_probe`` phase every call (the JAX package skips the probe once
    a capacity hint is noted, so the probes are compared apart)."""
    rng = np.random.default_rng(29)
    k = _pair(rng.integers(0, 5, 24).astype(np.float32))
    v = _pair(rng.standard_normal(24).astype(np.float32))
    e0 = _pair(np.zeros(0, np.float32))
    outs = [_outs(8, np.float32) for _ in range(3)]
    evs = []
    for i, (m, o) in enumerate(((dr_tpu, jobs), (dt, tobs))):
        o.reset()
        assert int(m.join(k[i], v[i], e0[i], e0[i],
                          *[x[i] for x in outs])) == 0
        a = m.join_auto(k[i], v[i], k[i], v[i])
        g = m.groupby_auto(k[i], v[i])
        u = m.unique_auto(k[i])
        assert min(a.count, g.count, u.count) > 0
        evs.append([e for e in o.events() if e.get("cat") == "relational"])
    for x in outs:
        _assert_bits(dt.to_numpy(x[1]), dr_tpu.to_numpy(x[0]))
    probe = [e for e in evs[1] if e["args"].get("phase") == "cap_probe"]
    assert len(probe) == 3
    rest = [[e for e in ev if e["args"].get("phase") != "cap_probe"]
            for ev in evs]
    assert _shape(rest[1]) == _shape(rest[0])
    assert _phases(rest[1], "relational.phase") == [
        "empty", "sort_left", "sort_right", "merge", "sort", "aggregate",
        "sort", "aggregate"]
    autos = [e for e in evs[1] if e["name"] != "relational.phase"
             and e["args"].get("auto")]
    assert [e["name"] for e in autos] == ["relational.join",
                                          "relational.groupby",
                                          "relational.groupby"]
