"""dr_tpu_torch.obs (recorder, metrics, Chrome export) and the spans of
the port's relational ops, re-layout and ``drlog``, against dr_tpu.obs.

Both packages make the same calls on the same numpy-seeded data (8 CPU
ranks for the port) with tracing armed; the tests compare span names,
``relational.phase`` / ``redistribute.phase`` names and their order,
attribute keys, counter values, metrics snapshot shapes and Chrome-export
event shapes.  Both traces also hold the dispatch, compile and
fault-site events of ``spmd_guard`` and ``faults``; the span tests filter
by category (the two packages dispatch at different granularity below an
op), and the tap, fault and retry tests compare those events.  They mirror
``tests/test_obs.py`` and ``tests/test_relational.py``'s
``test_relational_obs_spans``; the results of every op are compared
between the packages and between the port's traced and untraced runs,
bit for bit (float sums within the reference test's ``rtol=1e-5,
atol=1e-6``)."""

import importlib.util
import json
import os
import threading

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
from dr_tpu.utils import faults as jfaults
from dr_tpu.utils import resilience as jres
from dr_tpu.utils import spmd_guard as jguard
from dr_tpu_torch import obs as tobs
from dr_tpu_torch.utils import faults as tfaults
from dr_tpu_torch.utils import resilience as tres
from dr_tpu_torch.utils import spmd_guard as tguard
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
    from dr_tpu_torch.utils import faults as tfaults
    from dr_tpu_torch.utils import spmd_guard as tguard
    assert not tobs.armed()
    # the hot-path hooks are None (one `is not None` a dispatch)
    assert tguard._obs_dispatch_hook is None
    assert tguard._obs_compile_hook is None
    assert tfaults._obs_site_hook is None
    assert tfaults._obs_fault_hook is None
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
    # the always-on dispatch counter moved (test_obs.py:70), no metric did
    snap = tobs.snapshot()
    assert snap.pop("dispatches") > snap0.pop("dispatches")
    snap.pop("compiles"), snap0.pop("compiles")
    assert snap == snap0
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


def test_off_classified_errors_carry_no_tail():
    assert tres.TransientBackendError("x", site="s").trace_tail is None
    assert jres.TransientBackendError("x", site="s").trace_tail is None


def _vec_pair(n=128):
    src = np.random.default_rng(12).standard_normal(n).astype(np.float32)
    return _pair(src)


def test_dispatch_and_compile_events_ride_the_tap(traced):
    """test_obs.py:128: every tapped dispatch is one ``dispatch`` event
    labelled by its key's tag, in both packages; a first insert is a
    ``compile`` event."""
    vj, vt = _vec_pair(128)
    grew = {}
    for m, o, g, v in ((dr_tpu, jobs, jguard, vj), (dt, tobs, tguard, vt)):
        o.reset()
        d0 = g.dispatch_count()
        float(m.reduce(v))
        grew[m.__name__] = g.dispatch_count() - d0
        evs = o.events()
        assert sum(1 for e in evs if e["name"] == "dispatch") == \
            grew[m.__name__] > 0
        labels = {e["args"]["key"] for e in evs if e["name"] == "dispatch"}
        assert all(len(lbl) < 100 for lbl in labels)
    assert "red" in labels
    tobs.reset()
    c0 = tguard.compile_count()
    dt.fill(dt.distributed_vector(4 * P + 1), 2.0)  # a layout seen nowhere
    new = tguard.compile_count() - c0
    assert new >= 2 and sum(1 for e in tobs.events()
                            if e["name"] == "compile") == new
    assert tobs.snapshot()["compiles"] == tguard.compile_count()
    assert {"dispatches", "compiles"} <= set(jobs.snapshot()) & \
        set(tobs.snapshot())


def test_injected_fault_appears_in_trace_with_site(traced):
    """test_obs.py:178: the fault event has the JAX package's args, and
    the classified error's trace tail holds it."""
    vj, vt = _vec_pair(64)
    got = {}
    for m, o, f, r, v in ((dr_tpu, jobs, jfaults, jres, vj),
                          (dt, tobs, tfaults, tres, vt)):
        o.reset()
        with f.injected("dispatch.cache", "transient"):
            with pytest.raises(r.TransientBackendError) as ei:
                m.fill(v, 2.0)
        hit = [e for e in o.events() if e["name"] == "fault"]
        got[m.__name__] = hit[0]["args"]
        tail = ei.value.trace_tail
        assert tail and any(e["name"] == "fault" for e in tail)
    assert got["dr_tpu_torch"] == got["dr_tpu"] == {
        "site": "dispatch.cache", "kind": "transient"}


def test_fault_spec_env_injection_traced(traced, monkeypatch):
    """test_obs.py:193, with ``DR_GPU_FAULT_SPEC``: the fault and the
    clean site visits are on the trace."""
    monkeypatch.setenv("DR_GPU_FAULT_SPEC", "halo.exchange:transient")
    tfaults.reload_env()
    try:
        v = dt.distributed_vector(64, np.float32,
                                  halo=dt.halo_bounds(1, 1, periodic=True))
        dt.fill(v, 1.0)
        with pytest.raises(tres.TransientBackendError):
            v.halo().exchange()
        v.halo().exchange()  # the spec fired once: a clean visit
    finally:
        monkeypatch.delenv("DR_GPU_FAULT_SPEC")
        tfaults.reload_env()
    evs = tobs.events()
    assert any(e["name"] == "fault" and e["args"]["site"] == "halo.exchange"
               for e in evs)
    assert sum(1 for e in evs if e["name"] == "halo.exchange"
               and e["cat"] == "site") == 2


def test_retry_events_and_counter(traced):
    """test_obs.py:213: the retry events and the counter, the same in
    both packages."""
    got = {}
    for o, r in ((jobs, jres), (tobs, tres)):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise r.TransientBackendError("UNAVAILABLE: x")
            return 7

        o.reset()
        assert r.retry(flaky, attempts=3, base=0.0,
                       sleep=lambda s: None) == 7
        got[o.__name__] = ([e["args"] for e in o.events()
                            if e["name"] == "retry"],
                           o.snapshot()["counters"]["resilience.retries"])
    retries, count = got["dr_tpu_torch.obs"]
    assert (retries, count) == got["dr_tpu.obs"]
    assert len(retries) == 2 and count == 2
    assert retries[0]["error"] == "TransientBackendError"


def test_retry_budget_denied_counter(traced):
    budget = tres.TokenBudget(0)
    with pytest.raises(tres.TransientBackendError):
        tres.retry(lambda: (_ for _ in ()).throw(
            RuntimeError("UNAVAILABLE: y")), attempts=3,
            sleep=lambda s: None, budget=budget)
    assert tobs.snapshot()["counters"]["resilience.retry_budget_denied"] \
        == 1


def test_with_deadline_dumps_obs_tail(traced, capsys):
    """test_obs.py:432: the deadline postmortem dumps the obs tail and the
    error carries it, ``deadline.expired`` included."""
    tobs.event("marker", k="tail-me")
    ev = threading.Event()
    with pytest.raises(tres.DeadlineExpired) as ei:
        tres.with_deadline(ev.wait, 0.05, site="test.hang")
    ev.set()
    err = capsys.readouterr().err
    assert "obs trace event" in err
    assert ei.value.trace_tail is not None
    assert any(e["name"] == "deadline.expired"
               for e in ei.value.trace_tail)


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
    # the compact snapshot: the JAX one's keys, spmd_guard's two included
    full = tobs.snapshot()
    assert set(jobs.snapshot()) == set(full)
    assert full["dispatches"] == tguard.dispatch_count()
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
    # a classified mid-exchange error carries the trace tail
    # (test_obs.py:449's second half), and the vector is as it was
    rows0 = [r.clone() for r in vt.rows]
    with tfaults.injected("redistribute.exchange", "program", times=1):
        with pytest.raises(tres.ProgramError) as ei:
            dt.redistribute(vt, [n] + [0] * (P - 1))
    assert ei.value.trace_tail and ei.value.site == "redistribute.exchange"
    assert any(e["name"] == "fault" for e in ei.value.trace_tail)
    assert len(vt.rows) == len(rows0) and all(
        a.equal(b) for a, b in zip(vt.rows, rows0))


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


def test_plan_flush_span_with_runs(traced):
    """Mirrors ``tests/test_obs.py::test_plan_flush_span_with_runs``: a
    flush is a ``plan.flush`` span (beside the ``plan.flush`` fault-site
    event) with a ``plan.run`` child of its ops, and the plan counters
    move, in both packages; an opaque item is a ``plan.opaque`` child."""
    arr = np.random.default_rng(41).standard_normal(8 * P).astype(np.float32)
    jv, tv = _pair(arr)
    jout, tout = _outs(8 * P, np.float32)
    got = {}
    for m, v, out in ((dr_tpu, jv, jout), (dt, tv, tout)):
        with m.deferred():
            m.fill(v, 0.5)
            s = m.reduce(v)
            m.inclusive_scan(v, out)
        got[m] = float(s)
    assert got[dt] == got[dr_tpu] == 0.5 * len(arr)
    np.testing.assert_allclose(dt.to_numpy(tout), dr_tpu.to_numpy(jout),
                               rtol=1e-6)
    for o in (jobs, tobs):
        evs = o.events()
        flush = [e for e in evs if e["name"] == "plan.flush"
                 and e["ph"] == "X"]
        assert flush and flush[0]["args"]["reason"] == "region exit"
        assert flush[0]["args"]["items"] == 2
        assert any(e["name"] == "plan.flush" and e["cat"] == "site"
                   for e in evs)
        runs = [e for e in evs if e["name"] == "plan.run"]
        assert runs and runs[0]["args"]["parent"] == flush[0]["id"]
        assert runs[0]["args"]["ops"] == 2
        opq = [e for e in evs if e["name"] == "plan.opaque"]
        assert opq and opq[0]["args"]["parent"] == flush[0]["id"]
        assert opq[0]["args"]["op"] == "inclusive_scan"
        snap = o.snapshot()
        assert snap["counters"]["plan.flushes"] >= 1
        assert snap["counters"]["plan.fused_ops"] >= 2
        assert snap["counters"]["plan.opaque_ops"] >= 1


# ---------------------------------------------------------------------------
# serve: cross-thread span tree + stats wire op (tests/test_obs.py's serve
# cases, both daemons traced on the same request)
# ---------------------------------------------------------------------------

def _serve_tree(pkg, path):
    srv = (pkg.Server(path, cpu=True) if pkg.__name__.startswith(
        "dr_tpu_torch") else pkg.Server(path))
    srv.start()
    try:
        with pkg.Client(srv.path, timeout=60.0) as c:
            x = np.arange(48, dtype=np.float32)
            np.testing.assert_allclose(c.scale(x, a=2.0), x * 2.0)
            st = c.stats()
    finally:
        srv.stop()
        pkg.reset()
    return st


def _check_tree(evs, st):
    reqs = [e for e in evs if e["name"] == "serve.request"
            and e["ph"] == "X"]
    assert reqs, "request span missing"
    rid = reqs[0]["id"]
    qw = [e for e in evs if e["name"] == "serve.queue_wait"]
    assert any(e["args"].get("parent") == rid for e in qw)
    bf = [e for e in evs if e["name"] == "serve.batch_flush"]
    assert any(rid in e["args"].get("links", ()) for e in bf)
    assert any(e["tid"] != reqs[0]["tid"] for e in bf)
    assert any(e["ph"] == "s" and e["id"] == rid for e in evs)
    assert any(e["ph"] == "f" and e["id"] == rid for e in evs)
    assert any(e["name"] == "serve.reply" and
               e["args"].get("parent") == rid for e in evs)
    assert any(e["name"] == "serve.accept" and e["cat"] == "site"
               for e in evs)
    hists = st["obs"]["histograms"]
    for key in ("serve.queue_wait_ms", "serve.service_ms",
                "serve.flush_ms"):
        assert hists[key]["count"] >= 1
        assert hists[key]["p50"] is not None


def test_serve_span_tree_links_across_threads(traced, tmp_path):
    from dr_tpu import serve as jserve
    from dr_tpu_torch import serve as tserve
    shapes = []
    for pkg, o, name in ((jserve, jobs, "j.sock"), (tserve, tobs, "t.sock")):
        st = _serve_tree(pkg, str(tmp_path / name))
        evs = o.events()
        _check_tree(evs, st)
        shapes.append(sorted({(e["ph"], e["name"],
                               tuple(sorted(e.get("args", {}))))
                              for e in evs if e.get("cat") == "serve"}))
    assert shapes[0] == shapes[1]


def test_serve_cancelled_request_closes_its_span(traced, tmp_path):
    from dr_tpu_torch import serve
    from dr_tpu_torch.obs import recorder
    from dr_tpu_torch.serve import protocol as proto
    srv = serve.Server(str(tmp_path / "d.sock"), cpu=True)
    srv.start()
    srv.hold()
    try:
        c = serve.Client(srv.path, timeout=60.0)
        proto.send_frame(c._sock, {"op": "fill", "params": {"n": 8},
                                   "tenant": "ghost", "id": 1})
        deadline = 50
        while not recorder._open and deadline:
            threading.Event().wait(0.02)
            deadline -= 1
        assert recorder._open, "request span never opened"
        c.close()
        threading.Event().wait(0.1)
        srv.release()
        deadline = 100
        while recorder._open and deadline:
            threading.Event().wait(0.02)
            deadline -= 1
    finally:
        srv.stop()
        serve.reset()
    assert recorder._open == {}, "cancelled request leaked its span"


def test_serve_daemon_samples_untraced(tmp_path):
    from dr_tpu_torch import serve
    from dr_tpu_torch.obs import metrics as om
    h = om.histogram("serve.queue_wait_ms")
    c0 = h.count
    srv = serve.Server(str(tmp_path / "d.sock"), cpu=True)
    srv.start()
    try:
        with serve.Client(srv.path, timeout=60.0) as c:
            c.fill(16, 1.0)
            m = c.metrics()
    finally:
        srv.stop()
        serve.reset()
    assert h.count > c0
    assert m["histograms"]["serve.queue_wait_ms"]["count"] >= 1
    assert not m["trace_armed"]
    assert tobs.events() == []


# ---------------------------------------------------------------------------
# the profiler mirror: the port's spans as torch.profiler ranges, armed or
# not, over the calls of the benchmark's paths
# ---------------------------------------------------------------------------

W5 = (0.05, 0.25, 0.4, 0.25, 0.05)
#: ranges the mirror must put into a profiler trace of _mirror_calls
MIRRORED = ["halo.exchange", "rows.copy", "sync.dot", "sync.count",
            "relational.join.sort_left", "relational.join.sort_right",
            "relational.join.merge", "relational.groupby.aggregate"]


def _mirror_calls():
    """A plain stencil step, a blocked pass, ``dot``, ``inclusive_scan``,
    an inner ``join`` and a ``groupby_aggregate`` on 8 CPU ranks; returns
    the host results and every output as numpy."""
    rng = np.random.default_rng(31)
    n = P * 2048
    hb = dt.halo_bounds(1024, 1024, periodic=True)
    a = dt.distributed_vector.from_array(
        rng.standard_normal(n).astype(np.float32), halo=hb)
    b = dt.distributed_vector(n, np.float32, hb)
    s = dt.distributed_vector(n, np.float32, hb)
    lk = dt.distributed_vector.from_array(
        rng.integers(0, 40, 64).astype(np.int32))
    lv = dt.distributed_vector.from_array(
        rng.standard_normal(64).astype(np.float32))
    rk = dt.distributed_vector.from_array(np.arange(0, 48, 2,
                                                    dtype=np.int32))
    rv = dt.distributed_vector.from_array(
        rng.standard_normal(24).astype(np.float32))
    outs = [dt.distributed_vector(64, t)
            for t in (np.int32, np.float32, np.float32)]
    gk, gv = dt.distributed_vector(64, np.int32), \
        dt.distributed_vector(64, np.float32)
    dt.stencil_iterate(a, b, W5, 1)
    dt.stencil_iterate_blocked(a, W5, 8, time_block=4)
    d = dt.dot(a, a)
    dt.inclusive_scan(a, s)
    m = dt.join(lk, lv, rk, rv, *outs)
    g = dt.groupby_aggregate(lk, lv, gk, gv)
    return [d, m, g] + [dt.to_numpy(x) for x in (a, b, s, *outs, gk, gv)]


def _profiled(path):
    """``_mirror_calls`` inside a ``caller`` range under the CPU
    profiler; returns its results and the exported trace's events."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            got = _mirror_calls()
    prof.export_chrome_trace(str(path))
    with open(path, encoding="utf-8") as fh:
        return got, json.load(fh)["traceEvents"]


@pytest.fixture(scope="module")
def mirrored(tmp_path_factory):
    """One disarmed profiled run of ``_mirror_calls``."""
    dt.init(["cpu"] * P)
    try:
        assert not tobs.armed()
        e0 = tobs.events_recorded()
        got = _profiled(tmp_path_factory.mktemp("mirror") / "t.json")
        assert tobs.events_recorded() == e0
        return got
    finally:
        dt.final()


def test_spans_off_record_nothing_and_open_no_range(monkeypatch):
    """Ring disarmed and no profiler: the calls record no event and never
    enter ``record_function``."""
    from torch.autograd import profiler as tprof

    def boom(*a, **k):
        raise AssertionError("record_function entered with both sinks off")
    monkeypatch.setattr(tprof, "record_function", boom)
    assert not tobs.armed() and not tprof._is_profiler_enabled
    e0 = tobs.events_recorded()
    _mirror_calls()
    assert tobs.events_recorded() == e0
    assert tobs.events() == []


@pytest.mark.parametrize("name", MIRRORED)
def test_profiler_carries_the_port_ranges_disarmed(mirrored, name):
    """Disarmed, under the CPU profiler: each span is a
    ``user_annotation`` nested inside the caller's own range (and each
    join or groupby phase inside its op's range)."""
    _got, evs = mirrored
    ua = [e for e in evs if e.get("cat") == "user_annotation"]
    caller, = [e for e in ua if e["name"] == "caller"]
    hits = [e for e in ua if e["name"] == name]
    assert hits, sorted({e["name"] for e in ua})

    def inside(e, outer):
        return outer["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] and \
            e["tid"] == outer["tid"]
    assert all(inside(e, caller) for e in hits)
    if name.startswith("relational."):
        op = [e for e in ua if e["name"] == ".".join(name.split(".")[:2])]
        assert all(any(inside(e, o) for o in op) for e in hits)


@pytest.mark.parametrize("profiled", [False, True])
def test_armed_ring_keeps_its_events_beside_the_profiler(traced, tmp_path,
                                                         profiled):
    """Armed, with or without the profiler: the ring holds the same
    ``relational.phase`` events (phase attributes as before) and the new
    ``sync`` / ``rows`` / ``halo`` spans; the profiler's trace holds the
    ranges too."""
    tobs.reset()
    if profiled:
        _got, evs = _profiled(tmp_path / "t.json")
        names = {e["name"] for e in evs
                 if e.get("cat") == "user_annotation"}
        assert set(MIRRORED) <= names
    else:
        _mirror_calls()
    ring = tobs.events()
    rel = [e for e in ring if e.get("cat") == "relational"]
    assert _phases(rel, "relational.phase") == [
        "sort_left", "sort_right", "merge", "sort", "aggregate"]
    assert [e["name"] for e in rel
            if e["name"] != "relational.phase"] == [
        "relational.join", "relational.groupby"]
    phases = [e for e in rel if e["name"] == "relational.phase"]
    assert [sorted(e["args"]) for e in phases] == [
        ["n", "parent", "phase"], ["n", "parent", "phase"],
        ["parent", "phase", "route", "rows"], ["n", "parent", "phase"],
        ["groups", "parent", "phase"]]
    cats = {e["name"]: e["cat"] for e in ring
            if e.get("cat") in ("sync", "rows", "halo")}
    assert cats == {"sync.dot": "sync", "sync.count": "sync",
                    "sync.join.fill": "sync", "sync.segred.mask": "sync",
                    "sync.groupby.longest_run": "sync",
                    "rows.copy": "rows", "halo.exchange": "halo"}


@pytest.mark.parametrize("mode", ["profiler", "armed", "both"])
def test_spans_change_no_result(tmp_path, mode):
    """Results bit for bit with the spans off and with each sink on."""
    off = _mirror_calls()
    tobs.arm(mode != "profiler")
    try:
        on = _profiled(tmp_path / "t.json")[0] if mode != "armed" \
            else _mirror_calls()
    finally:
        tobs.arm(False)
        tobs.reset()
    assert off[:3] == on[:3]
    for a, b in zip(off[3:], on[3:]):
        _assert_bits(b, a)
