"""dr_tpu_torch plansan (``dr_tpu_torch/plan/plansan.py``): the
footprint mutation battery and the serializability oracle, mirroring
``tests/test_plansan.py`` on 8 CPU ranks.

Every family of ``plansan.FAMILY_NAMES`` (the same registry as the JAX
package's) gets one seeded under-declaration that the shadow verifier
(the run's emits replayed over ``meta`` rows) or the container watcher
(an opaque thunk) must report as a ``FootprintViolation``; the oracle
catches seeded reorders.  Each family's region then flushes its
unmutated plan, and its result is held to the port's eager call (bit for
bit) and to dr_tpu's deferred one (bit for bit, or ``rtol=1e-6`` for a
float stencil and scan).
"""

import jax
import numpy as np
import pytest

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.plan import plansan as jplansan
from dr_tpu_torch import plan as tplan
from dr_tpu_torch import views
from dr_tpu_torch.plan import interference, plansan
from dr_tpu_torch.utils import sanitize

P = 8


@pytest.fixture(autouse=True)
def _both():
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)
    yield
    dt.final()


def _scale(x, c):
    return x * c


def _swap_sum(x, y):
    return (x + y, x - y)


def _double(x):
    return x * 2


def _runs(p):
    return [it for it in p._queue if isinstance(it, tplan._Run)]


def _rows(v):
    if hasattr(v, "_data"):
        return np.asarray(v._data)
    return np.concatenate([r.numpy() for r in v.rows])


def _assert_catches(run, op):
    """The declared footprint verifies clean; the seeded
    under-declaration raises a FootprintViolation with the trace tail;
    the restored footprint verifies clean again."""
    plansan.verify_run(run)
    orig_r, orig_w = op.reads, op.writes
    if op.writes:
        op.writes = ()
    else:
        op.reads = ()
    try:
        with pytest.raises(plansan.FootprintViolation) as ei:
            plansan.verify_run(run)
    finally:
        op.reads, op.writes = orig_r, orig_w
    assert isinstance(ei.value, sanitize.SanitizeError)
    assert hasattr(ei.value, "trace_tail")
    assert "outside its declared footprint" in str(ei.value)
    plansan.verify_run(run)


def _family(record, make, exact=True):
    """Record in a region of each package; in the port's, mutate the
    last fused op and check the verifier, then let both flush.  The
    flushed containers match the port's eager call and dr_tpu's."""
    te = make(dt)
    record(dt, *te)
    td = make(dt)
    with dt.deferred() as p:
        record(dt, *td)
        _assert_catches(_runs(p)[-1], _runs(p)[-1].ops[-1])
    jd = make(dr_tpu)
    with dr_tpu.deferred():
        record(dr_tpu, *jd)
    for x, y, j in zip(td, te, jd):
        if not hasattr(x, "rows"):
            continue
        np.testing.assert_array_equal(_rows(x), _rows(y))
        if exact:
            np.testing.assert_array_equal(dt.to_numpy(x),
                                          dr_tpu.to_numpy(j))
        else:
            np.testing.assert_allclose(dt.to_numpy(x), dr_tpu.to_numpy(j),
                                       rtol=1e-6, atol=1e-7)


N = 8 * P


def _ar(m, off=0.0, hb=None, n=N):
    h = None if hb is None else m.halo_bounds(*hb)
    return m.distributed_vector.from_array(
        np.arange(n, dtype=np.float32) + off, halo=h)


# ---------------------------------------------------------------------------
# one seeded under-declaration per footprint family
# ---------------------------------------------------------------------------

def _drive_generator():
    _family(lambda m, v: m.fill(v, 2.0),
            lambda m: (m.distributed_vector(N, np.float32),))


def _drive_transform():
    _family(lambda m, a, b: m.transform(a, b, _scale, 1.5),
            lambda m: (_ar(m), m.distributed_vector(N, np.float32)))


def _drive_zip_foreach():
    _family(lambda m, a, b: m.for_each(m.views.zip(a, b), _swap_sum),
            lambda m: (_ar(m), _ar(m, 1.0)))


def _drive_reduce():
    _family(lambda m, a: m.reduce(a), lambda m: (_ar(m),))


def _drive_splice():
    src = np.arange(N, dtype=np.float32)
    _family(lambda m, v: m.copy(src, v),
            lambda m: (m.distributed_vector(N, np.float32),))


def _drive_halo():
    _family(lambda m, v: m.halo(v).exchange(),
            lambda m: (_ar(m, hb=(1, 1, True)),))


def _drive_stencil():
    _family(lambda m, a, b: m.stencil_transform(a, b, [0.25, 0.5, 0.25]),
            lambda m: (_ar(m, hb=(1, 1, True)),
                       m.distributed_vector.from_array(
                           np.zeros(N, np.float32),
                           halo=m.halo_bounds(1, 1, True))),
            exact=False)


def _drive_redistribute():
    n = 4 * P
    _family(lambda m, v: m.redistribute(v, [n] + [0] * (P - 1)),
            lambda m: (_ar(m, n=n),))


def _drive_histogram():
    def make(m):
        return (m.distributed_vector.from_array(
            np.linspace(-2.0, 2.0, N, dtype=np.float32)),
            m.distributed_vector(9, np.int32))
    _family(lambda m, v, out: m.histogram(v, out, -2.5, 2.5), make)


def _drive_top_k():
    def make(m):
        return (_ar(m), m.distributed_vector(3, np.float32),
                m.distributed_vector(3, np.int32))
    _family(lambda m, v, tv, ti: m.top_k(v, tv, ti), make)


def _drive_opaque():
    """The opaque half rides the container watcher: under-declare the
    scan's write of ``out`` and run its thunk under ``plansan.watch``."""
    a = _ar(dt)
    b = dt.distributed_vector(N, np.float32)
    with dt.deferred() as p:
        dt.inclusive_scan(a, b)
        [item] = [it for it in p._queue if isinstance(it, tplan._Opaque)]
        orig_r, orig_w = item.reads, item.writes
        item.writes = ()
        try:
            with pytest.raises(plansan.FootprintViolation) as ei:
                with plansan.watch(item):
                    item.thunk()
        finally:
            item.reads, item.writes = orig_r, orig_w
        assert hasattr(ei.value, "trace_tail")
        assert "WRITE of distributed_vector" in str(ei.value)
        with plansan.watch(item):
            item.thunk()
    np.testing.assert_allclose(dt.to_numpy(b),
                               np.cumsum(np.arange(N, dtype=np.float32)),
                               rtol=1e-6)


_FAMILY_CASES = {
    "generator": _drive_generator,
    "transform": _drive_transform,
    "zip_foreach": _drive_zip_foreach,
    "reduce": _drive_reduce,
    "splice": _drive_splice,
    "halo": _drive_halo,
    "stencil": _drive_stencil,
    "redistribute": _drive_redistribute,
    "histogram": _drive_histogram,
    "top_k": _drive_top_k,
    "opaque": _drive_opaque,
}


def test_battery_covers_every_family():
    assert set(_FAMILY_CASES) == set(plansan.FAMILY_NAMES) \
        == set(jplansan.FAMILY_NAMES)
    for _name, method in plansan.FAMILIES:
        assert hasattr(tplan.Plan, method), method


@pytest.mark.parametrize("family", sorted(_FAMILY_CASES))
def test_mutation_battery_catches_underdeclaration(family):
    _FAMILY_CASES[family]()


def test_barrier_opaque_is_exempt_from_the_watcher():
    a = _ar(dt)
    b = dt.distributed_vector(N, np.float32)
    with dt.deferred() as p:
        dt.inclusive_scan(a, b)
        [item] = list(p._queue)
        orig_r, orig_w = item.reads, item.writes
        item.reads = item.writes = None
        try:
            with plansan.watch(item):
                item.thunk()
        finally:
            item.reads, item.writes = orig_r, orig_w


def test_shadow_replay_touches_no_data():
    """The abstract replay runs on meta rows: the containers' values
    and version counters do not move."""
    a = _ar(dt, hb=(1, 1, True))
    b = dt.distributed_vector(N, np.float32)
    with dt.deferred() as p:
        dt.fill(a, 3.0)
        dt.halo(a).exchange()
        dt.transform(a, b, _scale, 2.0)
        dt.reduce(b)
        vers = [r._version for c in (a, b) for r in c.rows]
        before = [_rows(a), _rows(b)]
        plansan.verify_run(_runs(p)[-1])
        assert [r._version for c in (a, b) for r in c.rows] == vers
        np.testing.assert_array_equal(_rows(a), before[0])
        np.testing.assert_array_equal(_rows(b), before[1])
    np.testing.assert_array_equal(dt.to_numpy(b), np.full(N, 6.0))


# ---------------------------------------------------------------------------
# conflict-serializability oracle
# ---------------------------------------------------------------------------

def test_oracle_catches_intra_run_reorder():
    a = dt.distributed_vector(N, np.float32)
    b = dt.distributed_vector(N, np.float32)
    with dt.deferred() as p:
        dt.fill(a, 2.0)
        dt.transform(a, b, _scale, 3.0)
        [run] = _runs(p)
        snap = plansan.snapshot(p._queue)
        plansan.check_serializable(snap, list(p._queue))
        run.ops.reverse()
        try:
            with pytest.raises(plansan.SerializationViolation,
                               match="data") as ei:
                plansan.check_serializable(snap, list(p._queue))
        finally:
            run.ops.reverse()
        assert hasattr(ei.value, "trace_tail")
    np.testing.assert_array_equal(dt.to_numpy(b), np.full(N, 6.0))


def test_oracle_catches_opaque_queue_reorder():
    a = _ar(dt)
    b = dt.distributed_vector(N, np.float32)
    c = dt.distributed_vector(N, np.float32)
    with dt.deferred() as p:
        dt.inclusive_scan(a, b)
        dt.inclusive_scan(b, c)
        snap = plansan.snapshot(p._queue)
        plansan.check_serializable(snap, list(p._queue))
        with pytest.raises(plansan.SerializationViolation, match="data"):
            plansan.check_serializable(snap, list(p._queue)[::-1])


def test_oracle_barrier_orders_against_everything():
    a = dt.distributed_vector(N, np.float32)
    with dt.deferred() as p:
        dt.fill(a, 1.0)
        p.record_opaque("mystery", lambda: None)
        snap = plansan.snapshot(p._queue)
        plansan.check_serializable(snap, list(p._queue))
        with pytest.raises(plansan.SerializationViolation,
                           match="barrier"):
            plansan.check_serializable(snap, list(p._queue)[::-1])


def test_oracle_dropped_ops_are_unconstrained():
    a = dt.distributed_vector(N, np.float32)
    b = dt.distributed_vector(N, np.float32)
    with dt.deferred() as p:
        dt.fill(a, 2.0)
        dt.transform(a, b, _scale, 3.0)
        snap = plansan.snapshot(p._queue)
        plansan.check_serializable(snap, [])


# ---------------------------------------------------------------------------
# view-operand footprints
# ---------------------------------------------------------------------------

def test_view_containers_resolves_chains_and_keeps_barriers():
    a = _ar(dt)
    b = _ar(dt, 1.0)
    got = interference.view_containers(views.take(a, 4))
    assert [id(x) for x in got] == [id(a)]
    got = interference.view_containers(
        views.transform(views.zip(a, b), _swap_sum))
    assert [id(x) for x in got] == [id(a), id(b)]
    assert interference.view_containers(object()) is None


def test_gemv_view_footprint_skips_unrelated_flush():
    m = ncols = 4 * P
    rng = np.random.default_rng(5)
    nnz = 3 * m
    rows = rng.integers(0, m, size=nnz)
    cols = rng.integers(0, ncols, size=nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    A = dt.sparse_matrix.from_coo((m, ncols), rows, cols, vals)
    csrc = rng.standard_normal(m).astype(np.float32)
    bsrc = rng.standard_normal(ncols).astype(np.float32)
    c = dt.distributed_vector.from_array(csrc)
    b = dt.distributed_vector.from_array(bsrc)
    unrelated = dt.distributed_vector(4 * P, np.float32)
    tview = views.transform(b, _double)
    with dt.deferred() as p:
        dt.gemv(c, A, tview)
        [item] = list(p._queue)
        reads = interference.opaque_reads(item)
        assert reads is not None
        assert id(b) in {id(x) for x in reads}
        tplan.flush_reads(cont=unrelated)
        assert len(p._queue) == 1
        tplan.flush_reads(cont=b)
        assert len(p._queue) == 0
    ref = csrc.astype(np.float64)
    np.add.at(ref, rows,
              vals.astype(np.float64) * (2.0 * bsrc.astype(np.float64))[cols])
    np.testing.assert_allclose(dt.to_numpy(c), ref, rtol=1e-3, atol=1e-4)


def test_armed_sanitizer_verifies_every_flush(monkeypatch):
    """Under an armed sanitizer a flush verifies every run, checks the
    optimized order, watches opaque items and checks each run's output
    finite: a NaN a run makes from finite inputs raises."""
    monkeypatch.setattr(sanitize, "_installed", True)
    a = _ar(dt)
    b = dt.distributed_vector(N, np.float32)
    with dt.deferred() as p:
        dt.for_each(a, _scale, 2.0)
        dt.inclusive_scan(a, b)
        s = dt.reduce(b)
    assert float(s) == float(dt.reduce(b))
    assert p.stats()["fused_runs"] == 2
    with pytest.raises(sanitize.SanitizeError, match="non-finite"):
        with dt.deferred():
            dt.for_each(a, _scale, float("nan"))
    # inputs that were already non-finite are not blamed on the run
    with dt.deferred():
        dt.for_each(a, _scale, 1.0)
