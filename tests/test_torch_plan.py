"""dr_tpu_torch deferred plans (``dr_tpu_torch/plan``) against dr_tpu's.

Mirrors ``tests/test_plan.py`` case for case on 8 CPU ranks: the same
numpy-seeded sequence runs through ``dr_tpu.deferred()``, through
``dt.deferred()`` and eagerly through ``dt``.  The port's deferred run
equals its eager run bit for bit (a flush runs the eager row functions in
record order); the port against the JAX package is bit-exact for data
movement, fills and ints, and within ``rtol=1e-6`` for float chains
(XLA may contract a multiply-add inside one op).  ``stats()`` and
``explain()`` are held to the JAX package's on runs, ops and reasons.

Left out, with the slice that brings them: the elastic replay of a
faulted flush (``elastic``; the port drops the queue classified, which
``test_faulted_flush_is_clean`` pins).  The JAX package's
``test_persistent_compile_cache_wiring`` and
``test_compile_cache_unset_is_noop`` test its XLA compile cache, which has
no counterpart in the port (its CUDA builds are cached by source hash in
``ops/kernels``).
"""

import warnings

import jax
import numpy as np
import pytest

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu_torch import plan as tplan
from dr_tpu_torch.parallel.runtime import Runtime as TRuntime
from dr_tpu_torch.utils import faults as tfaults
from dr_tpu_torch.utils import resilience as tres
from dr_tpu_torch.utils import sanitize as tsan
from dr_tpu_torch.utils import spmd_guard as tguard

P = 8


@pytest.fixture(autouse=True)
def _both():
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)
    yield
    dt.final()


# module-level ops: cache keys pin callable identity
def _scale(x, c):
    return x * c


def _shift(x, c):
    return x + c


def _mul2(x, y):
    return x * y


def _swap_sum(x, y):
    return (x + y, x - y)


def _half(x):
    return x * 0.5


def _src(n, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _vec(m, src, hb=None):
    h = None if hb is None else m.halo_bounds(*hb)
    return m.distributed_vector.from_array(src, halo=h)


def _rows(v):
    """The padded rows of either package's vector, ghosts included."""
    if hasattr(v, "_data"):
        return np.asarray(v._data)
    return np.concatenate([r.numpy() for r in v.rows])


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _three(chain, make):
    """``chain(m, *conts)`` run eagerly in the port, deferred in the port
    and deferred in dr_tpu over containers from ``make(m)``: (eager
    (result, conts), deferred (result, conts, plan), jax (result, conts))."""
    te = make(dt)
    re_ = chain(dt, *te)
    td = make(dt)
    with dt.deferred() as p:
        rd = chain(dt, *td)
    jd = make(dr_tpu)
    with dr_tpu.deferred():
        rj = chain(dr_tpu, *jd)
    return (re_, te), (rd, td, p), (rj, jd)


# ---------------------------------------------------------------------------
# the acceptance chain and its dispatch count
# ---------------------------------------------------------------------------

def test_deferred_8op_chain_dispatches_and_bit_identity():
    """The eight-op chain: one tapped dispatch, the eager bits."""
    n = 24 * P
    s1, s2 = _src(n, 1), _src(n, 2)

    def make(m):
        return (_vec(m, s1, (1, 1, True)), _vec(m, s2, (1, 1, True)))

    def chain(m, a, b):
        m.fill(a, 0.25)
        m.iota(b, 3)
        m.for_each(a, _scale, 1.5)
        m.halo(a).exchange()
        m.transform(m.views.zip(a, b), b, _mul2)
        m.for_each(b, _shift, 2.0)
        m.halo(a).reduce_plus()
        return m.reduce(b)

    te = make(dt)
    want = chain(dt, *te)
    td = make(dt)
    d0 = tguard.dispatch_count()
    with dt.deferred() as p:
        got = chain(dt, *td)
    used = tguard.dispatch_count() - d0
    assert used <= 2, p.explain()
    assert isinstance(got, tplan.PlanScalar)
    assert float(got) == want
    for x, y in zip(td, te):
        _bits(_rows(x), _rows(y))
    jd = make(dr_tpu)
    with dr_tpu.deferred() as jp:
        jgot = chain(dr_tpu, *jd)
    np.testing.assert_allclose(float(got), float(jgot), rtol=1e-6)
    _bits(_rows(td[0]), _rows(jd[0]))
    np.testing.assert_allclose(_rows(td[1]), _rows(jd[1]), rtol=1e-6)
    st, jst = p.stats(), jp.stats()
    assert st["fused_runs"] == jst["fused_runs"] == 1
    assert st["fused_ops"] == jst["fused_ops"] == 8
    assert st["dispatches"] == used
    assert st["eager_runs"] == 1 and st["graph_replays"] == 0


def test_zero_recompile_and_stable_digest():
    """New fill values and coefficients reuse the cache entry: no insert
    anywhere, the same guard digest, values that follow the scalars."""
    n = 16 * P
    a = _vec(dt, np.zeros(n, np.float32), (1, 1, True))
    b = _vec(dt, np.zeros(n, np.float32), (1, 1, True))

    def region(fv, cv):
        with dt.deferred():
            dt.fill(a, fv)
            dt.for_each(a, _scale, cv)
            dt.halo(a).exchange()
            dt.transform(a, b, _shift, cv)
            s = dt.reduce(b)
        return float(s)

    v1 = region(2.0, 1.5)
    with tsan.zero_recompile("plan re-record with new values"), \
            tguard.guard() as g1:
        v2 = region(3.0, 2.5)
    with tsan.zero_recompile("plan re-record, third pass"), \
            tguard.guard() as g2:
        v3 = region(-1.0, 0.5)
    assert g1.digest() == g2.digest()
    assert v1 == n * (2.0 * 1.5 + 1.5)
    assert v2 == n * (3.0 * 2.5 + 2.5)
    assert v3 == n * 0.0


def test_reduction_rides_the_carry():
    """A mid-chain reduce feeds a later op of the same run: one dispatch."""
    n = 8 * P

    def chain(m, a, b):
        m.fill(a, 2.0)
        tot = m.reduce(a)
        m.fill(b, tot)
        return tot, m.reduce(b)

    def make(m):
        return (m.distributed_vector(n, np.float32),
                m.distributed_vector(n, np.float32))

    d0 = tguard.dispatch_count()
    (_, te), (rd, td, p), (rj, _jd) = _three(chain, make)
    assert p.stats()["dispatches"] == 1, p.explain()
    assert tguard.dispatch_count() - d0 >= 1
    want = chain(dt, *make(dt))
    assert float(rd[0]) == want[0] == float(rj[0]) == 2.0 * n
    assert float(rd[1]) == want[1] == float(rj[1]) == 2.0 * n * n
    _bits(_rows(td[1]), _rows(te[1]))


def test_posted_scalar_feeding_later_op_keeps_init_fold():
    """reduce(r, init=...) folds on the host: its consumer reads the
    posted value in a second run."""
    n = 8 * P
    ea, eb = dt.distributed_vector(n), dt.distributed_vector(n)
    dt.fill(ea, 2.0)
    dt.fill(eb, dt.reduce(ea, 10.0))
    want = dt.to_numpy(eb)

    a, b = dt.distributed_vector(n), dt.distributed_vector(n)
    with dt.deferred() as p:
        dt.fill(a, 2.0)
        s = dt.reduce(a, 10.0)
        dt.fill(b, s)
    _bits(dt.to_numpy(b), want)
    ja, jb = dr_tpu.distributed_vector(n), dr_tpu.distributed_vector(n)
    with dr_tpu.deferred() as jp:
        dr_tpu.fill(ja, 2.0)
        js = dr_tpu.reduce(ja, 10.0)
        dr_tpu.fill(jb, js)
    _bits(dt.to_numpy(b), dr_tpu.to_numpy(jb))
    assert float(s) == float(js) == 10.0 + 2.0 * n
    assert p.stats()["fused_runs"] == jp.stats()["fused_runs"] == 2
    with pytest.raises(ValueError):
        s.device()


def test_plan_scalar_equality_resolves():
    n = 8 * P
    a = dt.distributed_vector(n, np.float32)
    with dt.deferred():
        dt.fill(a, 2.0)
        s = dt.reduce(a)
        assert s == 2.0 * n
        assert s != 2.0 * n + 1
        assert s == dt.reduce(a)
    with pytest.raises(TypeError):
        hash(s)


def test_scalar_read_flushes_mid_region():
    n = 8 * P
    a = dt.distributed_vector(n, np.float32)
    with dt.deferred() as p:
        dt.fill(a, 3.0)
        tot = dt.reduce(a)
        assert float(tot) == 3.0 * n
        dt.for_each(a, _shift, 1.0)
    assert dt.to_numpy(a)[0] == 4.0
    assert p.stats()["flushes"] == 2
    assert "scalar read" in p.explain()


def test_reduce_init_and_transform_reduce_deferred():
    n = 8 * P
    src = _src(n, 3)

    def chain(m, a):
        return (m.reduce(a, 10.0),
                m.transform_reduce(a, transform_op=_scale,
                                   transform_args=(3.0,)),
                m.dot(a, a, init=1.0))

    def make(m):
        return (_vec(m, src),)

    (re_, _), (rd, _, _), (rj, _) = _three(chain, make)
    for e, d, j in zip(re_, rd, rj):
        assert float(d) == e
        np.testing.assert_allclose(float(d), float(j), rtol=1e-6)


def test_host_materialization_flushes():
    n = 8 * P
    a = dt.distributed_vector(n, np.float32)
    with dt.deferred() as p:
        dt.fill(a, 7.0)
        assert a[0] == 7.0
        dt.for_each(a, _shift, 1.0)
        np.testing.assert_array_equal(dt.to_numpy(a),
                                      np.full(n, 8.0, np.float32))
    assert p.stats()["flushes"] >= 2


def test_nonfusible_sort_flushes_without_warning():
    """Counterpart of ``test_nonfusible_sort_flushes_and_warns``: the
    recorded prefix lands before the sort (the same flush order and
    bits), and the port raises no warning (it has no fallback
    registry)."""
    n = 8 * P
    src = _src(n, 5)
    a = _vec(dt, src)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with dt.deferred() as p:
            dt.for_each(a, _scale, -1.0)
            dt.sort(a)
    assert not w, [str(x.message) for x in w]
    _bits(dt.to_numpy(a), np.sort(-src))
    ja = _vec(dr_tpu, src)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with dr_tpu.deferred() as jp:
            dr_tpu.for_each(ja, _scale, -1.0)
            dr_tpu.sort(ja)
    _bits(dt.to_numpy(a), dr_tpu.to_numpy(ja))
    assert [e["reason"] for e in p.log] == [e["reason"] for e in jp.log]
    assert p.log[0]["reason"] == "non-fusible: sort"


def test_gemv_records_opaque_keeps_runs():
    """Counterpart of ``test_gemv_records_opaque_keeps_runs``: gemv is
    an ordered opaque item, the runs around it stay fused, no warning."""
    m = 8 * P
    rng = np.random.default_rng(11)
    d = np.where(rng.random((m, m)) < 0.3,
                 rng.standard_normal((m, m)), 0).astype(np.float32)
    r, c = np.nonzero(d)
    bsrc = rng.standard_normal(m).astype(np.float32)

    def chain(mod, A, cv, b):
        mod.fill(cv, 0.25)
        mod.for_each(b, _scale, 2.0)
        mod.gemv(cv, A, b)
        mod.for_each(cv, _shift, 1.0)
        return mod.reduce(cv)

    def make(mod):
        return (mod.sparse_matrix.from_coo((m, m), r, c, d[r, c]),
                mod.distributed_vector(m), _vec(mod, bsrc))

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        (re_, te), (rd, td, p), _ = _three(chain, make)
    port_w = [x for x in w if "dr_tpu_torch" in str(x.filename)]
    assert not port_w, [str(x.message) for x in port_w]
    assert float(rd) == re_
    _bits(dt.to_numpy(td[1]), dt.to_numpy(te[1]))
    st = p.stats()
    assert st["opaque_ops"] == 1 and st["fused_runs"] == 2, st
    assert not any("non-fusible" in e["reason"] for e in p.log)


def test_opaque_scan_keeps_order():
    n = 16 * P
    src = np.arange(n, dtype=np.float32)

    def chain(m, a, out):
        m.fill(a, 1.0)
        m.inclusive_scan(a, out)
        m.for_each(out, _scale, 2.0)

    def make(m):
        return (_vec(m, src), m.distributed_vector(n, np.float32))

    (_, te), (_, td, p), (_, jd) = _three(chain, make)
    _bits(dt.to_numpy(td[1]), dt.to_numpy(te[1]))
    _bits(dt.to_numpy(td[1]), dr_tpu.to_numpy(jd[1]))
    st = p.stats()
    assert st["opaque_ops"] == 1 and st["fused_runs"] == 2


def test_deferred_zip_foreach_and_subranges():
    n = 24 * P
    s7, s8 = _src(n, 7), _src(n, 8)

    def chain(m, a, b):
        m.for_each(m.views.zip(a, b), _swap_sum)
        m.fill(a[2:n - 3], -1.0)
        m.transform(a[1:n - 1], b[1:n - 1], _shift, 0.5)
        return m.reduce(b[3:n], op=max)

    def make(m):
        return (_vec(m, s7), _vec(m, s8))

    (re_, te), (rd, td, _), (rj, jd) = _three(chain, make)
    assert float(rd) == re_ == float(rj)
    for x, y, j in zip(td, te, jd):
        _bits(dt.to_numpy(x), dt.to_numpy(y))
        _bits(dt.to_numpy(x), dr_tpu.to_numpy(j))


def test_deferred_host_copy_splice():
    n = 16 * P
    src = np.linspace(-1, 1, n).astype(np.float32)

    def chain(m, a):
        m.copy(src, a)
        m.for_each(a, _scale, 2.0)

    def make(m):
        return (_vec(m, _src(n, 9)),)

    (_, te), (_, td, _), (_, jd) = _three(chain, make)
    _bits(dt.to_numpy(td[0]), dt.to_numpy(te[0]))
    _bits(dt.to_numpy(td[0]), dr_tpu.to_numpy(jd[0]))


def test_fused_loop_helpers_flush_pending_writes():
    from dr_tpu_torch.algorithms.reduce import dot_n
    from dr_tpu_torch.algorithms.scan import inclusive_scan_n
    n = 8 * P
    a, b, s = (dt.distributed_vector(n, np.float32) for _ in range(3))
    with dt.deferred():
        dt.fill(a, 2.0)
        dt.fill(b, 1.0)
        assert float(dot_n(a, b, 1)) == 2.0 * n
        dt.fill(a, 3.0)
        inclusive_scan_n(a, s, 1)
    np.testing.assert_allclose(dt.to_numpy(s),
                               np.cumsum(np.full(n, 3.0, np.float32)),
                               rtol=1e-6)


def test_deferred_mismatched_copy_raises_like_eager():
    n = 16 * P
    d = dt.distributed_vector(n, np.float32)
    src = np.arange(n // 2, dtype=np.float32)
    with pytest.raises(Exception):
        dt.copy(src, d)
    with pytest.raises(ValueError):
        with dt.deferred():
            dt.copy(src, d)


def test_deferred_stencil_transform_bit_identical():
    n = 32 * P
    w = [0.25, 0.5, 0.25]
    s11, s12 = _src(n, 11), _src(n, 12)

    def chain(m, a, b):
        m.halo(a).exchange()
        m.stencil_transform(a, b, w)
        return m.reduce(b)

    def make(m):
        return (_vec(m, s11, (1, 1, True)), _vec(m, s12, (1, 1, True)))

    te = make(dt)
    want = chain(dt, *te)
    td = make(dt)
    d0 = tguard.dispatch_count()
    with dt.deferred():
        got = chain(dt, *td)
    assert tguard.dispatch_count() - d0 == 1
    assert float(got) == want
    _bits(dt.to_numpy(td[1]), dt.to_numpy(te[1]))
    jd = make(dr_tpu)
    with dr_tpu.deferred():
        jgot = chain(dr_tpu, *jd)
    np.testing.assert_allclose(dt.to_numpy(td[1]), dr_tpu.to_numpy(jd[1]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got), float(jgot), rtol=1e-5)


def test_faulted_flush_is_clean():
    """A classified fault at the flush: nothing ran, handles raise, and
    a fresh region works."""
    n = 8 * P
    src = np.full(n, 5.0, np.float32)
    a = _vec(dt, src)
    with tfaults.injected("plan.flush", "program", times=1):
        with pytest.raises(tres.ProgramError) as ei:
            with dt.deferred():
                dt.fill(a, 1.0)
                s = dt.reduce(a)
    assert ei.value.site == "plan.flush"
    _bits(dt.to_numpy(a), src)
    with pytest.raises(RuntimeError):
        float(s)
    with dt.deferred():
        dt.fill(a, 2.0)
    _bits(dt.to_numpy(a), np.full(n, 2.0, np.float32))


def test_region_exception_discards_pending():
    n = 8 * P
    src = np.full(n, 3.0, np.float32)
    a = _vec(dt, src)
    with pytest.raises(ValueError):
        with dt.deferred() as p:
            dt.fill(a, 9.0)
            raise ValueError("user error inside the region")
    _bits(dt.to_numpy(a), src)
    assert tplan.active() is None
    assert any(e["reason"] == "region error" for e in p.log)


def test_explain_reports_runs_and_reasons():
    n = 8 * P

    def chain(m, a):
        m.fill(a, 1.0)
        m.for_each(a, _shift, 1.0)

    def make(m):
        return (m.distributed_vector(n, np.float32),)

    _, (_, _, p), _ = _three(chain, make)
    jp = dr_tpu.plan.Plan()
    with jp.record():
        chain(dr_tpu, *make(dr_tpu))
    txt = p.explain()
    assert "region exit" in txt and "fused run" in txt
    assert "fill" in txt and "transform" in txt and "eager" in txt
    st = p.stats()
    assert st == {"flushes": 1, "fused_runs": 1, "fused_ops": 2,
                  "opaque_ops": 0, "cache_hits": st["cache_hits"],
                  "dispatches": 1, "graph_captures": 0,
                  "graph_replays": 0, "eager_runs": 1,
                  "opt": {"merged_runs": 0, "dce_ops": 0,
                          "pushdowns": 0}}
    jst = jp.stats()
    for k in ("flushes", "fused_runs", "fused_ops", "opaque_ops",
              "dispatches", "opt"):
        assert st[k] == jst[k], k


def test_nested_deferred_reenters():
    n = 8 * P
    a = dt.distributed_vector(n, np.float32)
    with dt.deferred() as outer:
        dt.fill(a, 1.0)
        with dt.deferred() as inner:
            dt.for_each(a, _shift, 1.0)
        assert inner is outer
        assert outer.stats()["flushes"] == 0
    assert outer.stats()["flushes"] == 1
    _bits(dt.to_numpy(a), np.full(n, 2.0, np.float32))


def test_runtime_change_splits_runs():
    """Counterpart of ``test_mesh_change_splits_runs``: containers on two
    runtimes cannot share a run."""
    rt_small = TRuntime(["cpu"] * 2)
    rt_big = TRuntime(["cpu"] * 4)
    small = dt.distributed_vector(8, np.float32, runtime=rt_small)
    big = dt.distributed_vector(16, np.float32, runtime=rt_big)
    with dt.deferred() as p:
        dt.fill(small, 1.0)
        dt.fill(big, 2.0)
    assert p.stats()["fused_runs"] == 2
    _bits(dt.to_numpy(small), np.full(8, 1.0, np.float32))
    _bits(dt.to_numpy(big), np.full(16, 2.0, np.float32))


def test_plan_cache_is_tapped_for_guard():
    a = dt.distributed_vector(8 * P, np.float32)
    with tguard.guard() as g:
        with dt.deferred():
            dt.fill(a, 1.0)
    assert len(g.trace) == 1 and g.trace[0].startswith("(")


def test_cpu_ranks_always_run_in_order():
    """The graph route is fixed by the device: CPU ranks run in order on
    every flush of a key, however often it repeats."""
    n = 8 * P
    a = dt.distributed_vector(n, np.float32)
    p = tplan.Plan()
    for i in range(3):
        with p.record():
            dt.fill(a, float(i))
            dt.for_each(a, _scale, 2.0)
    st = p.stats()
    assert st["eager_runs"] == 3 and st["cache_hits"] == 2
    assert st["graph_captures"] == st["graph_replays"] == 0
    _bits(dt.to_numpy(a), np.full(n, 4.0, np.float32))


def test_graph_safe_flags_follow_the_operands():
    """``graph_safe`` is decided at record time: host scalars keep an op
    capturable, a host array or a scalar of another run does not, and a
    re-layout never is."""
    n = 8 * P
    a = dt.distributed_vector(n, np.float32)
    b = dt.distributed_vector(n, np.float32)
    with dt.deferred() as p:
        dt.fill(a, 1.5)
        dt.for_each(a, _scale, np.float32(2.0))
        s = dt.reduce(a)
        dt.copy(np.arange(n, dtype=np.float32), b)
        flags = [o.graph_safe for o in p._queue[-1].ops]
        assert flags == [True, True, True, False]
        assert float(s) == 3.0 * n
        dt.fill(b, s)                       # s came from the last run
        dt.redistribute(a, [n] + [0] * (P - 1))
        assert [o.graph_safe for o in p._queue[-1].ops] == [False, False]


# ---------------------------------------------------------------------------
# redistribute fusion
# ---------------------------------------------------------------------------

def test_deferred_redistribute_fuses_without_flush():
    n = 4 * P
    src = np.arange(n, dtype=np.float32)
    team = [n] + [0] * (P - 1)

    def chain(m, v):
        m.fill(v, 2.0)
        m.redistribute(v, team)
        m.for_each(v, _half)
        return m.reduce(v)

    def make(m):
        return (_vec(m, src),)

    te = make(dt)
    want = float(chain(dt, *te))
    td = make(dt)
    d0 = tguard.dispatch_count()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with dt.deferred() as p:
            tot = chain(dt, *td)
    used = tguard.dispatch_count() - d0
    assert used <= 1, p.explain()
    assert float(tot) == want == n
    st = p.stats()
    assert st["fused_runs"] == 1 and st["fused_ops"] == 4, p.explain()
    assert td[0].distribution is not None \
        and td[0].distribution.sizes[0] == n
    _bits(_rows(td[0]), _rows(te[0]))
    jd = make(dr_tpu)
    with dr_tpu.deferred():
        chain(dr_tpu, *jd)
    _bits(_rows(td[0]), _rows(jd[0]))


def test_deferred_redistribute_layout_visible_to_later_records():
    n = 4 * P
    src = np.arange(n, dtype=np.float32)
    fresh = np.arange(n, dtype=np.float32) * 3 + 1
    uneven = [1] * (P - 1) + [n - (P - 1)]

    def chain(m, v):
        m.redistribute(v, uneven)
        m.copy(fresh, v)

    (_, te), (_, td, _), (_, jd) = _three(chain, lambda m: (_vec(m, src),))
    _bits(_rows(td[0]), _rows(te[0]))
    _bits(dt.to_numpy(td[0]), fresh)
    _bits(dt.to_numpy(td[0]), dr_tpu.to_numpy(jd[0]))


def test_deferred_redistribute_faulted_flush_rolls_back_metadata():
    n = 4 * P
    src = np.arange(n, dtype=np.float32)
    v = _vec(dt, src)
    layout = v.layout
    with tfaults.injected("plan.flush", "program", times=1):
        with pytest.raises(tres.ProgramError):
            with dt.deferred():
                dt.fill(v, 5.0)
                dt.redistribute(v, [n] + [0] * (P - 1))
    assert v.distribution is None and v.layout == layout
    _bits(dt.to_numpy(v), src)


def test_deferred_redistribute_host_route_flushes_without_warning():
    """Counterpart of
    ``test_deferred_redistribute_host_route_flushes_announced``: a move
    onto another device list flushes the plan first (the same flush
    order) and runs eagerly, with no warning."""
    small = TRuntime(["cpu"] * 2)
    n = 12
    v = _vec(dt, np.arange(n, dtype=np.float32))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        with dt.deferred() as p:
            dt.fill(v, 1.5)
            dt.redistribute(v, None, runtime=small)
    assert not rec, [str(x.message) for x in rec]
    assert v.runtime is small
    _bits(dt.to_numpy(v), np.full(n, 1.5, np.float32))
    reasons = [e["reason"] for e in p.log]
    assert reasons[0] == "non-fusible: redistribute (host-staged route)"
