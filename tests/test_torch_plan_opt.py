"""dr_tpu_torch plan optimizer (``dr_tpu_torch/plan/opt.py``) against
dr_tpu's.

Mirrors ``tests/test_plan_opt.py`` on 8 CPU ranks: the knob surface
(``DR_GPU_PLAN_OPT`` / ``DR_GPU_PLAN_OPT_DISABLE`` beside the JAX
package's ``DR_TPU_*``), the merge / dce / pushdown passes with the same
pass counts as the JAX package on the same queue, the auto tier inside
a region, footprint-gated host writes, and the relational pipeline's
dispatch count.  Results are held to the unoptimized flush (``=0``) and
to the eager port bit for bit, and to dr_tpu bit for bit (fills, copies,
integer keys) or within ``rtol=1e-6``.

A pass that raises takes the port's flush down (the queue is dropped
before anything ran, the error propagates): the JAX package's
``test_optimizer_pass_failure_never_takes_the_flush_down`` and
``test_pass_failure_after_merge_keeps_recorded_queue_executable`` have
counterparts that pin that instead.

Left out until ``tuning.py`` is ported (the next slice): the tuning DB
and what reads it, ``test_capinfer_hint_skips_probe_and_survives_
undershoot``, ``test_joinroute_reads_tuning_db_and_env_pin_wins`` and the
five ``test_tuning_*`` cases.
"""

import jax
import numpy as np
import pytest

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.utils.env import env_override as jenv_override
from dr_tpu_torch.plan import opt as plan_opt
from dr_tpu_torch.utils.env import env_override
from dr_tpu_torch.utils.spmd_guard import dispatch_count

P = 8


@pytest.fixture(autouse=True)
def _both():
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)
    yield
    dt.final()


def _scale(x, c):
    return x * c


def _shift(x, c):
    return x + c


def _vec(m, src):
    return m.distributed_vector.from_array(np.asarray(src))


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _mode(mode, disable=None):
    """The same optimizer setting for both packages."""
    class _Both:
        def __enter__(self):
            self._a = env_override(DR_GPU_PLAN_OPT=mode,
                                   DR_GPU_PLAN_OPT_DISABLE=disable)
            self._b = jenv_override(DR_TPU_PLAN_OPT=mode,
                                    DR_TPU_PLAN_OPT_DISABLE=disable)
            self._a.__enter__()
            self._b.__enter__()

        def __exit__(self, *exc):
            self._b.__exit__(*exc)
            self._a.__exit__(*exc)
    return _Both()


def _opt_pair(chain, make, mode="auto", disable=None):
    """``chain`` deferred in both packages under one optimizer setting;
    returns (port conts, port plan, jax conts, jax plan)."""
    with _mode(mode, disable):
        tc = make(dt)
        with dt.deferred() as p:
            chain(dt, *tc)
        jc = make(dr_tpu)
        with dr_tpu.deferred() as jp:
            chain(dr_tpu, *jc)
    return tc, p, jc, jp


# ---------------------------------------------------------------------------
# mode / knob surface
# ---------------------------------------------------------------------------

def test_mode_parsing_and_per_pass_disable():
    with env_override(DR_GPU_PLAN_OPT=None, DR_GPU_PLAN_OPT_DISABLE=None):
        assert plan_opt.mode() == "auto"
        assert plan_opt.enabled("merge") and plan_opt.enabled("dce")
        assert not plan_opt.enabled("capinfer")
        assert not plan_opt.enabled("pushdown")
    with env_override(DR_GPU_PLAN_OPT="all"):
        for name in plan_opt.PASS_NAMES:
            assert plan_opt.enabled(name), name
    with env_override(DR_GPU_PLAN_OPT="0"):
        for name in plan_opt.PASS_NAMES:
            assert not plan_opt.enabled(name), name
    with env_override(DR_GPU_PLAN_OPT="all",
                      DR_GPU_PLAN_OPT_DISABLE="merge, capinfer"):
        assert not plan_opt.enabled("merge")
        assert not plan_opt.enabled("capinfer")
        assert plan_opt.enabled("dce")
    # the JAX package's knob does not steer the port
    with env_override(DR_GPU_PLAN_OPT=None), \
            jenv_override(DR_TPU_PLAN_OPT="0"):
        assert plan_opt.mode() == "auto"


def test_every_pass_is_registered_with_an_impl_or_config_contract():
    from dr_tpu.plan import opt as jopt
    names = set()
    for name, fn in plan_opt.PASSES:
        assert fn is None or callable(fn)
        names.add(name)
        with env_override(DR_GPU_PLAN_OPT="all",
                          DR_GPU_PLAN_OPT_DISABLE=name):
            assert not plan_opt.enabled(name)
    assert names == set(plan_opt.PASS_NAMES) == set(jopt.PASS_NAMES)
    assert [(n, fn is None) for n, fn in plan_opt.PASSES] == \
        [(n, fn is None) for n, fn in jopt.PASSES]


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def _merge_case(m):
    n = 32
    return (m.distributed_vector(n, np.float32),
            _vec(m, np.full(n, 3.0, np.float32)),
            _vec(m, np.arange(n, dtype=np.float32)),
            m.distributed_vector(n, np.float32))


def _merge_chain(m, a, b, c, d):
    m.fill(a, 1.0)
    m.inclusive_scan(c, d)
    m.for_each(b, _scale, 2.0)


def test_merge_coalesces_runs_split_by_independent_opaque():
    def run(mode):
        with _mode(mode):
            conts = _merge_case(dt)
            d0 = dispatch_count()
            with dt.deferred() as p:
                _merge_chain(dt, *conts)
            return conts, dispatch_count() - d0, p.stats()

    base, base_used, base_stats = run("0")
    got, used, stats = run("auto")
    for w, g in zip(base, got):
        _bits(dt.to_numpy(g), dt.to_numpy(w))
    assert base_stats["opt"] == {"merged_runs": 0, "dce_ops": 0,
                                 "pushdowns": 0}
    assert stats["opt"]["merged_runs"] == 1
    assert used < base_used
    assert stats["fused_runs"] == base_stats["fused_runs"] - 1
    tc, p, jc, jp = _opt_pair(_merge_chain, _merge_case)
    assert p.stats()["opt"] == jp.stats()["opt"]
    for x, y in zip(tc, jc):
        _bits(dt.to_numpy(x), dr_tpu.to_numpy(y))


def test_merge_blocked_by_footprint_overlap():
    n = 16

    def chain(m, a, d):
        m.fill(a, 1.0)
        m.inclusive_scan(a, d)
        m.fill(a, 2.0)

    tc, p, jc, jp = _opt_pair(
        chain, lambda m: (_vec(m, np.zeros(n, np.float32)),
                          m.distributed_vector(n, np.float32)))
    _bits(dt.to_numpy(tc[0]), np.full(n, 2.0, np.float32))
    _bits(dt.to_numpy(tc[1]), np.cumsum(np.ones(n, np.float32)))
    assert p.stats()["opt"]["merged_runs"] == 0
    assert jp.stats()["opt"]["merged_runs"] == 0


def test_merge_blocked_by_scalar_dependency():
    n = 16

    def chain(m, a, c, d, x):
        s = m.reduce(a)
        m.inclusive_scan(c, d)
        m.fill(x, s)
        return s

    def make(m):
        return (_vec(m, np.full(n, 2.0, np.float32)),
                _vec(m, np.arange(n, dtype=np.float32)),
                m.distributed_vector(n, np.float32),
                m.distributed_vector(n, np.float32))

    with _mode("auto"):
        tc = make(dt)
        with dt.deferred() as p:
            s = chain(dt, *tc)
    assert float(s) == 2.0 * n
    _bits(dt.to_numpy(tc[3]), np.full(n, 2.0 * n, np.float32))
    assert p.stats()["opt"]["merged_runs"] == 0


def test_merge_preserves_within_run_interleaving():
    n = 24

    def chain(m, a, b, c, d):
        m.fill(a, 5.0)
        m.inclusive_scan(c, d)
        m.transform(a, b, _shift, 1.0)

    def make(m):
        return (m.distributed_vector(n, np.float32),
                m.distributed_vector(n, np.float32),
                _vec(m, np.arange(n, dtype=np.float32)),
                m.distributed_vector(n, np.float32))

    tc, p, jc, jp = _opt_pair(chain, make)
    _bits(dt.to_numpy(tc[1]), np.full(n, 6.0, np.float32))
    assert p.stats()["opt"] == jp.stats()["opt"]


# ---------------------------------------------------------------------------
# dce
# ---------------------------------------------------------------------------

def test_dce_eliminates_overwritten_fill():
    n = 32

    def chain(m, a):
        m.fill(a, 1.0)
        m.fill(a, 2.0)

    tc, p, _jc, jp = _opt_pair(
        chain, lambda m: (m.distributed_vector(n, np.float32),))
    _bits(dt.to_numpy(tc[0]), np.full(n, 2.0, np.float32))
    assert p.stats()["opt"]["dce_ops"] == jp.stats()["opt"]["dce_ops"] == 1


def test_dce_keeps_partially_overwritten_and_read_first_writes():
    n = 32

    def chain(m, a, b):
        m.fill(a, 1.0)
        m.transform(a, b, _scale, 3.0)
        m.fill(a[0:n // 2], 7.0)

    tc, p, jc, jp = _opt_pair(
        chain, lambda m: (m.distributed_vector(n, np.float32),
                          m.distributed_vector(n, np.float32)))
    want = np.full(n, 1.0, np.float32)
    want[:n // 2] = 7.0
    _bits(dt.to_numpy(tc[0]), want)
    _bits(dt.to_numpy(tc[1]), np.full(n, 3.0, np.float32))
    assert p.stats()["opt"]["dce_ops"] == jp.stats()["opt"]["dce_ops"] == 0


def test_dce_window_coverage_composes():
    n = 32

    def chain(m, a):
        m.fill(a[0:n // 2], 1.0)
        m.fill(a[n // 2:n], 2.0)
        m.fill(a, 9.0)

    tc, p, _jc, jp = _opt_pair(
        chain, lambda m: (m.distributed_vector(n, np.float32),))
    _bits(dt.to_numpy(tc[0]), np.full(n, 9.0, np.float32))
    assert p.stats()["opt"]["dce_ops"] == jp.stats()["opt"]["dce_ops"] == 2


def test_dce_empty_run_disappears():
    n = 16
    a = dt.distributed_vector(n, np.float32)
    c = _vec(dt, np.arange(n, dtype=np.float32))
    d = dt.distributed_vector(n, np.float32)
    with _mode("auto", "merge"):
        d0 = dispatch_count()
        with dt.deferred() as p:
            dt.fill(a, 1.0)
            dt.inclusive_scan(c, d)
            dt.fill(a, 2.0)
        used = dispatch_count() - d0
    assert p.stats()["opt"]["dce_ops"] == 1
    _bits(dt.to_numpy(a), np.full(n, 2.0, np.float32))
    items = p.log[-1]["items"]
    assert sum(1 for i in items if i["kind"] == "fused") == 1
    assert used >= 1


def test_per_pass_disable_bisects():
    n = 32

    def chain(m, a):
        m.fill(a, 1.0)
        m.fill(a, 2.0)

    tc, p, _jc, jp = _opt_pair(
        chain, lambda m: (m.distributed_vector(n, np.float32),),
        disable="dce")
    assert p.stats()["opt"]["dce_ops"] == 0
    assert "dce" not in p.log[-1]["opt"]["passes"]
    assert p.log[-1]["opt"]["passes"] == jp.log[-1]["opt"]["passes"]
    _bits(dt.to_numpy(tc[0]), np.full(n, 2.0, np.float32))


# ---------------------------------------------------------------------------
# pushdown
# ---------------------------------------------------------------------------

def test_pushdown_rehomes_projection_into_relational_scratch():
    rng = np.random.default_rng(21)
    n = 48
    src = rng.integers(0, 8, n).astype(np.float32)
    want = np.unique(src * 2.0)
    res = {}

    def chain(m, a, tmp):
        m.transform(a, tmp, _scale, 2.0)
        res[m] = m.unique_auto(tmp)
        m.copy(np.zeros(n, np.float32), tmp)

    tc, p, jc, jp = _opt_pair(
        chain, lambda m: (_vec(m, src), m.distributed_vector(n, np.float32)),
        mode="all")
    o = p.stats()["opt"]
    _bits(res[dt].arrays()[0], want)
    _bits(res[dt].arrays()[0], res[dr_tpu].arrays()[0])
    _bits(dt.to_numpy(tc[1]), np.zeros(n, np.float32))
    assert o["pushdowns"] == jp.stats()["opt"]["pushdowns"] == 1
    assert o["dce_ops"] >= 1


def test_pushdown_declines_when_intermediate_is_live():
    rng = np.random.default_rng(22)
    n = 32
    src = rng.integers(0, 6, n).astype(np.float32)
    res = {}

    def chain(m, a, tmp):
        m.transform(a, tmp, _scale, 2.0)
        res[m] = m.unique_auto(tmp)

    tc, p, jc, jp = _opt_pair(
        chain, lambda m: (_vec(m, src), m.distributed_vector(n, np.float32)),
        mode="all")
    assert p.stats()["opt"]["pushdowns"] == 0
    assert jp.stats()["opt"]["pushdowns"] == 0
    _bits(res[dt].arrays()[0], np.unique(src * 2.0))
    _bits(dt.to_numpy(tc[1]), src * 2.0)


# ---------------------------------------------------------------------------
# the auto tier inside a region
# ---------------------------------------------------------------------------

def test_join_auto_matches_explicit_join():
    rng = np.random.default_rng(23)
    nl, nr = 40, 24
    lk = rng.integers(0, 10, nl).astype(np.float32)
    lv = rng.standard_normal(nl).astype(np.float32)
    rk = rng.integers(0, 10, nr).astype(np.float32)
    rv = rng.standard_normal(nr).astype(np.float32)
    sides = [_vec(dt, x) for x in (lk, lv, rk, rv)]
    cap = 4 * (nl + nr)
    outs = [dt.distributed_vector(cap, np.float32) for _ in range(3)]
    m_exp = int(dt.join(*sides, *outs))
    with env_override(DR_GPU_PLAN_OPT="all"):
        with dt.deferred() as p:
            r = dt.join_auto(*sides)
        assert p.stats()["opaque_ops"] == 1
        assert r.count == m_exp
        got = r.arrays()
    for g, o in zip(got, outs):
        _bits(g, dt.to_numpy(o)[:m_exp])
    jr = dr_tpu.join_auto(*[_vec(dr_tpu, x) for x in (lk, lv, rk, rv)])
    assert jr.count == m_exp
    for g, j in zip(got, jr.arrays()):
        _bits(g, j)


def test_groupby_auto_and_unique_auto_deferred():
    rng = np.random.default_rng(25)
    n = 36
    keys = rng.integers(0, 7, n).astype(np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    kc, vc = _vec(dt, keys), _vec(dt, vals)
    with env_override(DR_GPU_PLAN_OPT="all"):
        with dt.deferred():
            g = dt.groupby_auto(kc, vc, agg="sum")
            u = dt.unique_auto(kc)
            assert repr(g) == "AutoResult(count=pending)"
        gk, gv = g.arrays()
        (uk,) = u.arrays()
    want_k = np.unique(keys)
    _bits(gk, want_k)
    _bits(uk, want_k)
    want_v = np.array([vals[keys == k].sum() for k in want_k], np.float64)
    np.testing.assert_allclose(gv, want_v, rtol=1e-5, atol=1e-6)
    assert g.count == len(want_k) and u.count == len(want_k)
    jg = dr_tpu.groupby_auto(_vec(dr_tpu, keys), _vec(dr_tpu, vals))
    np.testing.assert_allclose(gv, jg.arrays()[1], rtol=1e-5, atol=1e-6)


def test_auto_result_discarded_raises():
    kc = _vec(dt, np.arange(16, dtype=np.float32))
    with env_override(DR_GPU_PLAN_OPT="all"):
        p = dt.plan.Plan()
        with pytest.raises(RuntimeError, match="boom"):
            with p.record():
                u = dt.unique_auto(kc)
                raise RuntimeError("boom")
        with pytest.raises(RuntimeError, match="discarded"):
            u.count


def test_capinfer_disabled_uses_caller_guess_shape():
    """With the optimizer off the auto tier works unchanged (the port's
    auto tier always probes the exact count)."""
    rng = np.random.default_rng(26)
    keys = rng.integers(0, 5, 30).astype(np.float32)
    with env_override(DR_GPU_PLAN_OPT="0"):
        u = dt.unique_auto(_vec(dt, keys))
        _bits(u.arrays()[0], np.unique(keys))


def test_groupby_auto_validates_at_the_call_site():
    kc = _vec(dt, np.arange(8, dtype=np.float32))
    vc = _vec(dt, np.arange(6, dtype=np.float32))
    with dt.deferred() as p:
        with pytest.raises(ValueError, match="equal"):
            dt.groupby_auto(kc, vc)
    assert p.stats()["opaque_ops"] == 0


# ---------------------------------------------------------------------------
# failure posture / introspection
# ---------------------------------------------------------------------------

def _boom(_q):
    raise RuntimeError("synthetic pass bug")


def test_optimizer_pass_failure_takes_the_flush_down(monkeypatch):
    """Counterpart of ``test_optimizer_pass_failure_never_takes_the_
    flush_down``: the port runs no unoptimized queue in the pass's place.
    The flush raises the pass's error, nothing ran (the container keeps
    its pre-flush value), handles break, and no warning is raised."""
    import warnings
    monkeypatch.setattr(plan_opt, "PASSES",
                        (("dce", _boom),) + tuple(
                            p for p in plan_opt.PASSES if p[0] != "dce"))
    n = 16
    src = np.full(n, 7.0, np.float32)
    a = _vec(dt, src)
    with env_override(DR_GPU_PLAN_OPT="auto"), \
            warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with pytest.raises(RuntimeError, match="synthetic pass bug"):
            with dt.deferred() as p:
                dt.fill(a, 1.0)
                s = dt.reduce(a)
    assert not w
    _bits(dt.to_numpy(a), src)
    assert p.log[-1]["error"]
    with pytest.raises(RuntimeError, match="discarded"):
        float(s)


def test_pass_failure_after_merge_keeps_recorded_state(monkeypatch):
    """Counterpart of ``test_pass_failure_after_merge_keeps_recorded_
    queue_executable``: a pass failing after merge wrapped ops drops the
    whole queue with every container as it was; the same region without
    the failing pass then gives the unoptimized bits."""
    monkeypatch.setattr(plan_opt, "PASSES",
                        tuple(plan_opt.PASSES) + (("post", _boom),))
    n = 16
    conts = (dt.distributed_vector(n, np.float32),
             _vec(dt, np.full(n, 3.0, np.float32)),
             _vec(dt, np.arange(n, dtype=np.float32)),
             dt.distributed_vector(n, np.float32))
    before = [dt.to_numpy(c) for c in conts]
    with env_override(DR_GPU_PLAN_OPT="auto"):
        with pytest.raises(RuntimeError, match="synthetic pass bug"):
            with dt.deferred():
                _merge_chain(dt, *conts)
    for c, b in zip(conts, before):
        _bits(dt.to_numpy(c), b)
    monkeypatch.undo()
    with env_override(DR_GPU_PLAN_OPT="auto"):
        with dt.deferred() as p:
            _merge_chain(dt, *conts)
    assert p.stats()["opt"]["merged_runs"] == 1
    _bits(dt.to_numpy(conts[0]), np.ones(n, np.float32))
    _bits(dt.to_numpy(conts[1]), np.full(n, 6.0, np.float32))
    _bits(dt.to_numpy(conts[3]), np.cumsum(np.arange(n, dtype=np.float32)))


def test_explain_carries_the_opt_note():
    n = 16
    a = dt.distributed_vector(n, np.float32)
    with env_override(DR_GPU_PLAN_OPT="auto"):
        with dt.deferred() as p:
            dt.fill(a, 1.0)
            dt.fill(a, 2.0)
    text = p.explain()
    assert "opt [" in text and "dead op(s) eliminated" in text


# ---------------------------------------------------------------------------
# footprint-gated host writes
# ---------------------------------------------------------------------------

def test_assign_array_footprint_gated_flush():
    n = 16
    a = dt.distributed_vector(n, np.float32)
    src = np.arange(n, dtype=np.float32)
    with dt.deferred() as p:
        dt.fill(a, 1.0)
        fresh = dt.distributed_vector.from_array(src)
        assert p.stats()["flushes"] == 0
        a.assign_array(np.full(n, 5.0, np.float32))
        assert p.stats()["flushes"] == 1
    _bits(dt.to_numpy(fresh), src)
    _bits(dt.to_numpy(a), np.full(n, 5.0, np.float32))


# ---------------------------------------------------------------------------
# the relational pipeline: strictly fewer dispatches with the optimizer
# ---------------------------------------------------------------------------

def _plan_opt_chain(m, n_fact, ncard, mode):
    """bench.py's ``_plan_opt_chain`` through package ``m``."""
    rng = np.random.default_rng(19)
    fk = rng.integers(0, ncard, n_fact).astype(np.float32)
    fv = rng.standard_normal(n_fact).astype(np.float32)
    dk = rng.permutation(ncard).astype(np.float32)
    dv = rng.standard_normal(ncard).astype(np.float32)
    aux = rng.standard_normal(n_fact).astype(np.float32)
    fkv, fvv, dkv, dvv, a1, a2 = (_vec(m, x)
                                  for x in (fk, fv, dk, dv, aux, aux))
    hb = m.distributed_vector(16, np.int32)
    tv = m.distributed_vector(8, np.float32)
    ti = m.distributed_vector(8, np.int32)
    count = dispatch_count if m is dt else \
        __import__("dr_tpu.utils.spmd_guard",
                   fromlist=["dispatch_count"]).dispatch_count
    with _mode(mode):
        d0 = count()
        with m.deferred() as p:
            m.for_each(a1, _scale, 2.0)
            j = m.join_auto(fkv, fvv, dkv, dvv)
            m.for_each(a2, _shift, 1.0)
            g = m.groupby_auto(fkv, fvv, agg="sum")
            m.histogram(a1, hb, -6.0, 6.0)
            m.top_k(a1, tv, ti)
        used = count() - d0
        results = (j.count, g.count, m.to_numpy(hb).tolist(),
                   m.to_numpy(tv).tolist(), m.to_numpy(ti).tolist())
    return used, (p.log[-1].get("opt") or {}), results


def test_bench_plan_relational_ab_strictly_fewer_dispatches():
    n_fact, ncard = 2 ** 10, 64
    used, res = {}, {}
    for mode in ("0", "all"):
        used[mode], note, res[mode] = _plan_opt_chain(dt, n_fact, ncard,
                                                      mode)
        if mode == "all":
            assert note.get("merged_runs", 0) >= 1
    assert used["all"] < used["0"], used
    assert res["0"] == res["all"]
    _ju, jnote, jres = _plan_opt_chain(dr_tpu, n_fact, ncard, "all")
    assert note["merged_runs"] == jnote["merged_runs"]
    assert res["all"] == jres


# ---------------------------------------------------------------------------
# gemv over a view
# ---------------------------------------------------------------------------

def test_gemv_view_operand_is_a_full_barrier():
    n = 16
    rows = np.arange(n)

    def chain(m, A, b, c):
        m.fill(b, 1.0)
        m.gemv(c, A, b[0:n])
        m.fill(b, 2.0)

    def make(m):
        A = m.sparse_matrix.from_coo((n, n), rows, rows,
                                     np.ones(n, np.float32))
        c = m.distributed_vector(n, np.float32)
        m.fill(c, 0.0)
        return A, m.distributed_vector(n, np.float32), c

    tc, p, jc, jp = _opt_pair(chain, make)
    _bits(dt.to_numpy(tc[2]), np.ones(n, np.float32))
    _bits(dt.to_numpy(tc[1]), np.full(n, 2.0, np.float32))
    assert p.stats()["opt"]["dce_ops"] == jp.stats()["opt"]["dce_ops"]


# ---------------------------------------------------------------------------
# bit identity of random chains: eager, DR_GPU_PLAN_OPT=0 and =all
# ---------------------------------------------------------------------------

def _mul2(x, y):
    return x * y


def _random_chain(seed, n):
    """A seeded list of (op name, args) over containers 0-2 (one
    layout, a periodic halo of 1): the counterpart of the JAX package's
    plan fuzz arm (tests/test_fuzz.py), within the port."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(int(rng.integers(6, 14))):
        x, y, z = (int(i) for i in rng.permutation(3))
        lo = int(rng.integers(0, n // 2))
        hi = int(rng.integers(lo + 1, n + 1))
        v = float(np.float32(rng.standard_normal()))
        steps.append((rng.choice(
            ["fill", "iota", "for_each", "transform", "zip", "halo",
             "reduce", "scan", "copy", "stencil", "dot"]),
            x, y, z, lo, hi, v))
    return steps


def _play(m, conts, steps, n):
    """Run ``steps``; returns the reductions as floats."""
    out = []
    host = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    for name, x, y, z, lo, hi, v in steps:
        X, Y, Z = conts[x], conts[y], conts[z]
        if name == "fill":
            m.fill(X[lo:hi], v)
        elif name == "iota":
            m.iota(X[lo:hi], lo)
        elif name == "for_each":
            m.for_each(X, _scale, v)
        elif name == "transform":
            m.transform(X[lo:hi], Y[lo:hi], _shift, v)
        elif name == "zip":
            m.transform(m.views.zip(X, Y), Z, _mul2)
        elif name == "halo":
            m.halo(X).exchange()
        elif name == "reduce":
            out.append(m.reduce(X[lo:hi]))
        elif name == "scan":
            m.inclusive_scan(X, Y)
        elif name == "copy":
            m.copy(host * v, X)
        elif name == "stencil":
            m.stencil_transform(X, Y, [0.25, 0.5, 0.25])
        else:
            out.append(m.dot(X, Y))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_random_chains_bit_identical_across_opt_modes(seed):
    n = 8 * P
    steps = _random_chain(seed, n)

    def make():
        rng = np.random.default_rng(1000 + seed)
        return [dt.distributed_vector.from_array(
            rng.standard_normal(n).astype(np.float32),
            halo=dt.halo_bounds(1, 1, True)) for _ in range(3)]

    def rows(conts):
        return [np.concatenate([r.numpy() for r in c.rows]) for c in conts]

    eager = make()
    want = [float(s) for s in _play(dt, eager, steps, n)]
    got = {}
    for mode in ("0", "all"):
        conts = make()
        with env_override(DR_GPU_PLAN_OPT=mode):
            with dt.deferred():
                pending = _play(dt, conts, steps, n)
        got[mode] = ([float(s) for s in pending], rows(conts))
    for mode, (sums, rs) in got.items():
        np.testing.assert_array_equal(np.asarray(sums, np.float64),
                                      np.asarray(want, np.float64))
        for r, w in zip(rs, rows(eager)):
            _bits(r, w)
