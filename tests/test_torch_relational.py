"""dr_tpu_torch's relational ops (groupby_aggregate, unique, histogram,
top_k, the auto tier) and K8 against dr_tpu on 8 CPU ranks, with the
same numpy-seeded inputs; the cases mirror ``tests/test_relational.py``
(joins: ``tests/test_torch_join.py``).

Keys, counts, indices, integer and min/max aggregates, histograms and
top_k are compared bit for bit; float sums and means within
``rtol=1e-5, atol=1e-6``, the reference test's own tolerance (the two
packages add a group's values in different orders)."""

import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu import views as j_views
from dr_tpu.ops import hist_pallas as j_hist
from dr_tpu.utils import resilience as j_res
from dr_tpu.utils.env import env_override
from dr_tpu_torch.ops import hist_pallas as t_hist
from dr_tpu_torch.utils.resilience import ProgramError

P = 8
_BITS = {2: np.int16, 4: np.int32, 8: np.int64}


@pytest.fixture(autouse=True)
def _port_ranks():
    dt.init(["cpu"] * P)
    yield
    dt.final()


def assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if got.dtype.kind == "f":
        got, want = got.view(_BITS[got.itemsize]), \
            want.view(_BITS[want.itemsize])
    np.testing.assert_array_equal(got, want)


def _pair(arr, **kw):
    return (dr_tpu.distributed_vector.from_array(arr, **kw),
            dt.distributed_vector.from_array(arr, **kw))


def _outs(n, dtype, **kw):
    return (dr_tpu.distributed_vector(n, dtype, **kw),
            dt.distributed_vector(n, dtype, **kw))


def _same(j, t, close=False):
    a, b = dr_tpu.to_numpy(j), dt.to_numpy(t)
    if close:
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    else:
        assert_bits(b, a)


def _groupby_both(keys, vals, ok, ov, agg, close=False, **kw):
    """Run one groupby in both packages; ``keys``/``vals`` are
    (dr_tpu, port) pairs (vals may be None), ``ok``/``ov`` out pairs."""
    a = dr_tpu.groupby_aggregate(keys[0], vals[0] if vals else None,
                                 ok[0], ov[0], agg=agg)
    b = dt.groupby_aggregate(keys[1], vals[1] if vals else None,
                             ok[1], ov[1], agg=agg)
    assert int(a) == b
    _same(*ok)
    _same(*ov, close=close)
    return b


# ---------------------------------------------------------------- groupby

@pytest.mark.parametrize("agg", ["sum", "min", "max", "count", "mean"])
def test_groupby_aggregate_matches_reference(agg):
    rng = np.random.default_rng(7)
    n = 57
    keys = rng.integers(0, 9, n).astype(np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    ng = _groupby_both(_pair(keys), _pair(vals), _outs(n, np.float32),
                       _outs(n, np.float32), agg,
                       close=agg in ("sum", "mean"))
    assert ng == len(np.unique(keys))


def test_groupby_count_without_values_and_int_sums():
    rng = np.random.default_rng(8)
    n = 33
    keys = rng.integers(0, 5, n).astype(np.float32)
    _groupby_both(_pair(keys), None, _outs(n, np.float32),
                  _outs(n, np.int32), "count")
    # int32 values: an exact sum, equal bit for bit (wrapping included)
    iv = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    _groupby_both(_pair(keys), _pair(iv), _outs(n, np.float32),
                  _outs(n, np.int32), "sum")


def test_groupby_all_equal_and_all_distinct_keys():
    rng = np.random.default_rng(9)
    n = 29
    vals = _pair(rng.standard_normal(n).astype(np.float32))
    # all-equal: one group spanning every rank boundary
    ng = _groupby_both(_pair(np.full(n, 3.5, np.float32)), vals,
                       _outs(n, np.float32), _outs(n, np.float32), "sum",
                       close=True)
    assert ng == 1
    ng = _groupby_both(_pair(np.arange(n, dtype=np.float32)), vals,
                       _outs(n, np.float32), _outs(n, np.float32), "max")
    assert ng == n


def test_groupby_uneven_layouts_and_window_inputs():
    rng = np.random.default_rng(10)
    n = 41
    keys = rng.integers(0, 6, n).astype(np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    dist = [5, 0, 12, 3, 0, 9, 7, 5]
    kj, kt = _pair(keys, distribution=dist)
    vj, vt = _pair(vals, distribution=dist)
    ok = _outs(n, np.float32, distribution=[10, 0, 11, 20, 0, 0, 0, 0])
    _groupby_both((kj[5:30], kt[5:30]), (vj[5:30], vt[5:30]), ok,
                  _outs(n, np.float32), "mean", close=True)


def test_groupby_specials_and_empty_trailing_ranks():
    """5 elements on 8 ranks (ranks 5-7 of the scratch are empty); -0.0
    and +0.0 are one key, every NaN is one key; int32 keys at INT32_MAX
    (the pad key) group on their own."""
    keys = np.array([0.0, np.nan, -0.0, 2.0, np.nan], np.float32)
    vals = np.array([1, 2, 3, 4, 5], np.int32)
    ng = _groupby_both(_pair(keys), _pair(vals), _outs(8, np.float32),
                       _outs(8, np.int32), "min")
    assert ng == 3
    ik = np.array([2 ** 31 - 1, 5, -2 ** 31, 2 ** 31 - 1, 5, 0, 7],
                  np.int32)
    ng = _groupby_both(_pair(ik), _pair(np.arange(7, dtype=np.int32)),
                       _outs(7, np.int32), _outs(7, np.int32), "max")
    assert ng == 5


def test_groupby_out_key_dtype_casts():
    keys = np.array([3.0, 1.0, 3.0, 2.0, 1.0], np.float32)
    vals = _pair(np.ones(5, np.float32))
    _groupby_both(_pair(keys), vals, _outs(5, np.int32),
                  _outs(5, np.float32), "sum")
    _groupby_both(_pair(keys.astype(np.int32)), vals, _outs(5, np.float32),
                  _outs(5, np.float32), "sum")


def test_groupby_unequal_out_capacities_rejected():
    rng = np.random.default_rng(27)
    _, kv = _pair(rng.integers(0, 12, 16).astype(np.float32))
    _, vv = _pair(rng.standard_normal(16).astype(np.float32))
    with pytest.raises(ValueError, match="share one capacity"):
        dt.groupby_aggregate(kv, vv, dt.distributed_vector(32, np.float32),
                             dt.distributed_vector(8, np.float32))


@pytest.mark.parametrize("p_new", [0.5, 0.1, 0.002, 1.0])
def test_groupby_float_run_sums_fixed_order(p_new):
    """The groupby's float sums over the sorted runs: within the
    summation bound of a float64 sum (run length x 2^-24 x sum |v|), the
    same bits on a second call, the input untouched, and +0.0 for an
    empty run or one of -0.0s (a sum from zero), as index_add_ gave."""
    from dr_tpu_torch.algorithms.relational import _run_sums
    rng = np.random.default_rng(31)
    S = 5000
    v = torch.from_numpy(rng.standard_normal(S).astype(np.float32) * 50)
    flags = torch.from_numpy(rng.random(S) < p_new)
    segid = torch.cumsum(flags, 0, dtype=torch.int32)
    v0 = v.clone()
    got = _run_sums(v, segid, S + 1)
    assert torch.equal(v, v0) and torch.equal(got, _run_sums(v, segid, S + 1))
    want = torch.zeros(S + 1, dtype=torch.float64).index_add_(
        0, segid, v.double())
    absum = torch.zeros(S + 1, dtype=torch.float64).index_add_(
        0, segid, v.double().abs())
    count = torch.bincount(segid, minlength=S + 1).double()
    assert bool(((got.double() - want).abs()
                 <= count * 2.0 ** -24 * absum).all())
    z = _run_sums(torch.tensor([-0.0, -0.0, 1.0]),
                  torch.tensor([1, 1, 2], dtype=torch.int32), 4)
    assert torch.equal(z, torch.tensor([0.0, 0.0, 1.0, 0.0]))
    assert not torch.signbit(z).any()


def test_unique_matches_reference():
    rng = np.random.default_rng(11)
    n = 48
    kj, kt = _pair(rng.integers(0, 11, n).astype(np.float32))
    oj, ot = _outs(n, np.float32)
    assert int(dr_tpu.unique(kj, oj)) == dt.unique(kt, ot)
    _same(oj, ot)


# -------------------------------------------------------------- histogram

def _hist_both(xs, out, lo, hi):
    dr_tpu.histogram(xs[0], out[0], lo, hi)
    dt.histogram(xs[1], out[1], lo, hi)
    _same(*out)


def test_histogram_matches_reference_on_edges():
    """Values exactly on bucket edges, at lo and at hi (the last bucket
    takes it), just outside, NaN and infinities: the bucket rule bit for
    bit, f32 edges and then the working dtype."""
    rng = np.random.default_rng(14)
    n = 77
    vals = rng.standard_normal(n).astype(np.float32)
    edges = np.linspace(-2.5, 2.5, 10).astype(np.float32)
    vals[:10] = edges
    vals[10:16] = [np.nextafter(np.float32(2.5), np.float32(3)),
                   np.nextafter(np.float32(-2.5), np.float32(-3)),
                   np.nan, np.inf, -np.inf, -0.0]
    _hist_both(_pair(vals), _outs(9, np.int32), -2.5, 2.5)
    # bins whose width is not exact in binary, float out counts
    _hist_both(_pair(vals), _outs(7, np.float32), -0.3, 1.1)
    ints = rng.integers(0, 10, n).astype(np.int32)
    _hist_both(_pair(ints), _outs(5, np.int32), -0.5, 9.5)


def test_histogram_window_chain():
    rng = np.random.default_rng(15)
    vj, vt = _pair(rng.standard_normal(64).astype(np.float32))
    out = _outs(7, np.float32)
    _hist_both((j_views.transform(vj[8:40], _double),
                dt.views.transform(vt[8:40], _double)), out, -3.0, 3.0)
    for w in (1.0, 1.5):
        _hist_both((vj[3:50], vt[3:50]), out, -w, w)


def test_histogram_bins_above_k8_cap_take_scatter_route():
    rng = np.random.default_rng(16)
    vals = rng.uniform(-1, 1, 200).astype(np.float32)
    bins = (1 << 15) + 1
    assert t_hist.eligible(200, 1 << 15) and not t_hist.eligible(200, bins)
    _hist_both(_pair(vals), _outs(bins, np.int32), -1.0, 1.0)


def _double(x):
    return x * 2


@pytest.mark.parametrize("bins", [1, 7, 128, 129])
def test_k8_plain_matches_pallas_interpret(bins):
    """K8's plain version against the TPU kernel in interpret mode, bit
    for bit, with out-of-range ids; then the JAX histogram on its Pallas
    arm (interpret on the CPU) against the port's."""
    rng = np.random.default_rng(bins)
    n = 300
    ids = rng.integers(-2, bins + 2, n).astype(np.int32)
    cnt = rng.integers(0, 3, n).astype(np.int32)
    import jax.numpy as jnp
    want = np.asarray(j_hist.bincount(jnp.asarray(ids), jnp.asarray(cnt),
                                      bins, interpret=True))
    got = t_hist.plain_bincount(torch.from_numpy(ids),
                                torch.from_numpy(cnt), bins)
    assert_bits(got.numpy(), want)
    assert_bits(t_hist.bincount(torch.from_numpy(ids),
                                torch.from_numpy(cnt), bins).numpy(), want)
    vals = rng.standard_normal(77).astype(np.float32)
    with env_override(DR_TPU_HIST_IMPL="pallas"):
        _hist_both(_pair(vals), _outs(bins, np.int32), -2.0, 2.0)


# ------------------------------------------------------------------ top_k

def _top_k_both(xs, k, largest=True, merge=False, outs=None):
    tv = outs[0] if outs else _outs(k, np.float32)
    ti = outs[1] if outs else _outs(k, np.int32)
    dr_tpu.top_k(xs[0], tv[0], ti[0], largest=largest, merge=merge)
    dt.top_k(xs[1], tv[1], ti[1], largest=largest, merge=merge)
    _same(*tv)
    _same(*ti)
    return tv, ti


@pytest.mark.parametrize("largest", [True, False])
def test_top_k_matches_reference(largest):
    rng = np.random.default_rng(16)
    vals = rng.standard_normal(53).astype(np.float32)
    vals[:4] = [np.inf, -np.inf, 0.0, -0.0]
    _top_k_both(_pair(vals), 7, largest=largest)


def test_top_k_ties_and_k_beyond_n():
    vals = np.array([1.0, 3.0, 3.0, 0.0, 3.0], np.float32)
    _, ti = _top_k_both(_pair(vals), 8)
    gi = dt.to_numpy(ti[1])
    np.testing.assert_array_equal(gi[:5], [1, 2, 4, 0, 3])
    assert (gi[5:] == np.iinfo(np.int32).max).all()
    # k beyond every rank's width: the candidates are padded
    _top_k_both(_pair(np.arange(9, dtype=np.int32)[::-1].copy()), 20)


def test_top_k_streaming_windows_and_merge_layout():
    rng = np.random.default_rng(17)
    n = 90
    vj, vt = _pair(rng.standard_normal(n).astype(np.float32))
    outs = _top_k_both((vj[0:30], vt[0:30]), 6)
    _top_k_both((vj[30:60], vt[30:60]), 6, merge=True, outs=outs)
    _top_k_both((vj[60:n], vt[60:n]), 6, merge=True, outs=outs)
    tv = dt.distributed_vector(4, np.float32)
    ti = dt.distributed_vector(4, np.int32,
                               distribution=[4, 0, 0, 0, 0, 0, 0, 0])
    dt.top_k(vt, tv, ti)  # non-merge: independent layouts are fine
    with pytest.raises(TypeError, match="ONE layout"):
        dt.top_k(vt, tv, ti, merge=True)


# ---------------------------------------------------------- failure matrix

def test_relational_api_misuse_raises_at_call_site():
    rng = np.random.default_rng(22)
    n = 16
    _, kv = _pair(rng.standard_normal(n).astype(np.float32))
    _, vv = _pair(rng.standard_normal(n).astype(np.float32))
    ok = dt.distributed_vector(n, np.float32)
    ov = dt.distributed_vector(n, np.float32)
    with pytest.raises(ValueError, match="unknown agg"):
        dt.groupby_aggregate(kv, vv, ok, ov, agg="median")
    with pytest.raises(ValueError, match="needs values"):
        dt.groupby_aggregate(kv, None, ok, ov, agg="sum")
    with pytest.raises(ValueError, match="unknown how"):
        dt.join(kv, vv, kv, vv, ok, ov, ov, how="cross")
    with pytest.raises(TypeError, match="key dtypes"):
        dt.join(kv, vv, dt.distributed_vector(n, np.int32), vv, ok, ov, ov)
    with pytest.raises(ValueError, match="equal length"):
        dt.groupby_aggregate(kv[0:4], vv, ok, ov)
    with pytest.raises(ValueError, match="equal length"):
        dt.join(kv, vv[0:6], kv, vv, ok, ov, ov)
    with pytest.raises(ValueError, match="share one capacity"):
        dt.join(kv, vv, kv, vv, ok, ov, dt.distributed_vector(4))
    with pytest.raises(TypeError, match="whole"):
        dt.unique(kv, ok[0:4])
    with pytest.raises(ValueError, match="hi > lo"):
        dt.histogram(kv, ok, 2.0, 2.0)
    with pytest.raises(TypeError, match="int32"):
        dt.top_k(kv, dt.distributed_vector(8, np.float32),
                 dt.distributed_vector(8, np.float32))
    with pytest.raises(ValueError, match="unknown agg"):
        dt.groupby_auto(kv, vv, agg="nope")


def test_capacity_overflow_raises_program_error_first_rows_valid():
    """A result beyond the capacity raises ProgramError after the op ran,
    with the first ``cap`` rows valid: equal to the reference's rows."""
    rng = np.random.default_rng(23)
    n = 24
    kj, kt = _pair(rng.integers(0, 12, n).astype(np.float32))
    vj, vt = _pair(rng.standard_normal(n).astype(np.float32))
    cases = (
        ("groupby", lambda m, k, v, a, b: m.groupby_aggregate(k, v, a, b)),
        ("unique", lambda m, k, v, a, b: m.unique(k, a)),
        ("join", lambda m, k, v, a, b: m.join(k, v, k, v, a, b, b)))
    for name, call in cases:
        aj, at = _outs(3, np.float32)
        bj, bt = _outs(3, np.float32)
        with pytest.raises(j_res.ProgramError, match="rows"):
            call(dr_tpu, kj, vj, aj, bj)
        with pytest.raises(ProgramError, match="rows"):
            call(dt, kt, vt, at, bt)
        _same(aj, at)
        _same(bj, bt, close=name == "groupby")


# --------------------------------------------------------------- auto tier

def _auto_same(a, b, close=False):
    assert a.count == b.count and int(b) == b.count
    for x, y in zip(a.arrays(), b.arrays()):
        if close:
            np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-6)
        else:
            assert_bits(y, x)


@pytest.mark.parametrize("agg", ["sum", "count", "mean"])
def test_groupby_and_unique_auto_match_reference(agg):
    rng = np.random.default_rng(31)
    n = 45
    kj, kt = _pair(rng.integers(0, 13, n).astype(np.float32))
    vj, vt = _pair(rng.standard_normal(n).astype(np.float32))
    _auto_same(dr_tpu.groupby_auto(kj, vj, agg=agg),
               dt.groupby_auto(kt, vt, agg=agg), close=agg != "count")
    a, b = dr_tpu.unique_auto(kj), dt.unique_auto(kt)
    _auto_same(a, b)
    assert len(b.containers) == 1 and len(b.containers[0]) >= b.count


# ------------------------------------------------------------ whole slice

def test_bench_pipeline_matches_reference():
    """The bench's relational pipeline (``bench.py:910-961``) at
    n_fact = 2^12 over 256 keys (fan-in 16): join a permuted one-row-per-
    key dimension table, groupby sum over the joined rows, top_k 8 of the
    groups, and a 16-bin histogram of the joined values."""
    rng = np.random.default_rng(14)
    n_fact, ncard = 1 << 12, 1 << 8
    fk = _pair(rng.integers(0, ncard, n_fact).astype(np.float32))
    fv = _pair(rng.standard_normal(n_fact).astype(np.float32))
    dk = _pair(rng.permutation(ncard).astype(np.float32))
    dv = _pair(rng.standard_normal(ncard).astype(np.float32))
    cap = 2 * n_fact
    jk, jl, jr, gk, gv = (_outs(cap, np.float32) for _ in range(5))
    res = []
    for i, m in enumerate((dr_tpu, dt)):
        rows = int(m.join(fk[i], fv[i], dk[i], dv[i], jk[i], jl[i], jr[i]))
        ng = int(m.groupby_aggregate(jk[i][0:rows], jl[i][0:rows], gk[i],
                                     gv[i], agg="sum"))
        res.append((rows, ng))
    assert res[0] == res[1] and res[1][0] == n_fact
    rows, ng = res[1]
    for o in (jk, jl, jr, gk):
        _same(*o)
    _same(*gv, close=True)
    # top_k of the groups: the port's own sums, so their order is its own
    tv, ti = _outs(8, np.float32), _outs(8, np.int32)
    dt.top_k(gv[1][0:ng], tv[1], ti[1])
    sums = dt.to_numpy(gv[1])[:ng]
    order = np.lexsort((np.arange(ng), -sums))[:8]
    np.testing.assert_array_equal(dt.to_numpy(ti[1]), order)
    _hist_both((jl[0][0:rows], jl[1][0:rows]), _outs(16, np.int32),
               -3.0, 3.0)


# ----------------------------------------------------------------- serve

def _hist_count(x, bins, lo, hi):
    """The bucket rule in numpy: floor((x-lo)*bins/(hi-lo)), right edge
    inclusive in the last bucket, out-of-range dropped."""
    x = np.asarray(x, np.float64)
    inr = (x >= lo) & (x <= hi)
    b = np.minimum(np.floor((x[inr] - lo) * bins / (hi - lo))
                   .astype(np.int64), bins - 1)
    return np.bincount(b, minlength=bins)


def test_serve_relational_round_trip(tmp_path):
    """The relational ops over the port daemon's wire (mirrors
    ``tests/test_relational.py::test_serve_relational_round_trip``),
    each reply against the JAX daemon's on the same inputs and against
    numpy."""
    from dr_tpu import serve as jserve
    from dr_tpu_torch import serve
    rng = np.random.default_rng(24)
    lk = rng.integers(0, 6, 24).astype(np.float32)
    lv = rng.standard_normal(24).astype(np.float32)
    rk = rng.integers(0, 6, 18).astype(np.float32)
    rv = rng.standard_normal(18).astype(np.float32)
    jsrv = jserve.Server(str(tmp_path / "j.sock"), batch_window=0.0)
    tsrv = serve.Server(str(tmp_path / "t.sock"), batch_window=0.0,
                        cpu=True)
    jsrv.start()
    tsrv.start()
    try:
        with jserve.Client(jsrv.path, timeout=60.0) as jc, \
                serve.Client(tsrv.path, timeout=60.0) as c:
            jk, jl, jr = c.join(lk, lv, rk, rv)
            want = sorted((k, a, b) for k, a in zip(lk, lv)
                          for k2, b in zip(rk, rv) if k == k2)
            assert sorted(zip(jk, jl, jr)) == want
            for how in ("inner", "outer"):
                got = c.join(lk, lv, rk, rv, how=how, fill=-5.0)
                ref = jc.join(lk, lv, rk, rv, how=how, fill=-5.0)
                assert sorted(zip(*got)) == sorted(zip(*ref))
            gk, gv = c.groupby(lk, lv, agg="mean")
            np.testing.assert_array_equal(gk, np.unique(lk))
            np.testing.assert_allclose(
                gv, [lv[lk == k].astype(np.float64).mean() for k in gk],
                rtol=1e-5)
            np.testing.assert_array_equal(c.unique(lk), np.unique(lk))
            tv, ti = c.top_k(lv, 4)
            np.testing.assert_array_equal(tv, np.sort(lv)[::-1][:4])
            np.testing.assert_array_equal(lv[ti.astype(np.int64)], tv)
            h = c.histogram(lv, 6, -2.0, 2.0)
            np.testing.assert_array_equal(h, _hist_count(lv, 6, -2, 2))
            np.testing.assert_array_equal(
                h, jc.histogram(lv, 6, -2.0, 2.0))
            with pytest.raises(ProgramError):
                c.groupby(lk, lv, agg="median")
            with pytest.raises(ProgramError):
                ones = np.ones(64, np.float32)
                c.join(ones, ones, ones, ones, capacity=8)
            assert c.ping()["pong"]
    finally:
        jsrv.stop()
        tsrv.stop()
        serve.reset()
        jserve.reset()


def test_serve_topk_histogram_batch_into_one_flush(tmp_path):
    """topk + histogram + scale queued together dispatch as ONE fused
    batch (mirrors ``tests/test_relational.py::
    test_serve_topk_histogram_batch_into_one_flush``)."""
    import threading
    import time
    from dr_tpu_torch import serve
    rng = np.random.default_rng(25)
    srv = serve.Server(str(tmp_path / "relb.sock"), batch_window=0.05,
                       batch_max=8, cpu=True)
    srv.start()
    try:
        x = rng.standard_normal(64).astype(np.float32)
        with serve.Client(srv.path, timeout=60.0) as c:
            c.top_k(x, 3)
            c.histogram(x, 4, -2.0, 2.0)
        srv.hold()
        results = {}

        def go(name, fn):
            results[name] = fn()

        with serve.Client(srv.path, timeout=60.0) as c1, \
                serve.Client(srv.path, timeout=60.0) as c2, \
                serve.Client(srv.path, timeout=60.0) as c3:
            ts = [threading.Thread(target=go, args=(
                      "t", lambda: c1.top_k(x, 3))),
                  threading.Thread(target=go, args=(
                      "h", lambda: c2.histogram(x, 4, -2.0, 2.0))),
                  threading.Thread(target=go, args=(
                      "s", lambda: c3.scale(x, a=2.0)))]
            for t in ts:
                t.start()
            time.sleep(0.3)
            srv.release()
            for t in ts:
                t.join(timeout=30.0)
        st = srv.stats()
        assert st["batch_hw"] >= 3, st
        np.testing.assert_array_equal(results["t"][0],
                                      np.sort(x)[::-1][:3])
        np.testing.assert_array_equal(results["h"],
                                      _hist_count(x, 4, -2, 2))
        np.testing.assert_array_equal(results["s"], x * np.float32(2.0))
    finally:
        srv.stop()
        serve.reset()
