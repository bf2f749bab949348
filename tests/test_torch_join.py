"""dr_tpu_torch's join (inner/left/right/outer, the broadcast and the
partition merge, ``join_auto``) against dr_tpu on 8 CPU ranks, with the
same numpy-seeded inputs; the cases mirror the join cases of
``tests/test_relational.py``.

Every comparison is bit for bit: a join moves keys and values, and both
merge routes of the port must give the reference's rows, in its order,
with its count."""

import numpy as np
import pytest

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.utils.env import env_override
from dr_tpu_torch.algorithms import relational as t_rel

P = 8
_BITS = {2: np.int16, 4: np.int32, 8: np.int64}
ROUTES = {"broadcast": "999999999", "partition": "0"}


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


def _sides(lk, lv, rk, rv, mod, **kw):
    return [mod.distributed_vector.from_array(a, **kw)
            for a in (lk, lv, rk, rv)]


def _reference(lk, lv, rk, rv, cap, dtypes, how, fill, **kw):
    """The reference's rows (its broadcast merge) and count."""
    outs = [dr_tpu.distributed_vector(cap, d) for d in dtypes]
    with env_override(DR_TPU_JOIN_BROADCAST_MAX=ROUTES["broadcast"]):
        m = int(dr_tpu.join(*_sides(lk, lv, rk, rv, dr_tpu, **kw), *outs,
                            how=how, fill=fill))
    return m, [dr_tpu.to_numpy(o) for o in outs]


def _port(lk, lv, rk, rv, cap, dtypes, how, fill, route, **kw):
    outs = [dt.distributed_vector(cap, d) for d in dtypes]
    with env_override(DR_GPU_JOIN_BROADCAST_MAX=ROUTES[route]):
        m = dt.join(*_sides(lk, lv, rk, rv, dt, **kw), *outs, how=how,
                    fill=fill)
    assert t_rel.last_join_route()["impl"] == route
    return m, [dt.to_numpy(o) for o in outs]


def _check(lk, lv, rk, rv, cap, how="inner", fill=0,
           dtypes=(np.float32,) * 3, **kw):
    m, want = _reference(lk, lv, rk, rv, cap, dtypes, how, fill, **kw)
    for route in ROUTES:
        got_m, got = _port(lk, lv, rk, rv, cap, dtypes, how, fill, route,
                           **kw)
        assert got_m == m, (route, got_m, m)
        for g, w in zip(got, want):
            assert_bits(g, w)
    return m, want


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_matches_reference_on_both_routes(how):
    rng = np.random.default_rng(12)
    nl, nr = 31, 23
    lk = rng.integers(0, 7, nl).astype(np.float32)
    lv = rng.standard_normal(nl).astype(np.float32)
    rk = rng.integers(0, 9, nr).astype(np.float32)
    rv = rng.standard_normal(nr).astype(np.float32)
    m, _ = _check(lk, lv, rk, rv, 512, how=how, fill=-9.0)
    assert m > 0


def test_join_many_to_many_duplicates():
    lk = np.array([2, 2, 2, 5], np.int32)
    lv = np.array([1, 2, 3, 4], np.float32)
    rk = np.array([2, 2, 7], np.int32)
    rv = np.array([10, 20, 30], np.float32)
    m, (_, jl, jr) = _check(lk, lv, rk, rv, 32,
                            dtypes=(np.int32, np.float32, np.float32))
    assert m == 6
    np.testing.assert_array_equal(jl[:m], [1, 1, 2, 2, 3, 3])
    np.testing.assert_array_equal(jr[:m], [10, 20, 10, 20, 10, 20])


def test_join_disjoint_and_empty_sides():
    rng = np.random.default_rng(13)
    lk = np.arange(10, dtype=np.float32)
    lv = rng.standard_normal(10).astype(np.float32)
    rk = np.arange(100, 105, dtype=np.float32)
    rv = rng.standard_normal(5).astype(np.float32)
    assert _check(lk, lv, rk, rv, 16)[0] == 0
    assert _check(lk, lv, rk, rv, 16, how="left", fill=-1.0)[0] == 10
    assert _check(lk, lv, rk, rv, 16, how="outer", fill=-1.0)[0] == 15
    # empty windows: zero rows, or every row of the other side, filled
    cases = ((slice(3, 3), slice(None), "inner", 0),
             (slice(None), slice(0, 0), "left", 10),
             (slice(0, 0), slice(None), "outer", 5),
             (slice(0, 0), slice(None), "right", 5))
    for ls, rs, how, want in cases:
        ref_out = [dr_tpu.distributed_vector(16) for _ in range(3)]
        j = _sides(lk, lv, rk, rv, dr_tpu)
        mj = int(dr_tpu.join(j[0][ls], j[1][ls], j[2][rs], j[3][rs],
                             *ref_out, how=how, fill=-3.0))
        t = _sides(lk, lv, rk, rv, dt)
        for route in ROUTES:
            outs = [dt.distributed_vector(16) for _ in range(3)]
            with env_override(DR_GPU_JOIN_BROADCAST_MAX=ROUTES[route]):
                mt = dt.join(t[0][ls], t[1][ls], t[2][rs], t[3][rs], *outs,
                             how=how, fill=-3.0)
            assert mt == mj == want
            for g, r in zip(outs, ref_out):
                assert_bits(dt.to_numpy(g), dr_tpu.to_numpy(r))


def test_join_outer_union_interleaves_by_key():
    lk = np.array([1, 3, 3, 7], np.float32)
    lv = np.array([10, 30, 31, 70], np.float32)
    rk = np.array([0, 3, 5, 9], np.float32)
    rv = np.array([-0.5, -3.0, -5.0, -9.0], np.float32)
    m, (jk, jl, jr) = _check(lk, lv, rk, rv, 32, how="outer", fill=-1.0)
    assert m == 7
    np.testing.assert_array_equal(jk[:m], [0, 1, 3, 3, 5, 7, 9])
    np.testing.assert_array_equal(jl[:m], [-1, 10, 30, 31, -1, 70, -1])


def test_join_int_pad_sentinel_keys():
    """An int32 key equal to INT32_MAX (the pad key) must not match the
    pad rows, on either route and for every how."""
    ik = np.array([0, 5, 2 ** 31 - 1, 7, 2 ** 31 - 1, -2 ** 31], np.int32)
    jk = np.array([2 ** 31 - 1, 5, -2 ** 31, 9], np.int32)
    iv = np.arange(len(ik), dtype=np.int32)
    jv = np.arange(len(jk), dtype=np.int32)
    for how in ("inner", "outer"):
        m, _ = _check(ik, iv, jk, jv, 32, how=how, fill=-1,
                      dtypes=(np.int32,) * 3)
        assert m == (4 if how == "inner" else 7)


def test_join_signed_zero_nan_keys_and_casts():
    """-0.0 matches +0.0 and NaN matches NaN (the sort family's key
    equality); the fill casts to the right-value dtype first and, on the
    left column of an outer join, on to the left dtype."""
    lk = np.array([0.0, np.nan, 1.0, -0.0, 4.0], np.float32)
    rk = np.array([-0.0, np.nan, np.nan, 2.0], np.float32)
    lv = np.arange(5, dtype=np.float32) + 0.5
    rv = np.arange(4, dtype=np.int32)
    for how in ("inner", "outer"):
        _check(lk, lv, rk, rv, 32, how=how, fill=-2.75,
               dtypes=(np.float32, np.int32, np.int32))


def test_join_uneven_team_layouts_and_windows():
    """Inputs on distributions with empty ranks, through windows; the
    outputs on another uneven distribution."""
    rng = np.random.default_rng(35)
    n = 60
    dist = [9, 0, 20, 0, 11, 0, 20, 0]
    lk = rng.integers(0, 12, n).astype(np.float32)
    lv = rng.standard_normal(n).astype(np.float32)
    rk = rng.integers(0, 12, n).astype(np.float32)
    rv = rng.standard_normal(n).astype(np.float32)
    cap = 400
    odist = [100, 0, 0, 150, 50, 100, 0, 0]
    J = _sides(lk, lv, rk, rv, dr_tpu, distribution=dist)
    T = _sides(lk, lv, rk, rv, dt, distribution=dist)
    ref = [dr_tpu.distributed_vector(cap, distribution=odist)
           for _ in range(3)]
    with env_override(DR_TPU_JOIN_BROADCAST_MAX="999999999"):
        m = int(dr_tpu.join(J[0][5:50], J[1][5:50], J[2][10:40],
                            J[3][10:40], *ref, how="left", fill=7.0))
    for route in ROUTES:
        outs = [dt.distributed_vector(cap, distribution=odist)
                for _ in range(3)]
        with env_override(DR_GPU_JOIN_BROADCAST_MAX=ROUTES[route]):
            assert dt.join(T[0][5:50], T[1][5:50], T[2][10:40],
                           T[3][10:40], *outs, how="left", fill=7.0) == m
        for g, r in zip(outs, ref):
            assert_bits(dt.to_numpy(g), dr_tpu.to_numpy(r))


def test_join_partition_bounds_memory_and_routing():
    """Above the threshold the merge runs the partition exchange: each
    rank holds its left block plus an rcap-bounded right partition, under
    the broadcast route's gathered rows; the default threshold keeps a
    small join on the broadcast route."""
    rng = np.random.default_rng(33)
    nl, nr = 96, 64
    kl = rng.integers(0, 24, nl).astype(np.float32)
    kr = rng.integers(0, 24, nr).astype(np.float32)
    vl = rng.standard_normal(nl).astype(np.float32)
    vr = rng.standard_normal(nr).astype(np.float32)
    cap = 4 * (nl + nr)
    _port(kl, vl, kr, vr, cap, (np.float32,) * 3, "inner", 0, "broadcast")
    rb = t_rel.last_join_route()
    _port(kl, vl, kr, vr, cap, (np.float32,) * 3, "inner", 0, "partition")
    rp = t_rel.last_join_route()
    assert rp["rcap"] < rp["nshards"] * -(-nr // rp["nshards"]), rp
    assert rp["gathered_rows_per_device"] \
        < rb["gathered_rows_per_device"], (rp, rb)
    outs = [dt.distributed_vector(cap) for _ in range(3)]
    dt.join(*_sides(kl, vl, kr, vr, dt), *outs)
    assert t_rel.last_join_route()["impl"] == "broadcast"


@pytest.mark.parametrize("how", ["inner", "right", "outer"])
def test_join_auto_matches_reference(how):
    rng = np.random.default_rng(36)
    lk = rng.integers(0, 10, 40).astype(np.float32)
    lv = rng.standard_normal(40).astype(np.float32)
    rk = rng.integers(0, 14, 30).astype(np.float32)
    rv = rng.integers(-5, 5, 30).astype(np.int32)
    a = dr_tpu.join_auto(*_sides(lk, lv, rk, rv, dr_tpu), how=how,
                         fill=-1)
    for route in ROUTES:
        with env_override(DR_GPU_JOIN_BROADCAST_MAX=ROUTES[route]):
            b = dt.join_auto(*_sides(lk, lv, rk, rv, dt), how=how, fill=-1)
        assert b.count == a.count
        assert len(b.containers[0]) >= b.count
        for x, y in zip(a.arrays(), b.arrays()):
            assert_bits(y, x)
