"""dr_tpu_torch's ``redistribute`` against dr_tpu on the CPU.

A re-layout is data movement, so every comparison is bit for bit: the
logical value against numpy, the port's collective route against its
host-staged route, and both routes' physical rows (pad, halo and tail
cells included) against dr_tpu's ``_data`` after the same hops."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.parallel.runtime import Runtime as JRuntime
from dr_tpu_torch.parallel import redistribute as rdx
from dr_tpu_torch.parallel.runtime import Runtime as TRuntime

DTYPES = [np.float32, np.int32, np.float16, np.uint8]


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    return dt.init(["cpu"] * P)


def _rows(v):
    return np.concatenate([r.numpy() for r in v.rows])


def _values(n, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, n).astype(np.uint8)
    return (rng.standard_normal(n) * 50).astype(dtype)


def _cut(n, P, rng):
    cuts = np.sort(rng.integers(0, n + 1, size=P - 1))
    b = np.concatenate(([0], cuts, [n]))
    return [int(y - x) for x, y in zip(b[:-1], b[1:])]


def test_roundtrip_and_validation(mesh_size):
    """The JAX package's round trip (test_elastic.py:81): even -> team
    -> uneven -> even, the value kept, algorithms answering, a bad
    distribution refused with the vector untouched."""
    _init_both(mesh_size)
    P = mesh_size
    n = 4 * P
    src = np.arange(n, dtype=np.float32)
    v = dt.distributed_vector.from_array(src)
    j = dr_tpu.distributed_vector.from_array(src)
    for d in ([n] + [0] * (P - 1), [1] * (P - 1) + [n - (P - 1)], None):
        assert dt.redistribute(v, d) is v
        dr_tpu.redistribute(j, d)
        assert v.layout == j.layout
        np.testing.assert_array_equal(dt.to_numpy(v), src)
        np.testing.assert_array_equal(_rows(v), np.asarray(j._data))
    assert v.distribution is None
    assert dt.reduce(v) == float(src.sum())  # exact: integers below 2^24
    rows = v.rows
    with pytest.raises(ValueError):
        dt.redistribute(v, [n] + [0] * P)  # wrong shard count
    with pytest.raises(ValueError):
        dt.redistribute(v, [n + 1] + [0] * (P - 1))  # wrong total
    assert all(a is b for a, b in zip(v.rows, rows))
    np.testing.assert_array_equal(dt.to_numpy(v), src)


@pytest.mark.parametrize("dtype", DTYPES)
def test_routes_bit_identical_to_each_other_and_reference(dtype):
    """Uneven cuts, zero-size team blocks and a halo vector, through the
    collective route, the host-staged route and dr_tpu: the same rows
    after every hop (test_elastic.py:1185, test_fuzz.py:1387's
    contract on fixed hops)."""
    P = 8
    _init_both(P)
    rng = np.random.default_rng(5)
    n = 4 * P + 3
    src = _values(n, dtype, seed=6)
    hops = [None, [n] + [0] * (P - 1), _cut(n, P, rng),
            [0, 0, 0, n, 0, 0, 0, 0], [1] * (P - 1) + [n - (P - 1)],
            _cut(n, P, rng), None]
    va = dt.distributed_vector.from_array(src)
    vb = dt.distributed_vector.from_array(src)
    j = dr_tpu.distributed_vector.from_array(src)
    rt = dt.runtime()
    for d in hops:
        rdx._collective(va, d, rt)
        rdx._host_staged(vb, d, rt)
        dr_tpu.redistribute(j, d)
        tag = f"{np.dtype(dtype)} {d}"
        assert va.layout == vb.layout == j.layout, tag
        np.testing.assert_array_equal(_rows(va), _rows(vb), err_msg=tag)
        np.testing.assert_array_equal(_rows(va), np.asarray(j._data),
                                      err_msg=tag)
        np.testing.assert_array_equal(dt.to_numpy(va), src, err_msg=tag)
    # a halo vector keeps the uniform layout: a move onto the same one
    hsrc = src[:4 * P]  # every rank owns a cell, as a halo needs
    ha = dt.distributed_vector.from_array(hsrc, halo=dt.halo_bounds(1, 2))
    hb = dt.distributed_vector.from_array(hsrc, halo=dt.halo_bounds(1, 2))
    hj = dr_tpu.distributed_vector.from_array(
        hsrc, halo=dr_tpu.halo_bounds(1, 2))
    rdx._collective(ha, None, rt)
    rdx._host_staged(hb, None, rt)
    dr_tpu.redistribute(hj, None)
    np.testing.assert_array_equal(_rows(ha), _rows(hb))
    np.testing.assert_array_equal(_rows(ha), np.asarray(hj._data))


def test_halo_vector(mesh_size):
    """A halo vector keeps its bounds across the move (test_elastic.py:134),
    its rows equal dr_tpu's, and the rebuilt halo exchanges."""
    _init_both(mesh_size)
    n = 4 * mesh_size
    src = np.arange(n, dtype=np.float32)
    v = dt.distributed_vector.from_array(
        src, halo=dt.halo_bounds(1, 1, periodic=True))
    j = dr_tpu.distributed_vector.from_array(
        src, halo=dr_tpu.halo_bounds(1, 1, periodic=True))
    dt.halo(v).exchange()  # ghosts set: the move leaves them zero
    dr_tpu.halo(j).exchange()
    dt.redistribute(v, None)
    dr_tpu.redistribute(j, None)
    np.testing.assert_array_equal(_rows(v), np.asarray(j._data))
    assert v.halo_bounds.prev == 1 and v.halo() is not None
    v.halo().exchange()
    j.halo().exchange()
    np.testing.assert_array_equal(_rows(v), np.asarray(j._data))
    np.testing.assert_array_equal(dt.to_numpy(v), src)
    if mesh_size > 1:
        with pytest.raises(ValueError):  # halos need the uniform layout
            dt.redistribute(v, [n] + [0] * (mesh_size - 1))
        np.testing.assert_array_equal(dt.to_numpy(v), src)


def test_cross_runtime():
    """A second runtime over fewer ranks (test_elastic.py:103) takes the
    host-staged route; rows equal dr_tpu's on its two-device mesh."""
    _init_both(8)
    small_t = TRuntime(["cpu"] * 2)
    small_j = JRuntime(mesh=Mesh(np.asarray(jax.devices()[1:3]), ("x",)))
    src = np.arange(10, dtype=np.float32)
    v = dt.distributed_vector.from_array(src)
    j = dr_tpu.distributed_vector.from_array(src)
    dt.redistribute(v, [4, 6], runtime=small_t)
    dr_tpu.redistribute(j, [4, 6], runtime=small_j)
    assert v.runtime is small_t and v.nshards == 2
    np.testing.assert_array_equal(_rows(v), np.asarray(j._data))
    dt.redistribute(v, None)  # back onto the global runtime
    dr_tpu.redistribute(j, None)
    assert v.nshards == 8
    np.testing.assert_array_equal(_rows(v), np.asarray(j._data))
    np.testing.assert_array_equal(dt.to_numpy(v), src)


def test_failed_redistribute_leaves_vector_intact():
    """A rejected re-layout (sizes for another runtime,
    test_elastic.py:625) and a failure inside the exchange both leave
    the vector exactly as it was."""
    _init_both(8)
    src = np.arange(12, dtype=np.float32)
    v = dt.distributed_vector.from_array(src, distribution=[3, 0, 9, 0, 0,
                                                            0, 0, 0])
    layout, rows, rt = v.layout, v.rows, v.runtime
    small = TRuntime(["cpu"] * 2)
    with pytest.raises(ValueError):
        dt.redistribute(v, [12] + [0] * 7, runtime=small)
    assert v.layout == layout and v.runtime is rt
    assert all(a is b for a, b in zip(v.rows, rows))

    def boom(*a, **k):
        raise RuntimeError("exchange failed")

    saved = rdx.exchange_rows
    rdx.exchange_rows = boom
    try:
        with pytest.raises(RuntimeError):
            dt.redistribute(v, None)
    finally:
        rdx.exchange_rows = saved
    assert v.layout == layout and v.distribution.sizes[2] == 9
    assert all(a is b for a, b in zip(v.rows, rows))
    np.testing.assert_array_equal(dt.to_numpy(v), src)
    assert dt.reduce(v) == float(src.sum())


def test_matrix_and_mdarray_reblock():
    """Matrices re-block through a snapshot (test_elastic.py:125), in
    place, onto the target runtime's default partition."""
    _init_both(8)
    src = np.arange(24, dtype=np.float32).reshape(6, 4)
    m = dt.distributed_mdarray.from_array(src)
    assert dt.redistribute(m) is m
    np.testing.assert_array_equal(m.materialize(), src)
    with pytest.raises(ValueError):
        dt.redistribute(m, [3, 3])  # distributions are a vector contract
    d = dt.dense_matrix.from_array(src)
    small = TRuntime(["cpu"] * 2)
    dt.redistribute(d, runtime=small)
    assert d.runtime is small and d.grid_shape == (1, 2)
    np.testing.assert_array_equal(d.materialize(), src)
    sp = dt.sparse_matrix.from_dense(np.eye(6, dtype=np.float32))
    dt.redistribute(sp, runtime=small)
    assert sp.nshards == 2
    np.testing.assert_array_equal(sp.to_dense(), np.eye(6))


def test_plan_moves_matches_reference():
    """The host plan is the JAX package's, hop for hop."""
    from dr_tpu.parallel.redistribute import plan_moves as jplan
    P = 8
    _init_both(P)
    rng = np.random.default_rng(9)
    n = 53
    for a, b in ((None, [n] + [0] * 7), (_cut(n, P, rng), _cut(n, P, rng)),
                 ([0] * 7 + [n], None)):
        tv = dt.distributed_vector(n, distribution=a)
        tw = dt.distributed_vector(n, distribution=b)
        jv = dr_tpu.distributed_vector(n, distribution=a)
        jw = dr_tpu.distributed_vector(n, distribution=b)
        ts, tm = rdx.plan_moves(tv.layout, tw.layout)
        js, jm = jplan(jv.layout, jw.layout)
        assert tm == jm and len(ts) == len(js)
        for (t1, b1, l1, n1), (t2, b2, l2, n2) in zip(ts, js):
            assert (t1, b1) == (t2, b2)
            np.testing.assert_array_equal(l1, l2)
            np.testing.assert_array_equal(n1, n2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_value_contract_random_hops(seed):
    """test_fuzz.py:1328's value contract on fixed seeds: random
    distributions (teams, uneven cuts) and random target runtimes keep
    the value bit for bit, and reduce keeps answering."""
    P = 8
    _init_both(P)
    rng = np.random.default_rng(1700 + seed)
    pool = [None] + [TRuntime(["cpu"] * int(rng.integers(1, P + 1)))
                     for _ in range(3)]

    def dist(n, rt):
        p = rt.nprocs if rt is not None else P
        roll = int(rng.integers(0, 3))
        if p < 2 or roll == 0:
            return None
        if roll == 1:
            sizes = [0] * p
            sizes[int(rng.integers(0, p))] = n
            return sizes
        return _cut(n, p, rng)

    for it in range(4):
        n = int(rng.integers(1, 200))
        src = rng.standard_normal(n).astype(np.float32)
        rt0 = pool[int(rng.integers(0, len(pool)))]
        v = dt.distributed_vector.from_array(src, distribution=dist(n, rt0),
                                             runtime=rt0)
        for hop in range(3):
            rt = pool[int(rng.integers(0, len(pool)))]
            dt.redistribute(v, dist(n, rt), runtime=rt)
            np.testing.assert_array_equal(dt.to_numpy(v), src,
                                          err_msg=f"it={it} hop={hop}")
        want = float(src.astype(np.float64).sum())
        # an f32 sum of up to 200 normals in some order
        assert abs(dt.reduce(v) - want) <= 1e-3 * max(1.0, abs(want))


def test_routing():
    """The same device list takes the collective route; another list
    takes the host-staged one."""
    _init_both(4)
    v = dt.distributed_vector.from_array(np.arange(9, dtype=np.float32))
    seen = []
    saved = rdx._collective, rdx._host_staged
    rdx._collective = lambda *a: seen.append("collective")
    rdx._host_staged = lambda *a: seen.append("host")
    try:
        dt.redistribute(v, [9, 0, 0, 0])
        dt.redistribute(v, None, runtime=TRuntime(["cpu"] * 4))
        dt.redistribute(v, None, runtime=TRuntime(["cpu"] * 3))
    finally:
        rdx._collective, rdx._host_staged = saved
    assert seen == ["collective", "collective", "host"]
    assert isinstance(v.rows[0], torch.Tensor)
