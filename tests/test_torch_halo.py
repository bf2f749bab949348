"""dr_tpu_torch halo exchange and ghost->owner reduce against dr_tpu.

Both packages start from the same state (``from_reference_state``
carries the JAX rows over, ghosts included) and every comparison is
bit-exact: an exchange is copies, and each fold is one elementwise op on
the same operands."""

import gc
import weakref

import jax
import numpy as np
import pytest

import dr_tpu
import dr_tpu_torch as dt

OPS = ["second", "plus", "max", "min", "multiplies"]


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)


def _pair(n, prev, nxt, periodic, seed):
    """A JAX container with random owned AND ghost cells, and its port twin."""
    rng = np.random.default_rng(seed)
    j = dr_tpu.distributed_vector.from_array(
        rng.standard_normal(n).astype(np.float32),
        halo=dr_tpu.halo_bounds(prev, nxt, periodic))
    rows = rng.standard_normal(np.asarray(j._data).shape).astype(np.float32)
    j._data = jax.device_put(rows, j._data.sharding)
    t = dt.from_reference_state(j.layout, j.halo_bounds, rows)
    return j, t


def _same(j, t):
    np.testing.assert_array_equal(
        np.concatenate([r.numpy() for r in t.rows]), np.asarray(j._data))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("n,prev,nxt", [(64, 2, 2), (61, 3, 1), (45, 0, 2),
                                        (40, 1, 0)])
def test_exchange_bit_exact(mesh_size, n, prev, nxt, periodic):
    _init_both(mesh_size)
    j, t = _pair(n, prev, nxt, periodic, seed=n + prev)
    dr_tpu.halo(j).exchange()
    dt.halo(t).exchange()
    _same(j, t)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("periodic", [False, True])
def test_reduce_bit_exact(mesh_size, op, periodic):
    _init_both(mesh_size)
    j, t = _pair(53, 2, 3, periodic, seed=len(op))
    dr_tpu.halo(j).reduce(op)
    dt.halo(t).reduce(op)
    _same(j, t)


def test_exchange_n_and_async_forms():
    _init_both(8)
    j, t = _pair(96, 4, 4, True, seed=3)
    dr_tpu.halo(j).exchange_n(3)
    dt.halo(t).exchange_n(3)
    _same(j, t)
    dr_tpu.halo(j).reduce_plus()
    dt.halo(t).reduce_begin("plus")
    dt.halo(t).reduce_finalize()
    _same(j, t)
    dr_tpu.halo(j).exchange_begin()
    dr_tpu.halo(j).exchange_finalize()
    dt.halo(t).exchange_begin()
    dt.halo(t).exchange_finalize()
    _same(j, t)
    for name in ("reduce_max", "reduce_min", "reduce_multiplies"):
        getattr(dr_tpu.halo(j), name)()
        getattr(dt.halo(t), name)()
        _same(j, t)
    assert dt.halo(t[2:9]) is t.halo()
    with pytest.raises(ValueError):
        dt.distributed_vector(10).halo()


@pytest.mark.parametrize("op", ["min", "max"])
def test_reduce_min_max_signed_zeros_and_nan(op):
    """Ghost and owned cells of +-0.0 and NaN fold as XLA's min/max do
    (-0.0 below +0.0, NaN propagates): bit-exact against dr_tpu,
    compared as int32 with NaN matching NaN."""
    _init_both(4)
    j, t = _pair(32, 2, 2, True, seed=3)
    rows = np.asarray(j._data).copy()
    vals = np.array([0.0, -0.0, np.nan, 1.0], np.float32)
    rows[:] = vals[np.random.default_rng(5).integers(0, 4, rows.shape)]
    j._data = jax.device_put(rows, j._data.sharding)
    t = dt.from_reference_state(j.layout, j.halo_bounds, rows)
    dr_tpu.halo(j).reduce(op)
    dt.halo(t).reduce(op)
    got = np.concatenate([r.numpy() for r in t.rows])
    ref = np.asarray(j._data)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_array_equal(got[ok].view(np.int32),
                                  ref[ok].view(np.int32))



@pytest.mark.parametrize("drive", ["exchange", "stencil_iterate_blocked"])
def test_dropped_halo_vector_is_freed_without_the_cycle_collector(drive):
    """The halo refers to its vector weakly, so dropping a halo-bearing
    vector frees it and its rows at once, with the cycle collector off,
    after an exchange or after K2's path; its halo then raises."""
    dt.init(["cpu"])
    gc.disable()
    try:
        v = dt.distributed_vector.from_array(
            np.arange(2048, dtype=np.float32),
            halo=dt.halo_bounds(1024, 1024, periodic=True))
        h = v.halo()
        if drive == "exchange":
            h.exchange()
        else:
            dt.stencil_iterate_blocked(v, [0.25, 0.5, 0.25], 4, time_block=2)
        ref, row = weakref.ref(v), weakref.ref(v.rows[0])
        del v
        assert ref() is None and row() is None
        with pytest.raises(ReferenceError, match="freed"):
            h.exchange()
    finally:
        gc.enable()
