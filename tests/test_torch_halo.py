"""dr_tpu_torch halo exchange and ghost->owner reduce against dr_tpu.

Both packages start from the same state (``from_reference_state``
carries the JAX rows over, ghosts included) and every comparison is
bit-exact: an exchange is copies, and each fold is one elementwise op on
the same operands."""

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
