"""dr_tpu_torch's distributed_mdarray / distributed_mdspan / transpose
against dr_tpu on the CPU (the cases of tests/test_mdarray.py).  All of
it is data movement, so every comparison is bit-exact."""

import jax
import numpy as np
import pytest

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.containers.mdarray import distributed_mdarray as j_md


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)


def _boxes(segs, rank):
    return [(rank(s), tuple(s.box)) for s in segs]


def _both(src, **kw):
    return j_md.from_array(src, **kw), dt.distributed_mdarray.from_array(
        src, **kw)


def _same_tiles(J, T, src):
    """Same tiles and owners as dr_tpu, each tile's local values, and
    each rank's padded block equal to the JAX array's shard on that
    mesh device."""
    assert T.grid == J.grid
    by_id = {sh.device.id: np.asarray(sh.data)
             for sh in J._data.addressable_shards}
    shards = [by_id[d.id] for d in J._mesh.devices.reshape(-1)]
    assert len(shards) == len(T.blocks)
    for a, b in zip(shards, T.blocks):
        np.testing.assert_array_equal(b.numpy(), a)
    segs = dt.segments(T)
    assert _boxes(segs, dt.rank) == _boxes(dr_tpu.segments(J), dr_tpu.rank)
    assert sum(len(s) for s in segs) == src.size
    for s in segs:
        want = src[tuple(slice(b, e) for b, e in s.box)]
        np.testing.assert_array_equal(s.materialize(), want)
        np.testing.assert_array_equal(dt.local(s).numpy(), want)


@pytest.mark.parametrize("shape", [(23,), (7, 10), (4, 6, 5), (8, 8),
                                   (3, 2, 4, 2)])
def test_roundtrip_and_tiles(mesh_size, shape):
    dt.init(["cpu"] * mesh_size)
    src = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    J, T = _both(src)
    np.testing.assert_array_equal(T.materialize(), src)
    _same_tiles(J, T, src)
    for s in dt.segments(T):  # trailing dims are not distributed
        assert s.box[len(T.grid):] == tuple((0, d)
                                            for d in shape[len(T.grid):])


def test_explicit_grid():
    _init_both(8)
    src = np.arange(12 * 5, dtype=np.float32).reshape(12, 5)
    J, T = _both(src, grid=(4, 2))
    np.testing.assert_array_equal(T.materialize(), src)
    _same_tiles(J, T, src)


def test_submdspan():
    _init_both(8)
    src = np.arange(12 * 9, dtype=np.float32).reshape(12, 9)
    J, T = _both(src)
    v, jv = T.submdspan(slice(2, 9), slice(1, 6)), \
        J.submdspan(slice(2, 9), slice(1, 6))
    assert v.shape == jv.shape == (7, 5) and len(v) == 35
    np.testing.assert_array_equal(v.materialize(), src[2:9, 1:6])
    vv, jvv = v.submdspan(slice(1, 4), slice(0, 2)), \
        jv.submdspan(slice(1, 4), slice(0, 2))
    np.testing.assert_array_equal(vv.materialize(), src[3:6, 1:3])
    assert _boxes(dt.segments(vv), dt.rank) == \
        _boxes(dr_tpu.segments(jvv), dr_tpu.rank)
    assert sum(len(s) for s in dt.segments(vv)) == 6
    for s in dt.segments(vv):
        np.testing.assert_array_equal(
            dt.local(s).numpy(), src[tuple(slice(b, e) for b, e in s.box)])
    row = T.submdspan(5)  # an int index keeps a length-1 axis
    np.testing.assert_array_equal(row.materialize(), src[5:6])


def test_getitem_slicing_and_elements():
    _init_both(8)
    src = np.arange(6 * 6, dtype=np.float32).reshape(6, 6)
    J, T = _both(src)
    assert T[2, 3] == J[2, 3] == src[2, 3]
    J[2, 3] = -1.0
    T[2, 3] = -1.0
    assert T[2, 3] == -1.0
    np.testing.assert_array_equal(T.materialize(), np.asarray(J.to_array()))
    v = T[1:4, 2:5]
    assert isinstance(v, dt.distributed_mdspan)
    src[2, 3] = -1.0
    np.testing.assert_array_equal(v.materialize(), src[1:4, 2:5])
    for M in (J, T):
        with pytest.raises(IndexError):
            M[6, 0]


def test_transpose_2d():
    _init_both(8)
    src = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    J, T = _both(src)
    jb, tb = j_md((12, 8), np.float32), dt.distributed_mdarray((12, 8))
    dr_tpu.transpose(jb, J)
    dt.transpose(tb, T)
    np.testing.assert_array_equal(tb.materialize(), src.T)
    _same_tiles(jb, tb, src.T)


@pytest.mark.parametrize("axes,P", [(None, 8), ((1, 2, 0), 8),
                                    ((-2, -1, 0), 4), ((2, 0, 1), 3),
                                    ((0, 2, 1), 8)])
def test_transpose_nd_axes(axes, P):
    """N-D axis permutations (the 2-D .T is the axes=None case)."""
    _init_both(P)
    src = np.random.default_rng(20).standard_normal((6, 10, 4)) \
        .astype(np.float32)
    J, T = _both(src)
    want = src.transpose(axes)
    jo, to = j_md(want.shape), dt.distributed_mdarray(want.shape)
    dr_tpu.transpose(jo, J, axes=axes)
    dt.transpose(to, T, axes=axes)
    np.testing.assert_array_equal(to.materialize(), want)
    _same_tiles(jo, to, want)


def test_transpose_refuses_like_reference():
    _init_both(8)
    src = np.zeros((6, 10, 4), np.float32)
    J, T = _both(src)
    for axes, shape in (((0, 0, 1), (10, 4, 6)), ((0, 1, 3), (6, 10, 4)),
                        ((1, 2, 0), (4, 10, 6))):
        with pytest.raises(AssertionError):
            dr_tpu.transpose(j_md(shape), J, axes=axes)
        with pytest.raises(AssertionError):
            dt.transpose(dt.distributed_mdarray(shape), T, axes=axes)


def test_graft_entry_cube(mesh_size):
    """The (2P, 6, 5) cube of the JAX package's end-to-end drive:
    transpose(axes=(2, 0, 1)) and a submdspan window."""
    dt.init(["cpu"] * mesh_size)
    a3 = 2 * mesh_size
    cube = np.arange(a3 * 6 * 5, dtype=np.float32).reshape(a3, 6, 5)
    J, T = _both(cube)
    jo, to = j_md((5, a3, 6)), dt.distributed_mdarray((5, a3, 6))
    dr_tpu.transpose(jo, J, axes=(2, 0, 1))
    dt.transpose(to, T, axes=(2, 0, 1))
    np.testing.assert_array_equal(to.materialize(), np.asarray(jo.to_array()))
    np.testing.assert_array_equal(to.materialize(),
                                  np.transpose(cube, (2, 0, 1)))
    w = T.submdspan(slice(1, a3), slice(2, 5), slice(0, 3))
    np.testing.assert_array_equal(w.materialize(), cube[1:, 2:5, 0:3])
