"""dr_tpu_torch's dense_matrix, partitions, matrix views and gemm against
dr_tpu on the CPU (the dense and cyclic cases of tests/test_matrix.py).

Data movement is bit-exact: the port's per-rank blocks equal the JAX
array's shards device by device.  gemm is an f32 product on both sides,
within rtol 1e-5 / atol 1e-5 of each other (two summation orders over
k <= 16 terms of O(1) products) and of numpy."""

import jax
import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt

DIV = dt.tile.div
GEMM_TOL = dict(rtol=1e-5, atol=1e-5)


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)


def _parts(tile=(DIV, DIV), grid=None):
    return (dr_tpu.block_cyclic(tile=tile, grid=grid),
            dt.block_cyclic(tile=tile, grid=grid))


def _both(src, tile=(DIV, DIV), grid=None):
    jp, tp = _parts(tile, grid)
    return (dr_tpu.dense_matrix.from_array(src, jp),
            dt.dense_matrix.from_array(src, tp))


def _jshards(J):
    """The JAX matrix's shards as numpy, in mesh (rank) order."""
    by_id = {sh.device.id: np.asarray(sh.data)
             for sh in J._data.addressable_shards}
    return [by_id[d.id] for d in J._mesh.devices.reshape(-1)]


def _same_state(J, T):
    assert T.layout == J.layout
    js = _jshards(J)
    assert len(js) == len(T.shards)
    for a, b in zip(js, T.shards):
        np.testing.assert_array_equal(b.numpy(), a)


def test_factor_tile_rank_and_row_tiles():
    for n in range(1, 33):
        assert dt.factor(n) == dr_tpu.factor(n)
    for grid in ((2, 4), (1, 3), (3, 1)):
        jp, tp = _parts(grid=grid)
        for i in range(7):
            for j in range(7):
                assert tp.tile_rank(i, j) == jp.tile_rank(i, j)
        for shape in ((16, 12), (17, 23), (1, 5)):
            assert tp.tile_shape(shape) == jp.tile_shape(shape)
    jp, tp = _parts(tile=(4, 3), grid=(2, 2))
    assert tp.tile_shape((10, 7)) == jp.tile_shape((10, 7)) == (4, 3)
    assert not tp.is_block() and _parts()[1].is_block()
    assert dt.row_tiles(5) == dt.block_cyclic(grid=(5, 1))
    dt.init(["cpu"] * 3)
    assert dt.row_tiles().grid == (3, 1)


@pytest.mark.parametrize("shape", [(7, 9), (8, 8), (17, 23), (1, 1)])
def test_roundtrip_and_shards_match_reference(mesh_size, shape):
    dt.init(["cpu"] * mesh_size)
    src = np.arange(shape[0] * shape[1], dtype=np.float32).reshape(shape)
    J, T = _both(src)
    np.testing.assert_array_equal(T.materialize(), src)
    _same_state(J, T)
    assert T.grid_shape == J.grid_shape and T.tile_shape == J.tile_shape
    assert T.grid_tiles == J.grid_tiles and T.is_block == J.is_block


def test_segments_tiles_and_local_tiles(mesh_size):
    dt.init(["cpu"] * mesh_size)
    src = np.random.default_rng(0).standard_normal((10, 12)) \
        .astype(np.float32)
    J, T = _both(src)
    segs = dt.segments(T)
    assert [(dt.rank(s), s.rb, s.re, s.cb, s.ce) for s in segs] == \
        [(dr_tpu.rank(s), s.rb, s.re, s.cb, s.ce)
         for s in dr_tpu.segments(J)]
    assert sum(len(s) for s in segs) == 10 * 12
    assert {dt.rank(s) for s in segs} <= set(range(mesh_size))
    for t in T.tiles():
        np.testing.assert_array_equal(t.materialize(),
                                      src[t.rb:t.re, t.cb:t.ce])
        np.testing.assert_array_equal(dt.local(t).numpy(),
                                      src[t.rb:t.re, t.cb:t.ce])
        assert t.shape == (t.re - t.rb, t.ce - t.cb)
        assert t.origin == dt.Index2D(t.rb, t.cb)
    nti, ntj = T.grid_tiles
    last = T.tile((nti - 1, ntj - 1))
    assert (last.re, last.ce) == (10, 12)


def test_element_access():
    _init_both(8)
    J, T = _both(np.zeros((5, 5), np.float32))
    J[2, 3] = 7.0
    T[2, 3] = 7.0
    assert T[2, 3] == J[2, 3] == 7.0
    assert T[-3, -2] == 7.0
    _same_state(J, T)
    for bad in ((5, 0), (0, 5), (-6, 0)):
        with pytest.raises(IndexError):
            J[bad]
        with pytest.raises(IndexError):
            T[bad]


def test_row_tiles_partition():
    _init_both(8)
    T = dt.dense_matrix((16, 4), partition=dt.row_tiles())
    J = dr_tpu.dense_matrix((16, 4), partition=dr_tpu.row_tiles())
    assert T.grid_shape == J.grid_shape == (8, 1)
    assert T.layout == J.layout


def test_dense_matrix_view_and_rows():
    _init_both(8)
    src = np.arange(36, dtype=np.float32).reshape(6, 6)
    J, T = _both(src)
    v, jv = T[1:4, 2:5], J[1:4, 2:5]
    assert v.shape == jv.shape == (3, 3)
    np.testing.assert_array_equal(v.materialize(), src[1:4, 2:5])
    assert [(dt.rank(s), s.rb, s.re, s.cb, s.ce) for s in dt.segments(v)] \
        == [(dr_tpu.rank(s), s.rb, s.re, s.cb, s.ce)
            for s in dr_tpu.segments(jv)]
    assert sum(len(s) for s in dt.segments(v)) == 9
    np.testing.assert_array_equal(v.row(0).materialize(), src[1, 2:5])
    np.testing.assert_array_equal(v.column(1).materialize(), src[1:4, 3])
    assert list(v.row(2)) == list(src[3, 2:5])
    assert v.row(1)[2] == src[2, 4] and v.column(0)[1] == src[2, 2]
    assert len(v.row(0)) == 3 and len(v.column(0)) == 3
    w = T[4, 1:]  # an int and a slice: a one-row window
    np.testing.assert_array_equal(w.materialize(), src[4:5, 1:])


def test_matrix_entry_iteration():
    _init_both(8)
    src = np.arange(4, dtype=np.float32).reshape(2, 2)
    J, T = _both(src, grid=(1, 1))
    got = [(e.index.i, e.index.j, float(e.value)) for e in T.tiles()[0]]
    assert got == [(e.index.i, e.index.j, float(e.value))
                   for e in J.tiles()[0]]
    assert got == [(0, 0, 0.0), (0, 1, 1.0), (1, 0, 2.0), (1, 1, 3.0)]
    idx, val = dt.matrix_entry((1, 0), 2.0)
    assert idx == (1, 0) and val == 2.0


@pytest.mark.parametrize("tile,grid,P", [((DIV, DIV), None, 8),
                                         ((4, 4), None, 8),
                                         ((4, 4), (2, 2), 4),
                                         ((8, 4), (1, 3), 3)])
def test_gemm_matches_reference(tile, grid, P):
    _init_both(P)
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 12)).astype(np.float32)
    b = rng.standard_normal((12, 8)).astype(np.float32)
    jp, tp = _parts(tile, grid)
    C = dt.gemm(dt.dense_matrix.from_array(a, tp),
                dt.dense_matrix.from_array(b, tp))
    JC = dr_tpu.gemm(dr_tpu.dense_matrix.from_array(a, jp),
                     dr_tpu.dense_matrix.from_array(b, jp))
    assert C.layout == JC.layout
    np.testing.assert_allclose(C.materialize(), JC.materialize(), **GEMM_TOL)
    np.testing.assert_allclose(C.materialize(), a @ b, **GEMM_TOL)
    out = dt.dense_matrix((16, 8), partition=tp)
    assert dt.gemm(dt.dense_matrix.from_array(a, tp),
                   dt.dense_matrix.from_array(b, tp), out) is out
    np.testing.assert_array_equal(out.materialize(), C.materialize())


# ---------------------------------------------------------------- cyclic

@pytest.mark.parametrize("shape,tile", [((24, 20), (4, 4)),
                                        ((24, 16), (8, 4)),
                                        ((16, 16), (4, 4)),
                                        ((10, 7), (4, 4))])
def test_cyclic_roundtrip_segments_and_local_tiles(shape, tile):
    _init_both(8)
    src = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    J, T = _both(src, tile, dt.factor(8))
    assert not T.is_block
    np.testing.assert_array_equal(T.materialize(), src)
    _same_state(J, T)
    segs = dt.segments(T)
    assert [(dt.rank(s), s.rb, s.re, s.cb, s.ce) for s in segs] == \
        [(dr_tpu.rank(s), s.rb, s.re, s.cb, s.ce)
         for s in dr_tpu.segments(J)]
    assert sum(len(s) for s in segs) == shape[0] * shape[1]
    for t in segs:
        np.testing.assert_array_equal(t.materialize(),
                                      src[t.rb:t.re, t.cb:t.ce])
        np.testing.assert_array_equal(dt.local(t).numpy(),
                                      np.asarray(dr_tpu.local(J.tile(
                                          (t.rb // tile[0],
                                           t.cb // tile[1])))))


def test_cyclic_tile_rank_round_robin():
    _init_both(4)
    src = np.arange(16 * 16, dtype=np.float32).reshape(16, 16)
    J, T = _both(src, (4, 4), (2, 2))
    assert T.grid_tiles == J.grid_tiles == (4, 4)
    for t in T.tiles():
        i, j = t.rb // 4, t.cb // 4
        assert dt.rank(t) == (i % 2) * 2 + (j % 2)


def test_cyclic_element_and_batched_access():
    _init_both(8)
    J, T = _both(np.zeros((12, 12), dtype=np.float32), (4, 4), (2, 4))
    for M in (J, T):
        M[5, 7] = 3.0
        M.put([1, 9], [2, 11], [4.0, 5.0])
        M.put([-1], [0], [6.0])
    assert T[5, 7] == 3.0
    got = T.get([1, 9, 5, -1], [2, 11, 7, 0])
    np.testing.assert_array_equal(got.numpy(), [4.0, 5.0, 3.0, 6.0])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.get([1, 9, 5, -1], [2, 11, 7, 0])))
    _same_state(J, T)
    arr = T.materialize()
    assert arr[1, 2] == 4.0 and arr[9, 11] == 5.0 and arr[5, 7] == 3.0
    for rows, cols in (([12], [0]), ([0], [12]), ([-13], [0])):
        with pytest.raises(IndexError):
            J.get(rows, cols)
        with pytest.raises(IndexError):
            T.get(rows, cols)
        with pytest.raises(IndexError):
            T.put(rows, cols, [1.0])


def test_cyclic_mesh_sweep(mesh_size):
    """Cyclic placement across the rank sweep: round-robin tile_rank,
    roundtrip, gemm, and the 2-D stencil on a cyclic layout, each against
    dr_tpu."""
    dt.init(["cpu"] * mesh_size)
    rng = np.random.default_rng(30 + mesh_size)
    gp, gq = dt.factor(mesh_size)
    src = rng.standard_normal((16, 16)).astype(np.float32)
    J, T = _both(src, (4, 4), (gp, gq))
    np.testing.assert_array_equal(T.materialize(), src)
    _same_state(J, T)
    for t in T.tiles():
        i, j = t.rb // 4, t.cb // 4
        assert dt.rank(t) == (i % gp) * gq + (j % gq)
    JB, TB = _both(src, (4, 4), (gp, gq))
    np.testing.assert_allclose(dt.gemm(T, TB).materialize(),
                               dr_tpu.gemm(J, JB).materialize(), **GEMM_TOL)
    w = dt.heat_step_weights(0.25)
    out = dt.stencil2d_iterate(T, TB, w, steps=2)
    ref = dr_tpu.stencil2d_iterate(J, JB, w, steps=2)
    np.testing.assert_allclose(out.materialize(), ref.materialize(),
                               rtol=1e-5, atol=1e-6)
    _same_state(JB, TB)


@pytest.mark.parametrize("shape,tile,grid", [
    ((17, 23), (DIV, DIV), None),
    ((24, 20), (4, 4), None),
    ((10, 7), (4, 3), (2, 2)),
    ((9, 9), (DIV, DIV), (1, 1)),
])
def test_from_reference_state_matrix(shape, tile, grid):
    """A JAX matrix's stored, folded array lands in the port unchanged,
    rank by rank."""
    _init_both(8)
    src = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    jp, _ = _parts(tile, grid)
    J = dr_tpu.dense_matrix.from_array(src, jp)
    J[shape[0] - 1, 0] = -4.0
    T = dt.dense_matrix.from_reference_state(J.layout, np.asarray(J._data))
    _same_state(J, T)
    np.testing.assert_array_equal(T.materialize(), J.materialize())
    assert T.dtype == torch.float32


def test_from_reference_state_refuses_a_runtime_too_small():
    _init_both(8)
    J = dr_tpu.dense_matrix.from_array(np.ones((8, 8), np.float32))
    dt.init(["cpu"] * 2)
    with pytest.raises(ValueError):
        dt.dense_matrix.from_reference_state(J.layout, np.asarray(J._data))
