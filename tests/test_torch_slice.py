"""The port's slices end to end on CPU ranks, both packages fed the same
numpy state.  1-D, on 8 ranks: halo'd vector -> periodic exchange ->
iterated 5-point stencil (stepwise, composed K1 and blocked K2 paths) ->
dot / dot_n -> inclusive and exclusive scans and inclusive_scan_n.
2-D, on 4 ranks: the tiled heat stencil, the K5 path, gemm and the
mdarray transpose."""

import jax
import numpy as np

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.algorithms.stencil import (stencil_iterate_blocked,
                                       stencil_iterate_matmul)

W5 = [0.05, 0.25, 0.4, 0.25, 0.05]


def test_slice_end_to_end_on_8_ranks():
    dr_tpu.init(jax.devices()[:8])
    dt.init(["cpu"] * 8)
    n = 8 * 2048
    src = np.random.default_rng(2026).standard_normal(n).astype(np.float32)

    # halo'd vector + periodic exchange: copies, bit-exact
    j = dr_tpu.distributed_vector.from_array(
        src, halo=dr_tpu.halo_bounds(2, 2, periodic=True))
    t = dt.distributed_vector.from_array(
        src, halo=dt.halo_bounds(2, 2, periodic=True))
    dr_tpu.halo(j).exchange()
    dt.halo(t).exchange()
    np.testing.assert_array_equal(
        np.concatenate([r.numpy() for r in t.rows]), np.asarray(j._data))

    # stepwise stencil: 12 f32 weighted steps on both sides
    jb = dr_tpu.distributed_vector(n, halo=dr_tpu.halo_bounds(2, 2, True))
    tb = dt.distributed_vector(n, halo=dt.halo_bounds(2, 2, True))
    jr = dr_tpu.stencil_iterate(j, jb, W5, steps=12)
    tr = dt.stencil_iterate(t, tb, W5, steps=12)
    np.testing.assert_allclose(dt.to_numpy(tr), dr_tpu.to_numpy(jr),
                               rtol=1e-5, atol=1e-5)

    # K1 path (composed operator, k=64 -> one lane column of reach) and
    # K2 path (T=8 per pass): the plain versions here, f32 vs the JAX
    # XLA P-form / interpret-mode kernel
    jm = dr_tpu.distributed_vector.from_array(
        src, halo=dr_tpu.halo_bounds(128, 128, True))
    tm = dt.distributed_vector.from_array(
        src, halo=dt.halo_bounds(128, 128, True))
    stencil_iterate_matmul(jm, W5, 96, k_block=64)
    dt.stencil_iterate_matmul(tm, W5, 96, k_block=64)
    np.testing.assert_allclose(dt.to_numpy(tm), dr_tpu.to_numpy(jm),
                               rtol=2e-4, atol=2e-5)
    jk = dr_tpu.distributed_vector.from_array(
        src, halo=dr_tpu.halo_bounds(1024, 1024, True))
    tk = dt.distributed_vector.from_array(
        src, halo=dt.halo_bounds(1024, 1024, True))
    stencil_iterate_blocked(jk, W5, 20, time_block=8)
    dt.stencil_iterate_blocked(tk, W5, 20, time_block=8)
    np.testing.assert_allclose(dt.to_numpy(tk), dr_tpu.to_numpy(jk),
                               rtol=0, atol=1e-6)

    # dot / dot_n over the stepped state (halo-free copies: the dot_n
    # kernel route), f32 sums in two orders: 1e-5 relative
    state = dr_tpu.to_numpy(jm)
    jx = dr_tpu.distributed_vector.from_array(state)
    tx = dt.distributed_vector.from_array(dt.to_numpy(tm))
    jy = dr_tpu.distributed_vector.from_array(src)
    ty = dt.distributed_vector.from_array(src)
    scale = float(np.abs(state) @ np.abs(src))
    assert abs(dt.dot(tx, ty) - dr_tpu.dot(jx, jy)) <= 1e-5 * scale
    assert abs(float(dt.dot_n(tx, ty, 4)) - float(dr_tpu.dot_n(jx, jy, 4))) \
        <= 1e-5 * scale

    # scans (the K4 route: 2048-cell segments are lane-chunkable)
    jo, to = dr_tpu.distributed_vector(n), dt.distributed_vector(n)
    dr_tpu.inclusive_scan(jy, jo)
    dt.inclusive_scan(ty, to)
    np.testing.assert_allclose(dt.to_numpy(to), dr_tpu.to_numpy(jo),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(dt.to_numpy(to),
                               np.cumsum(src.astype(np.float64)),
                               rtol=1e-4, atol=1e-3)
    dr_tpu.exclusive_scan(jy, jo)
    dt.exclusive_scan(ty, to)
    np.testing.assert_allclose(dt.to_numpy(to), dr_tpu.to_numpy(jo),
                               rtol=1e-4, atol=1e-3)
    dr_tpu.inclusive_scan_n(jx, jo, 2)
    dt.inclusive_scan_n(tx, to, 2)
    ref = dr_tpu.to_numpy(jo)
    assert np.abs(dt.to_numpy(to) - ref).max() <= 1e-4 * np.abs(ref).max()


def test_2d_slice_end_to_end_on_4_ranks():
    """The 2-D heat slice on a 2x2 grid of 4 CPU ranks, both packages fed
    the same numpy state: tiled heat stencil in block and block-cyclic
    layouts, the single-tile blocked path (K5's plain version here, the
    interpret-mode Pallas kernel in dr_tpu), gemm, and a 3-D mdarray
    transpose and submdspan."""
    from dr_tpu.algorithms.stencil2d import (stencil2d_iterate_blocked,
                                             stencil2d_n)
    dr_tpu.init(jax.devices()[:4])
    dt.init(["cpu"] * 4)
    m = 40
    src = np.random.default_rng(2027).standard_normal((m, 128)) \
        .astype(np.float32)
    w = dr_tpu.heat_step_weights(0.25)

    # tiled path: block (one tile per rank) and cyclic (8x16 tiles); the
    # state enters the port from dr_tpu's stored arrays, bit-exact
    for tile in (None, (8, 16)):
        jp = None if tile is None else dr_tpu.block_cyclic(tile=tile)
        JA = dr_tpu.dense_matrix.from_array(src, jp)
        JB = dr_tpu.dense_matrix.from_array(src, jp)
        TA = dt.dense_matrix.from_reference_state(JA.layout,
                                                  np.asarray(JA._data))
        TB = dt.dense_matrix.from_reference_state(JB.layout,
                                                  np.asarray(JB._data))
        assert TA.grid_shape == (2, 2)
        jr = dr_tpu.stencil2d_iterate(JA, JB, w, steps=9)
        tr = dt.stencil2d_iterate(TA, TB, w, steps=9)
        np.testing.assert_allclose(tr.materialize(), jr.materialize(),
                                   rtol=1e-5, atol=1e-6)

    # K5 path on a single tile: remainder pass, then the fused loop;
    # rtol 2e-4 / atol 2e-5 as tests/test_stencil2d_blocked.py
    one = dr_tpu.block_cyclic(grid=(1, 1))
    J = dr_tpu.dense_matrix.from_array(src, one)
    T = dt.dense_matrix.from_array(src, dt.block_cyclic(grid=(1, 1)))
    stencil2d_iterate_blocked(J, w, 7, time_block=3, band=8)
    dt.stencil2d_iterate_blocked(T, w, 7, time_block=3, band=8)
    stencil2d_n(J, w, 2, time_block=4)
    dt.stencil2d_n(T, w, 2, time_block=4)
    np.testing.assert_allclose(T.materialize(), J.materialize(),
                               rtol=2e-4, atol=2e-5)

    # gemm on the stepped state, block and cyclic: f32 products
    a = J.materialize()[:, :32]
    for tile in (None, (8, 8)):
        jp = None if tile is None else dr_tpu.block_cyclic(tile=tile)
        tp = None if tile is None else dt.block_cyclic(tile=tile)
        JC = dr_tpu.gemm(dr_tpu.dense_matrix.from_array(a.T.copy(), jp),
                         dr_tpu.dense_matrix.from_array(a, jp))
        TC = dt.gemm(dt.dense_matrix.from_array(a.T.copy(), tp),
                     dt.dense_matrix.from_array(a, tp))
        np.testing.assert_allclose(TC.materialize(), JC.materialize(),
                                   rtol=1e-5, atol=1e-5)

    # mdarray: the (2P, 6, 5) cube, transpose and window bit-exact
    cube = np.arange(8 * 6 * 5, dtype=np.float32).reshape(8, 6, 5)
    JM = dr_tpu.distributed_mdarray.from_array(cube)
    TM = dt.distributed_mdarray.from_array(cube)
    JT, TT = dr_tpu.distributed_mdarray((5, 8, 6)), \
        dt.distributed_mdarray((5, 8, 6))
    dr_tpu.transpose(JT, JM, axes=(2, 0, 1))
    dt.transpose(TT, TM, axes=(2, 0, 1))
    np.testing.assert_array_equal(TT.materialize(),
                                  np.asarray(JT.to_array()))
    np.testing.assert_array_equal(
        TM.submdspan(slice(1, 8), slice(2, 5), slice(0, 3)).materialize(),
        JM.submdspan(slice(1, 8), slice(2, 5), slice(0, 3)).materialize())
