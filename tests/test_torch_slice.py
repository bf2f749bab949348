"""The whole slice end to end on 8 CPU ranks, both packages fed the same
numpy state: halo'd vector -> periodic exchange -> iterated 5-point
stencil (stepwise, composed K1 and blocked K2 paths) -> dot / dot_n ->
inclusive and exclusive scans and inclusive_scan_n."""

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
