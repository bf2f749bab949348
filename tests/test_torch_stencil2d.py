"""dr_tpu_torch's 2-D stencils and K5's plain version against dr_tpu on
the CPU (the cases of tests/test_stencil2d.py and the kernel cases of
tests/test_stencil2d_blocked.py).

The tiled path (``stencil2d_transform`` / ``stencil2d_iterate``) is f32
weighted sums on both sides in the same order: within rtol 1e-5 /
atol 1e-6 of dr_tpu (XLA may fuse a product into its sum), and of a
float64 serial oracle within the tolerances tests/test_stencil2d.py
states.  K5's Pallas kernel runs with ``interpret=True``, as
tests/test_stencil2d_blocked.py runs it; against it and against the
tiled path, rtol 2e-4 / atol 2e-5, the JAX test's tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.algorithms.stencil2d import (stencil2d_iterate_blocked as
                                         j_blocked, stencil2d_n as j_n)
from dr_tpu.ops import stencil2d_pallas as j_k5
from dr_tpu_torch.ops import stencil2d_pallas as t_k5

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
K5_TOL = dict(rtol=2e-4, atol=2e-5)
FULL3 = [[0.05, 0.1, 0.05], [0.1, 0.4, 0.1], [0.05, 0.1, 0.05]]


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)


def _serial_step(u, w):
    w = np.asarray(w, dtype=np.float64)
    rh, rw = w.shape[0] // 2, w.shape[1] // 2
    out = u.copy()
    m, n = u.shape
    acc = np.zeros((m - 2 * rh, n - 2 * rw))
    for di in range(w.shape[0]):
        for dj in range(w.shape[1]):
            acc += w[di, dj] * u[di:m - 2 * rh + di, dj:n - 2 * rw + dj]
    out[rh:m - rh, rw:n - rw] = acc
    return out


def _serial(src, w, steps):
    ref = src.astype(np.float64)
    for _ in range(steps):
        ref = _serial_step(ref, w)
    return ref


def _pair(src, tile=None, grid=None):
    """The same matrix in both packages (block layout by default)."""
    jp = tp = None
    if tile is not None or grid is not None:
        tile = tile or (dt.tile.div, dt.tile.div)
        jp = dr_tpu.block_cyclic(tile=tile, grid=grid)
        tp = dt.block_cyclic(tile=tile, grid=grid)
    return (dr_tpu.dense_matrix.from_array(src, jp),
            dt.dense_matrix.from_array(src, tp))


@pytest.mark.parametrize("w", [dr_tpu.heat_step_weights(0.2), FULL3,
                               [[0.25, 0.5, 0.25]],
                               np.full((5, 5), 1.0 / 25.0)])
def test_transform_matches_reference(mesh_size, w):
    """One interior step, including the full 3x3, a 1x3 and a 5x5
    kernel, into an output whose edges must keep their values."""
    dt.init(["cpu"] * mesh_size)
    m, n = 24, 32
    rng = np.random.default_rng(0)
    src = rng.standard_normal((m, n)).astype(np.float32)
    dst = rng.standard_normal((m, n)).astype(np.float32)
    JA, TA = _pair(src)
    JB, TB = _pair(dst)
    dr_tpu.stencil2d_transform(JA, JB, w)
    dt.stencil2d_transform(TA, TB, w)
    np.testing.assert_allclose(TB.materialize(), JB.materialize(),
                               **STEP_TOL)
    ref = _serial_step(src.astype(np.float64), w)
    rh, rw = np.asarray(w).shape[0] // 2, np.asarray(w).shape[1] // 2
    ref[:rh], ref[m - rh:], ref[:, :rw], ref[:, n - rw:] = \
        dst[:rh], dst[m - rh:], dst[:, :rw], dst[:, n - rw:]
    np.testing.assert_allclose(TB.materialize(), ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(TA.materialize(), src)


@pytest.mark.parametrize("shape,steps,P", [((17, 23), 4, 8),
                                           ((19, 21), 1, 8),
                                           ((19, 21), 3, 3),
                                           ((19, 21), 5, 4),
                                           ((9, 40), 6, 8)])
def test_iterate_matches_reference(shape, steps, P):
    """Non-divisible shapes put the frozen edge inside the last tile
    (17x23 on the (2, 4) grid of 8 ranks); odd step counts end on the
    other buffer; 9 rows on 8 ranks leave tile rows with no cells."""
    _init_both(P)
    src = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    w = dr_tpu.heat_step_weights(0.25)
    JA, TA = _pair(src)
    JB, TB = _pair(src)
    jr = dr_tpu.stencil2d_iterate(JA, JB, w, steps=steps)
    tr = dt.stencil2d_iterate(TA, TB, w, steps=steps)
    assert tr is TA
    np.testing.assert_allclose(tr.materialize(), jr.materialize(),
                               **STEP_TOL)
    np.testing.assert_allclose(TB.materialize(), JB.materialize(),
                               **STEP_TOL)
    np.testing.assert_allclose(tr.materialize(), _serial(src, w, steps),
                               rtol=1e-3, atol=1e-5)
    # pad cells of the last tiles are never written
    stored = np.concatenate([np.concatenate(
        [s.numpy() for s in TA.shards[i * TA.grid_shape[1]:
                                      (i + 1) * TA.grid_shape[1]]], axis=1)
        for i in range(TA.grid_shape[0])], axis=0)
    assert not stored[shape[0]:].any() and not stored[:, shape[1]:].any()


@pytest.mark.parametrize("tile,grid,P", [((4, 4), (2, 4), 8),
                                         ((3, 5), (2, 2), 4),
                                         ((8, 8), (1, 3), 3)])
def test_cyclic_iterate_matches_reference(tile, grid, P):
    """Block-cyclic storage: several tiles per rank, neighbours on other
    ranks; against dr_tpu's cyclic and the port's block layout."""
    _init_both(P)
    src = np.random.default_rng(8).standard_normal((22, 19)) \
        .astype(np.float32)
    w = FULL3
    JA, TA = _pair(src, tile, grid)
    JB, TB = _pair(src, tile, grid)
    assert not TA.is_block
    jr = dr_tpu.stencil2d_iterate(JA, JB, w, steps=3)
    tr = dt.stencil2d_iterate(TA, TB, w, steps=3)
    np.testing.assert_allclose(tr.materialize(), jr.materialize(),
                               **STEP_TOL)
    BA, BB = _pair(src)[1], _pair(src)[1]
    np.testing.assert_allclose(tr.materialize(), dt.stencil2d_iterate(
        BA, BB, w, steps=3).materialize(), **STEP_TOL)
    JC, TC = _pair(src, tile, grid)
    JD, TD = _pair(np.zeros_like(src), tile, grid)
    dr_tpu.stencil2d_transform(JC, JD, w)
    dt.stencil2d_transform(TC, TD, w)
    np.testing.assert_allclose(TD.materialize(), JD.materialize(),
                               **STEP_TOL)


def test_heat_converges_to_mean():
    # physical sanity: with fixed zero boundary, interior decays
    _init_both(8)
    src = np.zeros((16, 16), dtype=np.float32)
    src[8, 8] = 100.0
    w = dt.heat_step_weights(0.25)
    assert w == dr_tpu.heat_step_weights(0.25)
    A = dt.dense_matrix.from_array(src)
    B = dt.dense_matrix.from_array(src)
    vals = dt.stencil2d_iterate(A, B, w, steps=20).materialize()
    assert 0.0 < vals.max() < 100.0 and np.isfinite(vals).all()


# ---------------------------------------------------------------- K5

def _single(src):
    return _pair(src, grid=(1, 1))


@pytest.mark.parametrize("m,n,T,w,band", [
    (32, 256, 2, FULL3, 16),
    (32, 256, 3, dr_tpu.heat_step_weights(0.2), 8),
    (32, 256, 4, FULL3, None),
    (24, 128, 2, dr_tpu.heat_step_weights(0.2), 12),  # unaligned band
])
def test_k5_plain_matches_pallas_interpret(m, n, T, w, band):
    rng = np.random.default_rng(T + m)
    pad = T + 1
    xp = rng.standard_normal((m + 2 * pad, n)).astype(np.float32)
    ref = np.asarray(j_k5.blocked_stencil2d_padded(
        jnp.asarray(xp), m, w, T, pad, band=band, interpret=True))
    got = t_k5.blocked_stencil2d_padded(torch.from_numpy(xp), m, w, T, pad,
                                        band=band).numpy()
    # the owned rows (the JAX kernel leaves its output's pad rows unset)
    np.testing.assert_allclose(got[pad:pad + m], ref[pad:pad + m], **K5_TOL)
    # pad rows pass through; the frozen edges keep their values
    np.testing.assert_array_equal(got[:pad + 1], xp[:pad + 1])
    np.testing.assert_array_equal(got[pad + m - 1:], xp[pad + m - 1:])
    np.testing.assert_array_equal(got[:, [0, n - 1]], xp[:, [0, n - 1]])
    one = t_k5.blocked_stencil2d(torch.from_numpy(xp[pad:pad + m]), w, T,
                                 band=band)
    np.testing.assert_allclose(one.numpy(), np.asarray(
        j_k5.blocked_stencil2d(jnp.asarray(xp[pad:pad + m]), w, T,
                               band=band, interpret=True)), **K5_TOL)


@pytest.mark.parametrize("steps,tb,w,band", [
    (3, 3, dr_tpu.heat_step_weights(0.2), 16),
    (5, 2, dr_tpu.heat_step_weights(0.2), 16),   # a remainder pass
    (8, 4, dr_tpu.heat_step_weights(0.2), 16),
    (4, 4, FULL3, 8),
])
def test_iterate_blocked_matches_reference(steps, tb, w, band):
    """K5's path on a single-tile matrix under 8 ranks: dr_tpu's
    interpret-mode kernel, dr_tpu's XLA path and the port's tiled path."""
    _init_both(8)
    m = 32
    src = np.random.default_rng(4).standard_normal((m, 256)) \
        .astype(np.float32)
    J, T = _single(src)
    j_blocked(J, w, steps, time_block=tb, band=band)
    got = dt.stencil2d_iterate_blocked(T, w, steps, time_block=tb,
                                       band=band)
    assert got is T and T.layout == J.layout
    np.testing.assert_allclose(T.materialize(), J.materialize(), **K5_TOL)
    JA, JB = _single(src)[0], _single(src)[0]
    xla = dr_tpu.stencil2d_iterate(JA, JB, w, steps=steps)
    np.testing.assert_allclose(T.materialize(), xla.materialize(), **K5_TOL)
    TA, TB = _single(src)[1], _single(src)[1]
    np.testing.assert_allclose(T.materialize(), dt.stencil2d_iterate(
        TA, TB, w, steps=steps).materialize(), **K5_TOL)


def test_blocked_unaligned_band():
    # m = 24 stepped with band = 12 (not a multiple of 8 sublanes)
    _init_both(8)
    src = np.random.default_rng(7).standard_normal((24, 128)) \
        .astype(np.float32)
    w = dr_tpu.heat_step_weights(0.2)
    J, T = _single(src)
    j_blocked(J, w, 4, time_block=2, band=12)
    dt.stencil2d_iterate_blocked(T, w, 4, time_block=2, band=12)
    np.testing.assert_allclose(T.materialize(), J.materialize(), **K5_TOL)


@pytest.mark.parametrize("iters,tb", [(3, 2), (1, 5)])
def test_stencil2d_n_matches_reference(iters, tb):
    # applies exactly iters * time_block steps
    _init_both(8)
    src = np.random.default_rng(7).standard_normal((32, 128)) \
        .astype(np.float32)
    w = dr_tpu.heat_step_weights(0.2)
    J, T = _single(src)
    j_n(J, w, iters, time_block=tb)
    dt.stencil2d_n(T, w, iters, time_block=tb)
    np.testing.assert_allclose(T.materialize(), J.materialize(), **K5_TOL)
    np.testing.assert_allclose(T.materialize(), _serial(src, w, iters * tb),
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("case", ["n", "pad", "band", "weights", "tiles"])
def test_blocked_refuses_like_reference(case):
    """Both packages refuse the same calls: n off 128 lanes, pad < T,
    a band that does not divide m, non-3x3 weights, a multi-tile
    matrix."""
    _init_both(8)
    w = dr_tpu.heat_step_weights(0.2)
    if case in ("n", "pad", "band"):
        m, n, T, pad, band = {"n": (32, 200, 2, 2, 16),
                              "pad": (32, 128, 3, 2, 16),
                              "band": (32, 128, 2, 2, 5)}[case]
        xp = np.zeros((m + 2 * pad, n), np.float32)
        with pytest.raises(AssertionError):
            j_k5.blocked_stencil2d_padded(jnp.asarray(xp), m, w, T, pad,
                                          band=band, interpret=True)
        with pytest.raises(AssertionError):
            t_k5.blocked_stencil2d_padded(torch.from_numpy(xp), m, w, T, pad,
                                          band=band)
        return
    src = np.zeros((32, 128), np.float32)
    J, T = _pair(src) if case == "tiles" else _single(src)
    ww = w if case == "tiles" else [[0.5, 0.5]]
    with pytest.raises(AssertionError):
        j_blocked(J, ww, 4, time_block=2)
    with pytest.raises(AssertionError):
        dt.stencil2d_iterate_blocked(T, ww, 4, time_block=2)
    with pytest.raises(AssertionError):
        dt.stencil2d_n(T, ww, 2, time_block=2)
