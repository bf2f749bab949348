"""dr_tpu_torch's sparse_matrix, gemv, gemv_n, spmm and spmm_n against
dr_tpu on the CPU (the cases of tests/test_sparse.py, the sparse cases
of tests/test_pipeline.py and tests/test_matrix.py's 2-D sweep).

Layouts are bit-exact: the padded COO, the ELL, BCSR and ring layouts,
``format`` and ``viable_formats`` equal the JAX matrix's.  Products are
f32 sums in two orders: each row of a gemv/spmm result lies within
``1e-5 * (|A|·|b|)_i + 1e-6`` of the JAX result.  The ring's two
schedules give the same bits."""

import importlib

import jax
import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt

# the modules (the packages re-export the function ``gemv``)
jg = importlib.import_module("dr_tpu.algorithms.gemv")
tg = importlib.import_module("dr_tpu_torch.algorithms.gemv")


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)


def _random_dense(m, n, density, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(np.float32)
    mask = rng.random((m, n)) < density
    return np.where(mask, d, 0.0).astype(np.float32)


def _banded(m, half, seed):
    rng = np.random.default_rng(seed)
    d = np.zeros((m, m), dtype=np.float32)
    for i in range(m):
        lo, hi = max(0, i - half), min(m, i + half + 1)
        d[i, lo:hi] = rng.standard_normal(hi - lo)
    return d


def _rand_coo(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), k)
    cols = rng.integers(0, n, size=m * k)
    vals = rng.standard_normal(m * k).astype(np.float32)
    return rows, cols, vals


def _grid():
    return dt.factor(dt.nprocs())


def _parts(grid):
    if grid is None:
        return None, None
    return dr_tpu.block_cyclic(grid=grid), dt.block_cyclic(grid=grid)


def _from_dense(d, grid=None):
    jp, tp = _parts(grid)
    return (dr_tpu.sparse_matrix.from_dense(d, partition=jp),
            dt.sparse_matrix.from_dense(d, partition=tp))


def _from_coo(shape, rows, cols, vals, grid=None):
    jp, tp = _parts(grid)
    return (dr_tpu.sparse_matrix.from_coo(shape, rows, cols, vals,
                                          partition=jp),
            dt.sparse_matrix.from_coo(shape, rows, cols, vals, partition=tp))


def _stack(ts):
    return np.stack([t.numpy() for t in ts])


def _same_layout(J, T):
    """The padded COO, format, viable formats and every grouped layout
    equal the JAX matrix's bit for bit."""
    assert (T.shape, T.grid_shape, T.nnz) == (J.shape, J.grid_shape, J.nnz)
    np.testing.assert_array_equal(T._tile_nnz, J._tile_nnz)
    for name in ("_vals", "_rows", "_cols"):
        np.testing.assert_array_equal(_stack(getattr(T, name)),
                                      np.asarray(getattr(J, name)))
    assert T.format == J.format
    assert tg.viable_formats(T) == jg.viable_formats(J)
    for name in ("_ell_vals", "_ell_cols", "_bcsr_vals", "_bcsr_cols",
                 "_ring_vals", "_ring_cols"):
        if getattr(J, name) is not None:
            np.testing.assert_array_equal(_stack(getattr(T, name)),
                                          np.asarray(getattr(J, name)))
    assert (T._ell_width, T._bcsr_kb, T._ring_kr) == \
        (J._ell_width, J._bcsr_kb, J._ring_kr)


def _close_rows(got, ref, dense, b):
    """Row i within 1e-5 * (|A|·|b|)_i + 1e-6 (columns of b alike)."""
    tol = 1e-5 * (np.abs(dense).astype(np.float64) @ np.abs(b)) + 1e-6
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert (err <= tol).all(), float((err - tol).max())


def _gemv_pair(J, T, b, fill=0.0, fmt=None, tb=None):
    """(port, JAX) results of c = fill; c += A·b (``fmt`` forces the
    port's layout; the caller forces the JAX one through its env)."""
    m = J.shape[0]
    jc = dr_tpu.distributed_vector(m)
    tc = dt.distributed_vector(m)
    dr_tpu.fill(jc, fill)
    dt.fill(tc, fill)
    dr_tpu.gemv(jc, J, b)
    tb = b if tb is None else tb
    if fmt is None:
        dt.gemv(tc, T, tb)
    else:
        tg._gemv_as(tc, T, tb, fmt)
    return dt.to_numpy(tc), dr_tpu.to_numpy(jc)


# ------------------------------------------------------------ constructors

@pytest.mark.parametrize("build", ["dense", "csr", "random", "empty_tile"])
def test_constructors_match_reference(build):
    _init_both(8)
    if build == "dense":
        d = _random_dense(20, 16, 0.2)
        J, T = _from_dense(d)
    elif build == "csr":
        d = _random_dense(10, 10, 0.3, seed=1)
        rows, cols = np.nonzero(d)
        rowptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                            minlength=10))])
        J = dr_tpu.sparse_matrix.from_csr((10, 10), rowptr, cols,
                                          d[rows, cols])
        T = dt.sparse_matrix.from_csr((10, 10), rowptr, cols, d[rows, cols])
    elif build == "random":
        J = dr_tpu.random_sparse_matrix((32, 32), density=0.1, seed=8)
        T = dt.random_sparse_matrix((32, 32), density=0.1, seed=8)
        assert T.nnz == int(0.1 * 32 * 32) and T.shape == (32, 32)
        d = J.to_dense()
    else:
        d = np.zeros((16, 4), dtype=np.float32)
        d[0, 1] = 3.0
        J, T = _from_dense(d)
    np.testing.assert_array_equal(T.to_dense(), d)
    _same_layout(J, T)
    # the JAX matrix's state carried across gives the same matrix
    T2 = dt.sparse_matrix.from_reference_state(
        J.shape, J.grid_shape, J._tile_nnz, np.asarray(J._vals),
        np.asarray(J._rows), np.asarray(J._cols))
    _same_layout(J, T2)
    b = np.arange(d.shape[1], dtype=np.float32)
    _close_rows(dt.flat_gemv(T, b).numpy(), np.asarray(dr_tpu.flat_gemv(J, b)),
                d, b)


def test_segments_and_tile_views():
    _init_both(8)
    d = _random_dense(24, 8, 0.4, seed=2)
    J, T = _from_dense(d)
    js, ts = dr_tpu.segments(J), dt.segments(T)
    assert [(dt.rank(s), s.rb, s.re, len(s)) for s in ts] == \
        [(dr_tpu.rank(s), s.rb, s.re, len(s)) for s in js]
    for a, b in zip(js, ts):
        for x, y in zip(a.triples(), b.triples()):
            np.testing.assert_array_equal(y, x)
    d2 = _random_dense(16, 6, 0.5, seed=3)
    J, T = _from_dense(d2)
    for x, y in zip(J.tile((0, 0)).csr(), T.tile((0, 0)).csr()):
        np.testing.assert_array_equal(y, x)
    assert [e.index for e in T.tile((1, 0))] == \
        [e.index for e in J.tile((1, 0))]


# ------------------------------------------------------------- 1-D gemv

@pytest.mark.parametrize("case", ["fast", "accumulate", "host_b",
                                  "empty_rows", "distributed_b"])
def test_gemv_matches_reference(mesh_size, case):
    _init_both(mesh_size)
    if case == "empty_rows":
        d = np.zeros((16, 4), dtype=np.float32)
        d[0, 1] = 3.0
        b = np.ones(4, dtype=np.float32)
    else:
        m, n = 8 * mesh_size, 24
        d = _random_dense(m, n, 0.3, seed=4)
        b = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    J, T = _from_dense(d)
    _same_layout(J, T)
    fill = 1.0 if case == "accumulate" else 0.0
    jb = tb = b
    if case == "distributed_b":
        jb = dr_tpu.distributed_vector.from_array(b)
        tb = dt.distributed_vector.from_array(b)
    elif case == "fast":
        tb = torch.from_numpy(b)
    got, ref = _gemv_pair(J, T, jb, fill, tb=tb)
    _close_rows(got, ref, d, b)
    np.testing.assert_allclose(got, fill + d @ b, rtol=1e-4, atol=1e-5)


def test_gemv_into_a_misaligned_vector():
    """An output laid out otherwise than the tiles (an uneven
    distribution) takes the flat path."""
    _init_both(4)
    d = _random_dense(20, 12, 0.4, seed=9)
    J, T = _from_dense(d)
    b = np.linspace(-1, 1, 12).astype(np.float32)
    sizes = [2, 9, 0, 9]
    jc = dr_tpu.distributed_vector(20, distribution=sizes)
    tc = dt.distributed_vector(20, distribution=sizes)
    dr_tpu.fill(jc, 0.5)
    dt.fill(tc, 0.5)
    dr_tpu.gemv(jc, J, b)
    dt.gemv(tc, T, b)
    _close_rows(dt.to_numpy(tc), dr_tpu.to_numpy(jc), d, b)


@pytest.mark.parametrize("case", ["ell", "bcsr", "bcsr_unaligned"])
def test_gemv_n_matches_reference(case):
    _init_both(8)
    P = 8
    if case == "ell":
        rows, cols, vals = _rand_coo(16 * P, 512, 4, seed=21)
        d = np.zeros((16 * P, 512), np.float32)
        np.add.at(d, (rows, cols), vals)
        b = np.linspace(0, 1, 512).astype(np.float32)
        iters = 3
    elif case == "bcsr":
        d = _banded(64, 6, 52)
        b = np.arange(64, dtype=np.float32) / 64
        iters = 3
    else:
        m = 6 * P - 2  # tile height 6: an unaligned block-row
        d = _banded(m, 5, 60)
        b = np.random.default_rng(60).standard_normal(m).astype(np.float32)
        iters = 2
    J, T = _from_dense(d)
    assert T.format == J.format == ("ell" if case == "ell" else "bcsr")
    m = d.shape[0]
    jc, tc = dr_tpu.distributed_vector(m), dt.distributed_vector(m)
    jg.gemv_n(jc, J, b, iters)
    tg.gemv_n(tc, T, dt.distributed_vector.from_array(b), iters)
    _close_rows(dt.to_numpy(tc), dr_tpu.to_numpy(jc), iters * d, b)
    # gemv_n is iters gemv calls up to the 1e-38 salt
    rep = dt.distributed_vector(m)
    for _ in range(iters):
        dt.gemv(rep, T, b)
    _close_rows(dt.to_numpy(tc), dt.to_numpy(rep), iters * d, b)


# --------------------------------------------------------- 2-D partitions

def test_sparse_2d_construction_segments_and_repr():
    _init_both(8)
    grid = _grid()
    d = _random_dense(20, 18, 0.4, seed=11)
    J, T = _from_dense(d, grid)
    assert T.grid_shape == grid
    np.testing.assert_array_equal(T.to_dense(), d)
    _same_layout(J, T)
    assert sum(len(t) for t in T.tiles()) == T.nnz
    for t in T.tiles():
        rows, cols, vals = t.triples()
        assert (rows >= t.rb).all() and (rows < t.re).all()
        assert (cols >= t.cb).all() and (cols < t.ce).all()
        np.testing.assert_array_equal(vals, d[rows, cols])
    T2 = dt.sparse_matrix.from_reference_state(
        J.shape, J.grid_shape, J._tile_nnz, np.asarray(J._vals),
        np.asarray(J._rows), np.asarray(J._cols))
    _same_layout(J, T2)
    jp, tp = _parts(grid)
    R = dt.random_sparse_matrix((32, 32), density=0.1, seed=15,
                                partition=tp)
    assert f"{grid[0]}x{grid[1]}" in repr(R)


@pytest.mark.parametrize("case", ["random", "uneven_flat", "random_matrix",
                                  "banded", "dense_tiles"])
def test_sparse_2d_gemv_matches_reference(case):
    _init_both(8)
    grid = _grid()
    fill = 0.0
    if case == "random":
        d = _random_dense(24, 20, 0.35, seed=13)
        fill = 1.0
    elif case == "uneven_flat":
        d = _random_dense(17, 9, 0.5, seed=14)   # uneven tile trim
    elif case == "random_matrix":
        d = dr_tpu.random_sparse_matrix((32, 32), density=0.1, seed=15,
                                        partition=_parts(grid)[0]).to_dense()
    elif case == "banded":
        d = _banded(96, 6, 51)
        fill = 0.25
    else:
        gp, gq = grid
        d = np.ones((8 * gp, 128 * gq), dtype=np.float32)
    J, T = _from_dense(d, grid)
    _same_layout(J, T)
    if case in ("banded", "dense_tiles"):
        assert T.format == "bcsr"
    b = np.linspace(-1, 1, d.shape[1]).astype(np.float32)
    got, ref = _gemv_pair(J, T, b, fill)
    _close_rows(got, ref, d, b)
    _close_rows(dt.flat_gemv(T, b).numpy(), d @ b, d, b)


def test_sparse_2d_mesh_sweep(mesh_size):
    """tests/test_matrix.py's sweep: every grid factor(P)."""
    _init_both(mesh_size)
    rng = np.random.default_rng(40 + mesh_size)
    d = np.where(rng.random((20, 18)) < 0.4,
                 rng.standard_normal((20, 18)), 0).astype(np.float32)
    J, T = _from_dense(d, dt.factor(mesh_size))
    b = np.linspace(-1, 1, 18).astype(np.float32)
    got, ref = _gemv_pair(J, T, b)
    _close_rows(got, ref, d, b)


# ------------------------------------------------------------------- BCSR

def _dup_stripe(P):
    rng = np.random.default_rng(53)
    m, n = 16 * P, 16
    rows = np.concatenate([np.repeat(np.arange(8), n), [0, 0, 0, m - 1]])
    cols = np.concatenate([np.tile(np.arange(n), 8), [0, 0, 0, 2]])
    vals = np.concatenate([rng.standard_normal(8 * n),
                           [1.0, 2.0, 1e-3, 8.0]]).astype(np.float32)
    return (m, n), rows, cols, vals


def _skewed_blocks(P):
    m, n = 8 * max(P, 2) * 4, 128 * 32
    rows = [np.repeat(np.arange(8), 32 * 128)]
    cols = [np.tile(np.arange(32 * 128), 8)]
    for br in range(1, m // 8):
        rows.append(np.repeat(np.arange(br * 8, br * 8 + 8), 128))
        cols.append(np.tile(np.arange(128), 8))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return (m, n), rows, cols, np.ones(len(rows), dtype=np.float32)


@pytest.mark.parametrize("case,bcsr", [("banded", True),
                                       ("unstructured", False),
                                       ("duplicates", True),
                                       ("skewed_blocks", False)])
def test_bcsr_gates_and_gemv(case, bcsr):
    _init_both(8)
    if case == "banded":
        shape, d = (64, 64), _banded(64, 4, 50)
        J, T = _from_dense(d)
    else:
        if case == "unstructured":
            rng = np.random.default_rng(51)
            shape = (256, 256)
            rows = np.arange(256)
            cols = rng.integers(0, 256, size=256)
            vals = np.ones(256, dtype=np.float32)
        elif case == "duplicates":
            shape, rows, cols, vals = _dup_stripe(8)
        else:
            shape, rows, cols, vals = _skewed_blocks(8)
        J, T = _from_coo(shape, rows, cols, vals)
        d = J.to_dense()
        np.testing.assert_array_equal(T.to_dense(), d)
    assert T.ensure_bcsr() is bcsr and J.ensure_bcsr() is bcsr
    assert T._bcsr_state == J._bcsr_state == ("yes" if bcsr else "no")
    _same_layout(J, T)
    b = np.linspace(1, 2, shape[1]).astype(np.float32)
    got, ref = _gemv_pair(J, T, b, 0.5)
    _close_rows(got, ref, d, b)


# ------------------------------------------------------------------- spmm

@pytest.mark.parametrize("case", ["random", "banded", "single_column",
                                  "grid", "grid_skewed", "bcsr_skewed"])
def test_spmm_matches_reference(case, monkeypatch):
    _init_both(8)
    grid = None
    if case in ("random", "single_column"):
        m = n = 64 if case == "random" else 96
        rows, cols, vals = _rand_coo(m, n, 4 if case == "random" else 3,
                                     seed=3)
    elif case == "banded":
        d = _banded(64, 4, 50)
        rows, cols = np.nonzero(d)
        vals = d[rows, cols]
        m = n = 64
    elif case == "grid":
        m = n = 64
        rows, cols, vals = _rand_coo(m, n, 2, seed=11)
        grid = _grid()
    elif case == "grid_skewed":
        # one long row defeats the ELL pad budget: one flat_gemv a column
        m = n = 64
        rows = np.concatenate([np.zeros(n, np.int64), np.arange(m)])
        cols = np.concatenate([np.arange(n), np.zeros(m, np.int64)])
        vals = np.random.default_rng(3).standard_normal(
            len(rows)).astype(np.float32)
        grid = _grid()
    else:
        # one dense row a tile over n = 512: ELL-skewed, BCSR-viable
        m, n = 8 * 8, 512
        rows = np.repeat(np.arange(0, m, 8), n)
        cols = np.tile(np.arange(n), 8)
        vals = np.random.default_rng(13).standard_normal(
            len(rows)).astype(np.float32)
    J, T = _from_coo((m, n), rows, cols, vals, grid)
    _same_layout(J, T)
    d = J.to_dense()
    nv = 1 if case == "single_column" else 3
    B = np.random.default_rng(7).standard_normal((n, nv)).astype(np.float32)
    if case == "grid":
        # the grid takes the per-tile program, never a flat_gemv a column
        def no_flat(*a, **kw):
            raise AssertionError("2-D spmm fell back to flat_gemv")
        monkeypatch.setattr(tg, "flat_gemv", no_flat)
    got = dt.spmm(T, B)
    assert got.shape == (m, nv) and got.device == dt.devices()[0]
    _close_rows(got.numpy(), np.asarray(dr_tpu.spmm(J, B)), d, B)
    if case == "single_column":
        tc = dt.distributed_vector(m)
        dt.gemv(tc, T, B[:, 0])
        _close_rows(got.numpy()[:, 0], dt.to_numpy(tc), d, B[:, 0])
    if grid is None:
        assert tg.resolved_spmm_format(T) == jg.resolved_spmm_format(J)
        _close_rows(tg.spmm_n(T, B, 2).numpy(),
                    np.asarray(jg.spmm_n(J, B, 2)), d, B)


def test_from_coo_copies_its_inputs():
    """The layout never aliases the caller's arrays (one tile of exactly
    K entries would otherwise share the values' memory)."""
    dt.init(["cpu"])
    rows, cols, vals = _rand_coo(16, 16, 2)
    A = dt.sparse_matrix.from_coo((16, 16), rows, cols, vals)
    before = A.to_dense()
    vals[:] = 7.0
    np.testing.assert_array_equal(A.to_dense(), before)


def test_spmm_rejects_bad_shapes():
    dt.init(["cpu"] * 8)
    rows, cols, vals = _rand_coo(32, 32, 2)
    A = dt.sparse_matrix.from_coo((32, 32), rows, cols, vals)
    with pytest.raises(AssertionError):
        dt.spmm(A, np.zeros((33, 2), np.float32))
    with pytest.raises(AssertionError):
        dt.spmm(A, np.zeros((32,), np.float32))
    with pytest.raises(ValueError):
        dt.sparse_matrix.from_coo((32, 32), [0, 32], [1, 1], [1.0, 1.0])


# ------------------------------------------- ring schedule and autoselect

def _ring_friendly(P, m, n, k, seed=0):
    """Each row's k entries in k distinct b-blocks: ring-eligible."""
    bw = max(1, -(-n // P))
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), k)
    blocks = np.tile(np.arange(k) % P, m)
    cols = np.minimum(blocks * bw + rng.integers(0, bw, m * k), n - 1)
    vals = rng.standard_normal(m * k).astype(np.float32)
    return rows, cols, vals


def test_ring_gemv_matches_reference_and_schedules_bitwise(monkeypatch):
    _init_both(8)
    P, m, n = 8, 128, 96
    J, T = _from_coo((m, n), *_ring_friendly(P, m, n, 4))
    assert T.ensure_ring() and J.ensure_ring()
    _same_layout(J, T)
    d = J.to_dense()
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    monkeypatch.setenv("DR_TPU_SPMV_FORMAT", "ring")
    outs = {}
    for sched in ("serial", "pipelined"):
        monkeypatch.setenv("DR_GPU_RING_SCHEDULE", sched)
        outs[sched], ref = _gemv_pair(J, T, b, fmt="ring")
    np.testing.assert_array_equal(outs["serial"], outs["pipelined"])
    _close_rows(outs["serial"], ref, d, b)
    # gemv_n's ring arm and the phase ladder: the last phase, once, is
    # exactly the ring gemv
    bv = dt.distributed_vector.from_array(b)
    for ph in tg.SPMV_PHASES:
        c = dt.distributed_vector(m)
        tg.gemv_phases_n(c, T, bv, ph, 2)
        assert np.isfinite(dt.to_numpy(c)).all(), ph
    c = dt.distributed_vector(m)
    tg.gemv_phases_n(c, T, bv, "combine", 1)
    np.testing.assert_array_equal(dt.to_numpy(c), outs["pipelined"])
    T._format = "ring"
    jc = dr_tpu.distributed_vector(m)
    c = dt.distributed_vector(m)
    jg.gemv_n(jc, J, b, 3)
    tg.gemv_n(c, T, bv, 3)
    _close_rows(dt.to_numpy(c), dr_tpu.to_numpy(jc), 3 * d, b)


def test_ring_gate_rejects_block_skew(monkeypatch):
    _init_both(8)
    P = 8
    m = 16 * P
    bw = -(-m // P)
    rng = np.random.default_rng(5)
    rows = np.repeat(np.arange(m), 8)
    # every entry inside its row's own block: one bucket takes them all
    cols = (rows // bw) * bw + rng.integers(0, bw, m * 8)
    vals = rng.standard_normal(m * 8).astype(np.float32)
    J, T = _from_coo((m, m), rows, cols, vals)
    assert not T.ensure_ring() and T._ring_state == "no"
    _same_layout(J, T)
    b = rng.standard_normal(m).astype(np.float32)
    monkeypatch.setenv("DR_TPU_SPMV_FORMAT", "ring")
    got, ref = _gemv_pair(J, T, b, fmt="ring")  # falls back, correct
    _close_rows(got, ref, J.to_dense(), b)


@pytest.mark.parametrize("case,fmt", [("long_row", "csr"),
                                      ("banded", "bcsr"),
                                      ("random", "ell")])
def test_autoselect_matches_reference(case, fmt):
    _init_both(8)
    rng = np.random.default_rng(9)
    if case == "long_row":
        m = n = 64
        rows = np.concatenate([np.zeros(n, np.int64),
                               rng.integers(0, m, 8)])
        cols = np.concatenate([np.arange(n), rng.integers(0, n, 8)])
    elif case == "banded":
        m = n = 1024
        ii = np.repeat(np.arange(m), 33)
        jj = ii + np.tile(np.arange(-16, 17), m)
        keep = (jj >= 0) & (jj < m)
        rows, cols = ii[keep], jj[keep]
    else:
        m = n = 1024
        rows = np.repeat(np.arange(m), 4)
        cols = rng.integers(0, m, m * 4)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    J, T = _from_coo((m, n), rows, cols, vals)
    assert T.format == J.format == fmt
    assert tg.resolved_format(T) == jg.resolved_format(J) == fmt
    if case == "long_row":
        assert T._ell_width == -1 and not T.ensure_ell()
    _same_layout(J, T)
    b = rng.standard_normal(n).astype(np.float32)
    got, ref = _gemv_pair(J, T, b)
    _close_rows(got, ref, J.to_dense(), b)


@pytest.mark.parametrize("fmt", ["csr", "ell", "bcsr", "ring"])
def test_forced_formats_match_reference(fmt, monkeypatch):
    """Each layout forced at dispatch (the JAX package's env override,
    the port's ``_gemv_as``), ineligible ones falling back alike."""
    _init_both(8)
    m = 128
    J, T = _from_coo((m, m), *_ring_friendly(8, m, m, 4, seed=11))
    b = np.random.default_rng(12).standard_normal(m).astype(np.float32)
    monkeypatch.setenv("DR_TPU_SPMV_FORMAT", fmt)
    got, ref = _gemv_pair(J, T, b, fmt=fmt)
    _close_rows(got, ref, J.to_dense(), b)
    # the same bits on a second call
    again, _ = _gemv_pair(J, T, b, fmt=fmt)
    np.testing.assert_array_equal(again, got)
