"""Matrix tour: tiled dense matrix, views, gemm, transpose, N-D mdarray
(reference ``examples/shp/matrix_example.cpp`` + the planned transpose
example; ``examples/matrix_example.py`` on ``dr_tpu_torch``)."""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, expect, init


def main(argv=None) -> int:
    args = device_args(argparse.ArgumentParser()).parse_args(argv)

    import dr_tpu_torch as dt
    from dr_tpu_torch.containers.mdarray import distributed_mdarray, transpose

    init(args)
    rng = np.random.default_rng(0)
    src = rng.standard_normal((64, 48)).astype(np.float32)
    A = dt.dense_matrix.from_array(src)
    print(f"grid={A.grid_shape} tile={A.tile_shape} "
          f"tiles={len(A.tiles())}")

    # tile segments cover the matrix
    total = sum((t.re - t.rb) * (t.ce - t.cb) for t in A.tiles())
    expect(total == 64 * 48, f"tiles cover {total} cells, not 64 * 48")

    # submatrix + row/column views
    v = A[8:16, 4:12]
    np.testing.assert_array_equal(v.materialize(), src[8:16, 4:12])
    np.testing.assert_array_equal(v.row(0).materialize(), src[8, 4:12])

    # dense gemm over the tiles
    B = dt.dense_matrix.from_array(
        rng.standard_normal((48, 32)).astype(np.float32))
    C = dt.gemm(A, B)
    np.testing.assert_allclose(C.materialize(),
                               src @ B.materialize(), rtol=1e-4,
                               atol=1e-4)

    # N-D mdarray + distributed transpose (an all-to-all of blocks)
    M = distributed_mdarray.from_array(src)
    T = distributed_mdarray((48, 64), np.float32)
    transpose(T, M)
    np.testing.assert_array_equal(T.materialize(), src.T)

    # block-cyclic placement: explicit tile shape, tiles placed
    # round-robin over the rank grid (matrix_partition.hpp:34-86)
    cyc = dt.block_cyclic(tile=(8, 8), grid=dt.factor(dt.nprocs()))
    Ac = dt.dense_matrix.from_array(src, cyc)
    expect(not Ac.is_block, "the block-cyclic matrix reports is_block")
    np.testing.assert_array_equal(Ac.materialize(), src)
    Cc = dt.gemm(Ac, B)
    np.testing.assert_allclose(Cc.materialize(), C.materialize(),
                               rtol=1e-4, atol=1e-4)

    # 2-D-partitioned sparse SpMV: per-tile partials summed over the
    # grid's columns (beyond the reference's grid_shape[1]==1 limit)
    dm = np.where(rng.random((48, 48)) < 0.3,
                  rng.standard_normal((48, 48)), 0).astype(np.float32)
    sp = dt.sparse_matrix.from_dense(
        dm, partition=dt.block_cyclic(grid=dt.factor(dt.nprocs())))
    bvec = np.linspace(-1, 1, 48).astype(np.float32)
    cv = dt.distributed_vector(48)
    dt.gemv(cv, sp, bvec)
    np.testing.assert_allclose(dt.to_numpy(cv), dm @ bvec,
                               rtol=1e-4, atol=1e-5)

    dt.print_matrix(A, "A")
    print("matrix example: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
