"""Sparse SpMV: c = A·b for a random sparse matrix
(``examples/shp/gemv_example.cpp:18-41``; ``examples/gemv_example.py``
on ``dr_tpu_torch``): A row-tiled over the ranks, b on every rank, a
contraction a tile; then a block-banded matrix in the BCSR layout.
"""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, init


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser())
    ap.add_argument("-m", type=int, default=1 << 12)
    ap.add_argument("-n", type=int, default=1 << 12)
    ap.add_argument("--density", type=float, default=0.01)
    args = ap.parse_args(argv)

    import dr_tpu_torch as dt

    init(args)
    sp = dt.random_sparse_matrix((args.m, args.n), args.density, seed=0)
    b = np.ones(args.n, dtype=np.float32)
    c = dt.distributed_vector(args.m)
    dt.gemv(c, sp, b)

    ref = sp.to_dense() @ b
    ok = np.allclose(dt.to_numpy(c), ref, rtol=1e-3, atol=1e-4)

    # block-banded matrix: the BCSR layout (dense tiles along the band)
    m2 = max(64, args.m - args.m % 8)
    half = 8
    ii = np.repeat(np.arange(m2), 2 * half + 1)
    jj = ii + np.tile(np.arange(-half, half + 1), m2)
    keep = (jj >= 0) & (jj < m2)
    rngv = np.random.default_rng(1)
    band = dt.sparse_matrix.from_coo(
        (m2, m2), ii[keep], jj[keep],
        rngv.standard_normal(int(keep.sum())).astype(np.float32))
    bcsr = band.ensure_bcsr()
    b2 = np.linspace(0, 1, m2).astype(np.float32)
    c2 = dt.distributed_vector(m2)
    dt.gemv(c2, band, b2)
    ok2 = np.allclose(dt.to_numpy(c2), band.to_dense() @ b2,
                      rtol=1e-3, atol=1e-4)

    print(f"m={args.m} n={args.n} nnz={sp.nnz} nprocs={dt.nprocs()} "
          f"check={'PASS' if ok else 'FAIL'} "
          f"banded(bcsr={bcsr})={'PASS' if ok2 else 'FAIL'}")
    return 0 if ok and ok2 else 1


if __name__ == "__main__":
    sys.exit(main())
