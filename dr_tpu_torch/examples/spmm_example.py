"""Multi-vector SpMM: Y = A·B for a random sparse A and dense B
(``examples/spmm_example.py`` on ``dr_tpu_torch``).

Beyond the reference's single-vector ``gemv``
(``examples/shp/gemv_example.cpp:18-41``): ``nv`` right-hand sides
share one gather of A's pattern.
"""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, init


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser())
    ap.add_argument("-m", type=int, default=1 << 12)
    ap.add_argument("-k", type=int, default=16, help="nnz per row")
    ap.add_argument("--nv", type=int, default=8,
                    help="right-hand sides (columns of B)")
    args = ap.parse_args(argv)

    import dr_tpu_torch as dt

    init(args)
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(args.m), args.k)
    cols = rng.integers(0, args.m, size=args.m * args.k)
    vals = rng.standard_normal(args.m * args.k).astype(np.float32)
    A = dt.sparse_matrix.from_coo((args.m, args.m), rows, cols, vals)
    B = rng.standard_normal((args.m, args.nv)).astype(np.float32)

    Y = dt.spmm(A, B)

    dense = np.zeros((args.m, args.m), np.float32)
    np.add.at(dense, (rows, cols), vals)
    ok = np.allclose(dt.to_numpy(Y), dense @ B, rtol=1e-3, atol=1e-3)
    print(f"spmm: ({args.m}x{args.m}, {args.k} nnz/row) x "
          f"({args.m}x{args.nv})  {'OK' if ok else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
