"""Distributed matrix transpose over an N-D mdarray
(``examples/mhp/transpose-cpu.cpp:27-54``, which the reference wrote
against its planned mdspan surface and never built;
``examples/transpose.py`` on ``dr_tpu_torch``): the blocks move between
the ranks in one all-to-all.
"""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, init


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser())
    ap.add_argument("-m", type=int, default=384)
    ap.add_argument("-n", type=int, default=256)
    args = ap.parse_args(argv)

    import dr_tpu_torch as dt

    init(args)
    src = np.arange(args.m * args.n, dtype=np.float32).reshape(
        args.m, args.n)
    A = dt.distributed_mdarray.from_array(src)
    B = dt.distributed_mdarray((args.n, args.m), np.float32)
    dt.transpose(B, A)

    # the reference's check: serial transpose oracle (transpose-serial.hpp)
    got = B.materialize()
    ok = np.array_equal(got, src.T)
    print(f"m={args.m} n={args.n} grid={A.grid} "
          f"check={'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
