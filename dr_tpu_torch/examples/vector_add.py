"""Vector add: c = a + b over distributed vectors
(``examples/mhp/vector-add.cpp`` / ``examples/shp/vector_example.cpp``;
``examples/vector_add.py`` on ``dr_tpu_torch``): zip | transform on
aligned vectors runs rank-local, with no communication.
"""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, init


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser())
    ap.add_argument("-n", type=int, default=1 << 20)
    args = ap.parse_args(argv)

    import dr_tpu_torch as dt
    from dr_tpu_torch import views

    init(args)
    a = dt.distributed_vector(args.n)
    b = dt.distributed_vector(args.n)
    c = dt.distributed_vector(args.n)
    dt.iota(a, 0)
    dt.fill(b, 10.0)
    dt.transform(views.zip_view(a, b), c, lambda x, y: x + y)

    got = dt.to_numpy(c)
    ref = np.arange(args.n, dtype=np.float32) + 10.0
    ok = np.allclose(got, ref)
    print(f"n={args.n} nprocs={dt.nprocs()} "
          f"check={'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
