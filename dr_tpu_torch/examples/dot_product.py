"""Dot product: zip | transform | reduce, the reference's headline
transform_reduce workload (``examples/shp/dot_product.cpp:11-18``;
``examples/dot_product.py`` on ``dr_tpu_torch``).

``dot`` of two f32 containers runs the chunked dot (K3,
``csrc/dot.cu``) on each CUDA rank, then folds the ranks' partials in
rank order.
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

    init(args)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(args.n).astype(np.float32)
    y = rng.standard_normal(args.n).astype(np.float32)
    a = dt.distributed_vector.from_array(x)
    b = dt.distributed_vector.from_array(y)

    got = dt.dot(a, b)
    ref = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    ok = abs(got - ref) <= 1e-3 * max(1.0, abs(ref))
    print(f"n={args.n} nprocs={dt.nprocs()} dot={got:.4f} "
          f"ref={ref:.4f} check={'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
