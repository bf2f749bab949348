"""Distributed inclusive scan (prefix sum)
(``examples/shp/inclusive_scan_example.cpp``;
``examples/inclusive_scan_example.py`` on ``dr_tpu_torch``): a local
scan a rank (K4, ``csrc/scan.cu``, on a CUDA rank), the ranks' carries
exchanged, a fix-up.
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
    src = np.random.default_rng(0).integers(0, 100, args.n)\
        .astype(np.float32)
    a = dt.distributed_vector.from_array(src)
    out = dt.distributed_vector(args.n)
    dt.inclusive_scan(a, out)

    got = dt.to_numpy(out)
    ref = np.cumsum(src, dtype=np.float32)
    ok = np.allclose(got, ref, rtol=1e-3)
    print(f"n={args.n} nprocs={dt.nprocs()} total={got[-1]:.0f} "
          f"check={'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
