"""Distributed sample sort (``examples/sort_example.py`` on
``dr_tpu_torch``).

A local sort a rank, regular-sample splitters gathered from every rank,
a bucket exchange and a rebalance to the block layout
(``dr_tpu_torch/algorithms/sort.py``).  On CUDA ranks of at most 2^15
keys each, the local sorts run as one batch of the bitonic kernel (K6,
``csrc/bitonic_sort.cu``).
"""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, init


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser())
    ap.add_argument("-n", type=int, default=1 << 20)
    ap.add_argument("--descending", action="store_true")
    args = ap.parse_args(argv)

    import dr_tpu_torch as dt

    init(args)
    src = np.random.default_rng(0).standard_normal(args.n)\
        .astype(np.float32)
    v = dt.distributed_vector.from_array(src)
    dt.sort(v, descending=args.descending)

    got = dt.to_numpy(v)
    ref = np.sort(src)
    if args.descending:
        ref = ref[::-1]
    ok = bool(np.array_equal(got, ref))
    print(f"n={args.n} nprocs={dt.nprocs()} "
          f"first={got[0]:.4f} last={got[-1]:.4f} "
          f"check={'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
