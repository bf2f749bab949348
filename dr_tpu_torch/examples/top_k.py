"""Top-k selection over a distributed vector (``examples/top_k.py`` on
``dr_tpu_torch``).

Score a distributed vector, take the k largest with their original
positions through the stable key-value sort, and check against numpy.
The selection is collective: no host-side gather of the whole data.
"""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, init


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser())
    ap.add_argument("-n", type=int, default=1 << 18)
    ap.add_argument("-k", type=int, default=8)
    args = ap.parse_args(argv)

    import dr_tpu_torch as dt

    init(args)
    rng = np.random.default_rng(0)
    scores = rng.standard_normal(args.n).astype(np.float32)

    s = dt.distributed_vector.from_array(scores)
    pos = dt.distributed_vector(args.n, dtype=np.int32)
    dt.iota(pos, 0)
    # stable key-value sort, descending: ties keep ascending-order
    # positions reversed (documented semantics)
    dt.sort_by_key(s, pos, descending=True)

    top_scores = dt.to_numpy(s[0:args.k])
    top_pos = dt.to_numpy(pos[0:args.k])

    order = np.argsort(scores, kind="stable")[::-1][:args.k]
    ok = (np.array_equal(top_scores, scores[order])
          and np.array_equal(top_pos, order))
    print(f"n={args.n} k={args.k} nprocs={dt.nprocs()} "
          f"best={top_scores[0]:.4f}@{top_pos[0]} "
          f"check={'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
