"""2-D heat equation on a tiled dense matrix (BASELINE config 4;
``examples/heat_2d.py`` on ``dr_tpu_torch``).

``stencil2d_iterate`` steps every tile with its neighbours' edge rows
and columns exchanged each step (the tiled route; the temporally
blocked K5 kernel is ``stencil2d_iterate_blocked``'s, on one tile).
"""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, init


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser())
    ap.add_argument("-m", type=int, default=512)
    ap.add_argument("-n", type=int, default=512)
    ap.add_argument("-s", "--steps", type=int, default=50)
    args = ap.parse_args(argv)

    import dr_tpu_torch as dt

    init(args)
    src = np.zeros((args.m, args.n), dtype=np.float32)
    src[args.m // 2, args.n // 2] = 1000.0
    w = dt.heat_step_weights(0.25)
    A = dt.dense_matrix.from_array(src)
    B = dt.dense_matrix.from_array(src)
    out = dt.stencil2d_iterate(A, B, w, steps=args.steps)
    vals = out.materialize()
    ok = np.isfinite(vals).all() and vals.max() < 1000.0
    print(f"m={args.m} n={args.n} steps={args.steps} grid="
          f"{A.grid_shape} max={vals.max():.3f} "
          f"check={'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
