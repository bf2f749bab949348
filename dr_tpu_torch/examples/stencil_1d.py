"""1-D stencil example with a halo exchange per step
(``examples/mhp/stencil-1d.cpp``; ``examples/stencil_1d.py`` on
``dr_tpu_torch``): an iterated 3-point mean over a distributed vector,
a halo exchange a step, a serial oracle.

Usage: python -m dr_tpu_torch.examples.stencil_1d [-n SIZE] [-s STEPS]
[--cpu N | --ranks P]
"""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, init


def serial(x, steps):
    x = x.astype(np.float64).copy()
    for _ in range(steps):
        y = x.copy()
        y[1:-1] = (x[:-2] + x[1:-1] + x[2:]) / 3
        x = y
    return x


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser())
    ap.add_argument("-n", type=int, default=1 << 20)
    ap.add_argument("-s", "--steps", type=int, default=10)
    args = ap.parse_args(argv)

    import dr_tpu_torch as dt

    init(args)
    src = np.random.default_rng(0).standard_normal(args.n).astype(np.float32)
    hb = dt.halo_bounds(1, 1)
    a = dt.distributed_vector.from_array(src, halo=hb)
    b = dt.distributed_vector.from_array(src, halo=hb)

    out = dt.stencil_iterate(a, b, [1 / 3, 1 / 3, 1 / 3],
                             steps=args.steps)

    got = dt.to_numpy(out)
    ref = serial(src, args.steps)
    ok = np.allclose(got, ref, rtol=1e-3, atol=1e-5)
    print(f"n={args.n} steps={args.steps} nprocs={dt.nprocs()} "
          f"check={'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
