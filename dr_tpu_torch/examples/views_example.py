"""Views tour: take/drop/slice/zip/transform/enumerate over distributed
vectors (reference ``examples/shp/{zip,take}*.cpp``,
``examples/mhp/views``; ``examples/views_example.py`` on
``dr_tpu_torch``)."""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, expect, init


def main(argv=None) -> int:
    args = device_args(argparse.ArgumentParser()).parse_args(argv)

    import dr_tpu_torch as dt
    from dr_tpu_torch import views

    init(args)
    n = 1 << 10
    a = dt.distributed_vector(n)
    b = dt.distributed_vector(n)
    dt.iota(a, 0)
    dt.fill(b, 1.0)

    taken = a | views.take(100)
    expect(len(taken) == 100, f"take(100) has {len(taken)} elements")

    sl = a | views.slice_view((10, 20))
    np.testing.assert_array_equal(dt.to_numpy(sl),
                                  np.arange(10, 20, dtype=np.float32))

    doubled = a | views.transform(lambda x: 2 * x)
    got = dt.reduce(doubled)
    want = float(np.arange(n, dtype=np.float64).sum() * 2)
    expect(got == want, f"reduce of the doubled view: {got} != {want}")

    z = views.zip_view(a, b)
    expect(dt.aligned(a, b), "a and b are not aligned")
    c = dt.distributed_vector(n)
    dt.transform(z, c, lambda x, y: x + y)
    np.testing.assert_array_equal(dt.to_numpy(c),
                                  np.arange(n, dtype=np.float32) + 1)

    first = list(views.enumerate_view(a | views.take(3)))
    expect(first == [(0, 0.0), (1, 1.0), (2, 2.0)],
           f"enumerate of take(3): {first}")

    dt.print_range(a | views.take(8), "a[:8]")
    print("views example: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
