"""Subrange windows and mixed distributions, with no fallback anywhere
(``examples/windows_example.py`` on ``dr_tpu_torch``).

The reference's algorithms operate on whole aligned containers; its
misaligned shapes drop to a serial element fallback
(mhp/algorithms/cpu_algorithms.hpp:44-48).  Here every distributed shape
runs on the ranks: subrange windows, mismatched in/out windows
(realigned by one exchange), overlapping windows of one container,
uneven "team" distributions, and identityless custom reduction ops.

This example sorts a window in place, scans it into a differently-
offset destination window (the scan kernel K4, ``csrc/scan.cu``, on a
CUDA rank), key-value-sorts two overlapping windows of ONE container,
and folds a custom op over an uneven distribution, then checks
everything against numpy.
"""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, init


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser())
    ap.add_argument("-n", type=int, default=1 << 16)
    args = ap.parse_args(argv)
    n = args.n

    import dr_tpu_torch as dt

    init(args)
    P = dt.nprocs()
    rng = np.random.default_rng(0)
    src = rng.standard_normal(n).astype(np.float32)

    # 1. sort a window in place: outside cells stay untouched bit-exact
    v = dt.distributed_vector.from_array(src)
    lo, hi = n // 8, n - n // 8
    dt.sort(v[lo:hi])
    ref = src.copy()
    ref[lo:hi] = np.sort(src[lo:hi])
    np.testing.assert_array_equal(dt.to_numpy(v), ref)

    # 2. scan the sorted window into a DIFFERENT window of another
    # container (the in/out offsets differ; the scan realigns)
    out = dt.distributed_vector(n, np.float32)
    wn = hi - lo - 3
    dt.inclusive_scan(v[lo:lo + wn], out[3:3 + wn])
    got = dt.to_numpy(out)
    # f32 prefix sums of sorted data cross zero, so relative error is
    # unbounded there; accumulation-order noise grows like
    # eps32 * |prefix| * sqrt(terms): size the absolute tolerance from
    # the oracle's own magnitude so any -n passes
    oracle = np.cumsum(ref[lo:lo + wn].astype(np.float64))
    np.testing.assert_allclose(
        got[3:3 + wn], oracle, rtol=1e-3,
        atol=np.abs(oracle).max() * 1e-5 * np.sqrt(wn))

    # 3. overlapping key/value windows of ONE container (payload-last
    # blend order, the documented contract)
    w = dt.distributed_vector.from_array(src)
    kw = n // 2
    dt.sort_by_key(w[0:kw], w[kw // 2:kw // 2 + kw])
    wref = src.copy()
    order = np.argsort(src[0:kw], kind="stable")
    wref[0:kw] = src[0:kw][order]
    wref[kw // 2:kw // 2 + kw] = src[kw // 2:kw // 2 + kw][order]
    np.testing.assert_array_equal(dt.to_numpy(w), wref)

    # 4. identityless custom reduce over an uneven distribution (with
    # empty "team" ranks when there is more than one rank)
    if P == 1:
        sizes = [n]
    else:
        sizes = [0] * P
        sizes[0] = n // 2
        sizes[-1] = n - n // 2
    pos = np.abs(src) * 0.001 + 0.999
    u = dt.distributed_vector(n, np.float32, distribution=sizes)
    u.assign_array(pos)
    # fold over a bounded WINDOW of the uneven container: a product of
    # arbitrarily many near-1 factors would drift out of f32 range
    m = min(n, 8192)
    got_r = dt.reduce(u[0:m], op=lambda a, b: a * b * 1.0)
    np.testing.assert_allclose(
        got_r, float(np.prod(pos[:m].astype(np.float64))), rtol=1e-3)

    print(f"windows example OK: n={n} P={P} "
          f"(window sort + realigned scan + overlap kv + uneven "
          f"custom reduce)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
