"""Conjugate gradients on a distributed sparse system: solve A x = b
(``examples/conjugate_gradient.py`` on ``dr_tpu_torch``).

A full composition of the algorithm surface in one loop: ``gemv`` (SpMV
over row tiles), ``dot`` and ``transform`` (axpy updates over a zip) on
block-distributed vectors.  ``dot`` of two f32 containers takes the
chunked dot (K3, ``csrc/dot.cu``) on a CUDA rank.

A is the 1-D Laplacian (tridiagonal [-1, 2, -1] plus identity shift):
symmetric positive definite, so CG converges.
"""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, init


def build_laplacian(n: int):
    """COO entries of I + Laplacian_1d (SPD, condition ~n^2/pi^2)."""
    ii = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    jj = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vv = np.concatenate([
        np.full(n, 3.0), np.full(n - 1, -1.0), np.full(n - 1, -1.0),
    ]).astype(np.float32)
    return ii, jj, vv


def _axpy(x, p, alpha):
    return x + alpha * p


def _axmy(r, ap, alpha):
    return r - alpha * ap


# Module-level ops with the coefficients as transform's trailing scalar
# arguments: every iteration reuses one cached program per update (the
# op's identity keys the cache; a fresh lambda per iteration would not).
def cg(A, b, iters: int, tol: float = 1e-6):
    """Textbook CG over the distributed containers; returns (x, resid,
    iterations)."""
    import dr_tpu_torch as dt

    n = len(b)
    x = dt.distributed_vector(n, np.float32)
    r = dt.distributed_vector(n, np.float32)
    p = dt.distributed_vector(n, np.float32)
    Ap = dt.distributed_vector(n, np.float32)
    dt.fill(x, 0.0)
    dt.copy(b, r)          # r = b - A @ 0 = b
    dt.copy(b, p)
    rs = float(dt.dot(r, r))
    for it in range(iters):
        dt.fill(Ap, 0.0)
        dt.gemv(Ap, A, p)  # gemv ACCUMULATES (c += A·b), hence the fill
        alpha = rs / float(dt.dot(p, Ap))
        # x += alpha p ; r -= alpha Ap   (zip | transform)
        dt.transform(dt.views.zip(x, p), x, _axpy, alpha)
        dt.transform(dt.views.zip(r, Ap), r, _axmy, alpha)
        rs_new = float(dt.dot(r, r))
        if rs_new < tol * tol:
            return x, np.sqrt(rs_new), it + 1
        beta = rs_new / rs
        dt.transform(dt.views.zip(r, p), p, _axpy, beta)
        rs = rs_new
    return x, np.sqrt(rs), iters


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser())
    ap.add_argument("-n", type=int, default=1 << 12)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)

    import dr_tpu_torch as dt

    init(args)
    n = args.n
    ii, jj, vv = build_laplacian(n)
    A = dt.sparse_matrix.from_coo((n, n), ii, jj, vv)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n).astype(np.float32)

    x, resid, its = cg(A, b, args.iters)

    # oracle: dense solve
    Ad = np.zeros((n, n), dtype=np.float64)
    Ad[ii, jj] = vv
    ref = np.linalg.solve(Ad, b.astype(np.float64))
    err = np.abs(dt.to_numpy(x) - ref).max()
    print(f"n={n} iters={its} resid={resid:.3e} max_err={err:.3e}")
    ok = resid < 1e-3 and err < 1e-2
    print("CG", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
