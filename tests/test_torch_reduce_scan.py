"""dr_tpu_torch reductions, dot products and scans, and the plain
versions of K3 and K4, against dr_tpu on the CPU.

K3 runs as ``reduce_pallas.chunked_dot(..., interpret=True)`` and K4 as
``scan_pallas.chunked_cumsum(..., carry=..., interpret=True)``, as
``tests/test_scan.py`` runs them."""

import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu import views as jviews
from dr_tpu.ops import reduce_pallas as j_rp
from dr_tpu.ops import scan_pallas as j_scp
from dr_tpu_torch import views as tviews
from dr_tpu_torch.ops import reduce_pallas as t_rp
from dr_tpu_torch.ops import scan_pallas as t_scp


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)


def _pair(arr, **kw):
    return (dr_tpu.distributed_vector.from_array(arr, **kw),
            dt.distributed_vector.from_array(arr, **kw))


# ---------------------------------------------------------------- K3 / K4

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_plain_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(11)
    n = 128 * 512
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    jx, jy = jnp.asarray(x, dtype), jnp.asarray(y, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ty = torch.from_numpy(y).to(getattr(torch, dtype))
    for salt in (None, 0.25):
        ref = float(j_rp.chunked_dot(jx, jy, salt=salt, interpret=True))
        got = t_rp.chunked_dot(tx, ty, salt=salt)
        assert got.dtype == torch.float32 and got.dim() == 0
        # both accumulate the same (bf16-rounded) inputs in f32, in
        # different orders: 2^16 terms of O(1) agree to ~1e-4 relative
        assert abs(float(got) - ref) < 1e-4 * (abs(ref) + 1), (salt, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_plain_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(6)
    n = 128 * 128 * 2
    x = rng.standard_normal(n).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for carry in (None, 3.5):
        ref = np.asarray(j_scp.chunked_cumsum(
            jx, carry=carry, interpret=True).astype(jnp.float32))
        got = t_scp.chunked_cumsum(tx, carry=carry)
        assert got.dtype == tx.dtype
        got = got.float().numpy()
        scale = np.abs(ref).max() + 1
        if dtype == "float32":
            # f32 prefixes summed in two orders: ~1e-6 of the scale
            assert np.abs(got - ref).max() / scale < 1e-5
        else:
            # bf16 output rounds each prefix to 8 bits: one bf16 ulp
            # (2^-7 relative) of the largest prefix, twice for two paths
            assert np.abs(got - ref).max() <= 2 ** -6 * scale


# ------------------------------------------------------------- reductions

@pytest.mark.parametrize("op,kind", [(None, "add"), (operator.mul, "mul"),
                                     (min, "min"), (max, "max")])
def test_reduce_monoids_match_reference(mesh_size, op, kind):
    _init_both(mesh_size)
    n = 41
    rng = np.random.default_rng(len(kind))
    vals = (1.0 + 0.01 * rng.standard_normal(n)).astype(np.float32)
    ints = rng.integers(-50, 50, n).astype(np.int32)
    for arr in (vals, ints):
        j, t = _pair(arr)
        for jr, tr in ((j, t), (j[3:30], t[3:30]),
                       (jviews.transform(j, lambda x: x * 2),
                        tviews.transform(t, lambda x: x * 2))):
            ref = dr_tpu.reduce(jr, op=op)
            got = dt.reduce(tr, op=op)
            if arr.dtype == np.int32 or kind in ("min", "max"):
                assert got == ref  # exact monoids: bit-equal
            else:
                # f32 sums/products of 41 terms in two orders
                assert abs(got - ref) <= 1e-5 * abs(ref), (got, ref)
        assert dt.reduce(t, 7, op) == pytest.approx(dr_tpu.reduce(j, 7, op),
                                                    rel=1e-5)


def test_dot_and_transform_reduce_match_reference(mesh_size):
    _init_both(mesh_size)
    n = 77
    rng = np.random.default_rng(4)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    jx, tx = _pair(x)
    jy, ty = _pair(y)
    # f32 sums of 77 products in two orders: 1e-5 relative
    tol = 1e-5 * float(np.abs(x) @ np.abs(y))
    assert abs(dt.dot(tx, ty) - dr_tpu.dot(jx, jy)) <= tol
    assert abs(float(dt.dot_async(tx, ty)) - float(dr_tpu.dot_async(jx, jy))) \
        <= tol
    assert abs(dt.dot(tx[5:60], ty[5:60]) -
               dr_tpu.dot(jx[5:60], jy[5:60])) <= tol
    got = dt.transform_reduce(tx, 1.0, None, lambda v, mu: (v - mu) ** 2,
                              (0.5,))
    ref = dr_tpu.transform_reduce(jx, 1.0, None, lambda v, mu: (v - mu) ** 2,
                                  (0.5,))
    assert got == pytest.approx(ref, rel=1e-5)
    with pytest.raises(NotImplementedError):
        dt.reduce(tx, op=lambda p, q: p + q)


@pytest.mark.parametrize("halo", [0, 2])
def test_dot_n_matches_reference(halo):
    """Halo-free and ghost-bearing rows, both on the K3 route."""
    _init_both(8)
    n = 8 * 128 * 128
    rng = np.random.default_rng(9)
    x = rng.random(n).astype(np.float32)
    y = rng.random(n).astype(np.float32)
    kw = {"halo": dr_tpu.halo_bounds(halo, halo)} if halo else {}
    tkw = {"halo": dt.halo_bounds(halo, halo)} if halo else {}
    jx = dr_tpu.distributed_vector.from_array(x, **kw)
    jy = dr_tpu.distributed_vector.from_array(y, **kw)
    tx = dt.distributed_vector.from_array(x, **tkw)
    ty = dt.distributed_vector.from_array(y, **tkw)
    ref = float(dr_tpu.dot_n(jx, jy, 3))
    got = dt.dot_n(tx, ty, 3)
    assert got.dim() == 0
    # positive f32 sums of 2^17 terms in two orders: 1e-5 relative
    assert abs(float(got) - ref) <= 1e-5 * ref


# ------------------------------------------------------------------ scans

# f32 prefix sums taken in different orders: 1e-4 relative with an
# absolute floor for prefixes near zero (as test_scan.py states them)
SCAN_TOL = dict(rtol=1e-4, atol=1e-3)


def test_inclusive_exclusive_kernel_route(mesh_size):
    """Whole f32 containers on the K4 route (lane-chunkable segments),
    with a ragged tail at P > 1, against dr_tpu."""
    _init_both(mesh_size)
    P = mesh_size
    n = 128 * 128 * P - max(P - 1, 0)
    src = np.random.default_rng(12).standard_normal(n).astype(np.float32)
    ja, ta = _pair(src)
    jo, to = dr_tpu.distributed_vector(n), dt.distributed_vector(n)
    dr_tpu.inclusive_scan(ja, jo)
    dt.inclusive_scan(ta, to)
    np.testing.assert_allclose(dt.to_numpy(to), dr_tpu.to_numpy(jo),
                               **SCAN_TOL)
    dr_tpu.exclusive_scan(ja, jo)
    dt.exclusive_scan(ta, to)
    np.testing.assert_allclose(dt.to_numpy(to), dr_tpu.to_numpy(jo),
                               **SCAN_TOL)


@pytest.mark.parametrize("op", [None, operator.mul, min, max])
@pytest.mark.parametrize("P", [3, 8])
def test_scans_monoids_windows_and_init(P, op):
    """The torch route: int32 add (exact), f32 monoids, init folds; whole
    halo-free containers, and a same-geometry window of ghost-bearing
    rows."""
    _init_both(P)
    n = 53
    rng = np.random.default_rng(3)
    if op is operator.mul:
        src = (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)
    elif op is None:
        src = rng.integers(-9, 9, n).astype(np.int32)
    else:
        src = rng.standard_normal(n).astype(np.float32)
    for hb, (a, b) in ((None, (0, n)), ((1, 1, False), (4, 40))):
        jkw = {"halo": dr_tpu.halo_bounds(*hb)} if hb else {}
        tkw = {"halo": dt.halo_bounds(*hb)} if hb else {}
        ja = dr_tpu.distributed_vector.from_array(src, **jkw)
        ta = dt.distributed_vector.from_array(src, **tkw)
        jo = dr_tpu.distributed_vector(n, src.dtype, **jkw)
        to = dt.distributed_vector(n, src.dtype, **tkw)
        init = 2 if op is None else 1.5
        dr_tpu.inclusive_scan(ja[a:b], jo[a:b], op)
        dt.inclusive_scan(ta[a:b], to[a:b], op)
        np.testing.assert_allclose(dt.to_numpy(to), dr_tpu.to_numpy(jo),
                                   **SCAN_TOL)
        dr_tpu.exclusive_scan(ja[a:b], jo[a:b], init, op)
        dt.exclusive_scan(ta[a:b], to[a:b], init, op)
        np.testing.assert_allclose(dt.to_numpy(to), dr_tpu.to_numpy(jo),
                                   **SCAN_TOL)
        dr_tpu.inclusive_scan(ja[a:b], jo[a:b], op, init)
        dt.inclusive_scan(ta[a:b], to[a:b], op, init)
        # the rows, ghost and pad cells included
        np.testing.assert_allclose(
            np.concatenate([r.numpy() for r in to.rows]),
            np.asarray(jo._data), **SCAN_TOL)


def test_inclusive_scan_n_and_refusals():
    _init_both(4)
    n = 4 * 128 * 128
    src = (np.random.default_rng(5).standard_normal(n) * 1e-4).astype(
        np.float32)
    ja, ta = _pair(src)
    jo, to = dr_tpu.distributed_vector(n), dt.distributed_vector(n)
    dr_tpu.inclusive_scan_n(ja, jo, 2)
    dt.inclusive_scan_n(ta, to, 2)
    ref = dr_tpu.to_numpy(jo)
    # two chained f32 scans: 1e-4 of the largest value
    assert np.abs(dt.to_numpy(to) - ref).max() <= 1e-4 * np.abs(ref).max()
    with pytest.raises(NotImplementedError):
        dt.inclusive_scan(ta, to, lambda p, q: p + q)
    with pytest.raises(NotImplementedError):  # mismatched windows
        dt.inclusive_scan(ta[0:100], to[5:105])
    with pytest.raises(ValueError):
        dt.inclusive_scan(ta[0:100], to[0:50])


def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapper(*a, **kw):
        calls.append(a[0].numel())
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


# lengths that are not multiples of the JAX kernel's 16384-element lane
# chunks, ragged tails, ghost-bearing rows and windows
ROUTE_CASES = [(1000, 0, None), (3 * 16384 + 5, 2, None), (777, 1, (5, 700))]


@pytest.mark.parametrize("n,halo,win", ROUTE_CASES)
def test_every_f32_add_scan_takes_the_k4_wrapper(monkeypatch, n, halo, win):
    """Any length, layout or window of an f32 add-scan goes through
    ``chunked_cumsum`` (the kernel on a card); an int32 add-scan does not."""
    _init_both(3)
    calls = _counting(monkeypatch, t_scp, "chunked_cumsum")
    src = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    jkw = {"halo": dr_tpu.halo_bounds(halo, halo)} if halo else {}
    tkw = {"halo": dt.halo_bounds(halo, halo)} if halo else {}
    ja = dr_tpu.distributed_vector.from_array(src, **jkw)
    ta = dt.distributed_vector.from_array(src, **tkw)
    jo = dr_tpu.distributed_vector(n, **jkw)
    to = dt.distributed_vector(n, **tkw)
    a, b = win or (0, n)
    dr_tpu.inclusive_scan(ja[a:b], jo[a:b])
    dt.inclusive_scan(ta[a:b], to[a:b])
    assert len(calls) == 3  # one per rank
    np.testing.assert_allclose(dt.to_numpy(to), dr_tpu.to_numpy(jo),
                               **SCAN_TOL)
    ti = dt.distributed_vector.from_array(src.astype(np.int32), **tkw)
    dt.inclusive_scan(ti, dt.distributed_vector(n, np.int32, **tkw))
    assert len(calls) == 3  # integer sums stay exact on torch's cumsum


@pytest.mark.parametrize("n,halo,win", ROUTE_CASES)
def test_every_f32_dot_n_takes_the_k3_wrapper(monkeypatch, n, halo, win):
    """Any length, halo or window of an f32 ``dot_n`` goes through
    ``chunked_dot`` (the kernel on a card), against dr_tpu."""
    _init_both(3)
    calls = _counting(monkeypatch, t_rp, "chunked_dot")
    rng = np.random.default_rng(n)
    x = rng.random(n).astype(np.float32)
    y = rng.random(n).astype(np.float32)
    jkw = {"halo": dr_tpu.halo_bounds(halo, halo)} if halo else {}
    tkw = {"halo": dt.halo_bounds(halo, halo)} if halo else {}
    jx, jy = (dr_tpu.distributed_vector.from_array(v, **jkw) for v in (x, y))
    tx, ty = (dt.distributed_vector.from_array(v, **tkw) for v in (x, y))
    a, b = win or (0, n)
    ref = float(dr_tpu.dot_n(jx[a:b], jy[a:b], 2))
    got = dt.dot_n(tx[a:b], ty[a:b], 2)
    assert len(calls) == 2 * 3  # one per rank and round
    assert sum(calls) == 2 * (b - a)  # the owned window cells, once each
    # positive f32 sums of <= 5e4 terms in two orders: 1e-5 relative
    assert abs(float(got) - ref) <= 1e-5 * ref


def test_scan_of_a_zip_transform_takes_the_k4_wrapper(monkeypatch):
    """A multi-component input (materialized, then scanned whole) also
    goes through ``chunked_cumsum``, against dr_tpu."""
    _init_both(3)
    calls = _counting(monkeypatch, t_scp, "chunked_cumsum")
    n = 300
    rng = np.random.default_rng(8)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    (jx, tx), (jy, ty) = _pair(x), _pair(y)
    jo, to = dr_tpu.distributed_vector(n), dt.distributed_vector(n)
    dr_tpu.inclusive_scan(jviews.transform(jviews.zip_view(jx, jy),
                                           lambda p, q: p * q), jo)
    dt.inclusive_scan(tviews.transform(tviews.zip_view(tx, ty),
                                       lambda p, q: p * q), to)
    assert calls == [n]
    np.testing.assert_allclose(dt.to_numpy(to), dr_tpu.to_numpy(jo),
                               **SCAN_TOL)
