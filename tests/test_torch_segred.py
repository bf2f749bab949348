"""K7's plain version against ``dr_tpu.ops.segred_pallas.segmented(...,
interpret=True)``, and ``reduce``'s K7 route against ``dr_tpu.reduce``,
on the CPU.

Every comparison is bit-exact (a NaN equals a NaN at the same
position): every eligible monoid is order-free at the bit level, so both
packages combine the same multiset of elements to the same bits."""

import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.ops import segred_pallas as j_sr
from dr_tpu_torch.ops import segred_pallas as t_sr

_BITS = {2: np.int16, 4: np.int32, 8: np.int64}


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(_BITS[a.dtype.itemsize])


def assert_same_bits(got, want):
    """Bit-equal, a NaN matching a NaN at the same position."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype.itemsize == \
        want.dtype.itemsize, (got.dtype, want.dtype, got.shape, want.shape)
    if got.dtype.kind == "f" or str(got.dtype) == "bfloat16":
        gn = np.isnan(got.astype(np.float32))
        wn = np.isnan(want.astype(np.float32))
        np.testing.assert_array_equal(gn, wn)
        got, want = got[~gn], want[~wn]
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _to_torch(v: np.ndarray, dtype: str):
    return torch.from_numpy(v.astype(np.float32)).to(getattr(torch, dtype)) \
        if dtype in ("bfloat16", "float16") else \
        torch.from_numpy(v.astype(dtype))


def _values(rng, n, dtype, nan=True):
    """Values with +-0, infinities and (``nan``) NaN for floats; a wide
    spread with wraparound for int32 sums and products."""
    if dtype == "int32":
        return rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64) \
            .astype(np.int32)
    v = rng.standard_normal(n).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf] + [np.nan] * nan,
                       np.float32)
    pos = rng.integers(0, n, max(n // 8, 1))
    v[pos] = special[rng.integers(0, len(special), len(pos))]
    return v


COLS = [("int32", "sum"), ("int32", "prod"), ("int32", "min"),
        ("int32", "max"), ("float32", "min"), ("float32", "max"),
        ("bfloat16", "min"), ("bfloat16", "max")]


@pytest.mark.parametrize("n,nseg", [(1, 1), (1000, 1), (1000, 127),
                                    (1000, 128), (1000, 129), (300, 40)])
def test_k7_plain_matches_pallas_interpret(n, nseg):
    """Every eligible column at once, ids spread over [-3, nseg + 3)
    (out-of-range ids contribute nothing) so some segments stay empty."""
    rng = np.random.default_rng(n * 1000 + nseg)
    ids = rng.integers(-3, nseg + 3, n).astype(np.int32)
    vals = {c: _values(rng, n, c[0]) for c in COLS}
    for lo in range(0, len(COLS), 4):  # the port's kernel takes 4 columns
        cols = COLS[lo:lo + 4]
        ref = j_sr.segmented(jnp.asarray(ids), nseg,
                             [(jnp.asarray(vals[c], c[0]), c[1])
                              for c in cols],
                             interpret=True)
        got = t_sr.segmented(torch.from_numpy(ids), nseg,
                             [(_to_torch(vals[c], c[0]), c[1]) for c in cols])
        for c, r, g in zip(cols, ref, got):
            assert g.dtype == getattr(torch, c[0]) and g.shape == (nseg,)
            gn = g.float().numpy() if c[0] == "bfloat16" else g.numpy()
            rn = np.asarray(r.astype(jnp.float32)) if c[0] == "bfloat16" \
                else np.asarray(r)
            assert_same_bits(gn, rn)


def _narrow_values(rng, n, dtype, op):
    """The full range of an 8- or 16-bit integer column (odd for
    products, so they wrap without collapsing to 0); 0/1 for bool."""
    if dtype == "bool":
        return rng.integers(0, 2, n).astype(bool)
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)
    return v | 1 if op == "prod" else v


NARROW = [(d, op) for d in ("int8", "uint8", "int16")
          for op in ("sum", "prod", "min", "max")]


@pytest.mark.parametrize("dtype,op", NARROW)
@pytest.mark.parametrize("nseg", [1, 129])
def test_k7_plain_narrow_columns_match_pallas_interpret(dtype, op, nseg):
    """8- and 16-bit integer columns: sums and products wrap modulo the
    column's width, as the interpret-mode Pallas kernel stores them;
    min/max are exact."""
    rng = np.random.default_rng(nseg + len(dtype) + len(op))
    n = 1000
    ids = rng.integers(-3, nseg + 3, n).astype(np.int32)
    v = _narrow_values(rng, n, dtype, op)
    ref = j_sr.segmented(jnp.asarray(ids), nseg, [(jnp.asarray(v), op)],
                         interpret=True)[0]
    got = t_sr.segmented(torch.from_numpy(ids), nseg,
                         [(torch.from_numpy(v), op)])[0]
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("op,fold", [("min", np.all), ("max", np.any),
                                     ("sum", np.any), ("prod", np.all)])
def test_k7_plain_bool_columns(op, fold):
    """bool min and prod are "all" and max and sum "any" per segment
    (a sum stored as bool), an empty segment holding the identity (True
    for min/prod, False for max/sum); the JAX package's kernel takes no
    bool column (no bool identity for min/max, and its bool sum stores
    int32 into a bool output), so numpy is the reference."""
    rng = np.random.default_rng(len(op))
    ids = rng.integers(-1, 9, 200).astype(np.int32)
    v = rng.random(200) < 0.8
    got = t_sr.segmented(torch.from_numpy(ids), 10,
                         [(torch.from_numpy(v), op)])[0].numpy()
    want = np.array([fold(v[ids == s]) for s in range(10)])
    np.testing.assert_array_equal(got, want)
    assert got[9] == (op in ("min", "prod"))


def test_k7_signed_zeros_and_nan_per_segment():
    """min over {+0, -0, 1} is -0.0 and max over {-0, +0, -1} is +0.0 in
    both packages; a NaN anywhere in a segment makes it NaN; an empty
    segment holds the identity (+inf for min, -inf for max)."""
    v = np.array([0.0, -0.0, 1.0, -0.0, 0.0, -1.0, 2.0, np.nan],
                 np.float32)
    ids = np.array([0, 0, 0, 1, 1, 1, 2, 2], np.int32)
    for op in ("min", "max"):
        ref = j_sr.segmented(jnp.asarray(ids), 4, [(jnp.asarray(v), op)],
                             interpret=True)[0]
        got = t_sr.segmented(torch.from_numpy(ids), 4,
                             [(torch.from_numpy(v), op)])[0]
        assert_same_bits(got.numpy(), np.asarray(ref))
    lo = t_sr.segmented(torch.from_numpy(ids), 4,
                        [(torch.from_numpy(v), "min")])[0].numpy()
    assert np.signbit(lo[0]) and np.isnan(lo[2]) and lo[3] == np.inf


def test_k7_eligibility_matches_reference_without_the_n_cap():
    for n, nseg, cols in [(1000, 1, [("float32", "min")]),
                          (1 << 15, 1 << 15, [("int32", "sum")]),
                          (1000, (1 << 15) + 1, [("int32", "max")]),
                          (1000, 0, [("int32", "max")]),
                          (1000, 4, [("float32", "sum")]),
                          (1000, 4, [("bfloat16", "prod")]),
                          (1000, 4, [("int32", "prod"), ("float32", "max")])]:
        ref = j_sr.eligible(n, nseg, [(jnp.dtype(d), op) for d, op in cols])
        got = t_sr.eligible(n, nseg, [(getattr(torch, d), op)
                                      for d, op in cols])
        assert got == ref, (n, nseg, cols)
    # the JAX package's n <= 2^15 cap is a TPU VMEM rule, dropped here
    assert not j_sr.eligible(1 << 20, 1, [(jnp.float32, "min")])
    assert t_sr.eligible(1 << 20, 1, [(torch.float32, "min")])


def test_k7_no_ids_is_one_segment():
    rng = np.random.default_rng(3)
    for dtype, op in COLS:
        v = _to_torch(_values(rng, 777, dtype), dtype)
        a = t_sr.segmented(None, 3, [(v, op)])[0]
        b = t_sr.segmented(torch.zeros(777, dtype=torch.int32), 3,
                           [(v, op)])[0]
        assert_same_bits(a.float().numpy() if dtype == "bfloat16"
                         else a.numpy(),
                         b.float().numpy() if dtype == "bfloat16"
                         else b.numpy())


# ------------------------------------------------------------ reduce route

def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)


def _counting(monkeypatch):
    calls = []
    real = t_sr.segmented

    def wrapper(segid, nseg, cols):
        calls.append(cols[0][0].numel())
        return real(segid, nseg, cols)

    monkeypatch.setattr(t_sr, "segmented", wrapper)
    return calls


def _host_scalar(x, dtype):
    return np.asarray(x, dtype=dtype).reshape(1)


K7_REDUCES = [(d, op, kind) for d in ("float32", "int32", "bfloat16")
              for op, kind in ((min, "min"), (max, "max"))] + \
    [("int32", None, "add"), ("int32", operator.mul, "mul")]


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("dtype,op,kind", K7_REDUCES)
def test_reduce_k7_route_matches_reference(monkeypatch, P, dtype, op, kind):
    """Plain containers and windows of eligible monoids go through K7,
    one call per rank over its owned cells; the result equals
    ``dr_tpu.reduce``'s bit for bit.  NaN and zeros only at P == 1:
    dr_tpu's cross-shard min/max on the CPU mesh drops a shard whose
    partial is NaN and may pick +0.0 over -0.0 (ROADMAP.md section 3);
    test_reduce_nan_propagates and test_torch_reduce_scan.py cover
    P > 1."""
    _init_both(P)
    calls = _counting(monkeypatch)
    rng = np.random.default_rng(P * 10 + len(kind))
    n = 53
    src = _values(rng, n, "int32" if dtype == "int32" else "float32",
                  nan=P == 1)
    if P > 1 and dtype != "int32":
        src[src == 0] = 1.5  # signed zeros: test_torch_reduce_scan.py
    if dtype == "bfloat16":
        j = dr_tpu.distributed_vector(n, dtype=jnp.bfloat16)
        j.assign_array(src.astype(jnp.bfloat16))
        t = dt.distributed_vector(n, dtype="bfloat16")
        t.assign_array(torch.from_numpy(src).to(torch.bfloat16))
    else:
        j = dr_tpu.distributed_vector.from_array(src)
        t = dt.distributed_vector.from_array(src)
    npdt = np.float32 if dtype != "int32" else np.int32
    for jr, tr in ((j, t), (j[4:41], t[4:41])):
        before = len(calls)
        ref = dr_tpu.reduce(jr, op=op)
        got = dt.reduce(tr, op=op)
        assert len(calls) - before == P
        assert_same_bits(_host_scalar(got, npdt), _host_scalar(ref, npdt))
    assert sum(calls[:P]) == n


def test_reduce_routes(monkeypatch):
    """View chains, zips, float sums and 8-byte dtypes keep the torch
    route; an int8 max and an int32 sum of a window take K7."""
    _init_both(3)
    calls = _counting(monkeypatch)
    x = dt.distributed_vector.from_array(np.arange(30, dtype=np.float32))
    dt.reduce(dt.views.transform(x, lambda v: v * 2.0), op=min)
    dt.reduce(x)
    dt.dot(x, x)
    dt.reduce(dt.distributed_vector.from_array(
        np.arange(30, dtype=np.int64)), op=max)
    assert calls == []
    assert dt.reduce(dt.distributed_vector.from_array(
        np.arange(30, dtype=np.int8)), op=max) == 29
    assert calls == [10, 10, 10]
    i = dt.distributed_vector.from_array(np.arange(30, dtype=np.int32))
    assert dt.reduce(i[5:20]) == sum(range(5, 20))
    assert calls[3:] == [5, 10, 0]  # one call per rank, empty ranks too


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("dtype,kind", NARROW + [("bool", "sum"),
                                                 ("bool", "prod")])
def test_reduce_k7_narrow_matches_reference(monkeypatch, P, dtype, kind):
    """8- and 16-bit integer and bool containers take K7, one call per
    rank; add/mul accumulate in int32 as ``jnp.sum``/``jnp.prod`` do (a
    uint8 result modulo 2^32, jnp's uint32), so ``dt.reduce`` equals
    ``dr_tpu.reduce`` exactly, on a container and on a window."""
    kind = {"sum": "add", "prod": "mul"}.get(kind, kind)
    op = {"add": None, "mul": operator.mul, "min": min, "max": max}[kind]
    _init_both(P)
    calls = _counting(monkeypatch)
    rng = np.random.default_rng(P + len(dtype) + len(kind))
    n = 61
    src = _narrow_values(rng, n, dtype, "prod" if kind == "mul" else kind)
    j = dr_tpu.distributed_vector.from_array(src)
    t = dt.distributed_vector.from_array(src)
    for jr, tr in ((j, t), (j[3:50], t[3:50])):
        before = len(calls)
        assert dt.reduce(tr, op=op) == dr_tpu.reduce(jr, op=op)
        assert len(calls) - before == P


@pytest.mark.parametrize("P", [1, 3])
def test_reduce_k7_bool_min_max(monkeypatch, P):
    """bool min/max take K7 ("all"/"any"); the JAX package has no bool
    min/max identity, so numpy is the reference."""
    dt.init(["cpu"] * P)
    calls = _counting(monkeypatch)
    for v in ([True] * 20, [True] * 19 + [False], [False] * 20):
        t = dt.distributed_vector.from_array(np.array(v))
        assert dt.reduce(t, op=min) == all(v)
        assert dt.reduce(t, op=max) == any(v)
    assert len(calls) == 6 * P


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_nan_propagates(P, dtype):
    """A NaN in any rank makes min and max NaN, on the K7 route (plain
    container) and on the torch route (view chain), as XLA's reduce and
    ``dr_tpu.reduce`` on one shard give."""
    dt.init(["cpu"] * P)
    for pos in (0, 5, 11):
        src = torch.arange(12, dtype=torch.float32)
        src[pos] = float("nan")
        t = dt.distributed_vector.from_array(src.to(dtype))
        for r in (t, dt.views.transform(t, lambda v: v * 1.0)):
            assert np.isnan(dt.reduce(r, op=min))
            assert np.isnan(dt.reduce(r, op=max))


UNALIGNED = [("float32", min, "min"), ("float32", max, "max"),
             ("int32", None, "add"), ("int32", min, "min"),
             ("int32", max, "max"), ("bfloat16", min, "min"),
             ("int8", max, "max"), ("int16", None, "add")]


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("dtype,op,kind", UNALIGNED)
def test_reduce_k7_unaligned_windows_match_reference(monkeypatch, P, dtype,
                                                     op, kind):
    """Windows that start at odd columns of a halo-bearing vector: the
    row slices ``reduce`` hands K7 (``c.cont._rows[r][0, a:b]``) start off
    any 16-byte boundary and end in ragged tails, which the kernel reads
    with a scalar head and tail around its vector loads; the result
    equals ``dr_tpu.reduce`` bit for bit, one K7 call a rank."""
    _init_both(P)
    calls = _counting(monkeypatch)
    rng = np.random.default_rng(P * 100 + len(dtype) + len(kind))
    n = 71
    if dtype in ("int8", "int16"):
        src = _narrow_values(rng, n, dtype, "sum")
    else:
        src = _values(rng, n, "int32" if dtype == "int32" else "float32",
                      nan=False)
        if dtype != "int32":
            src[src == 0] = 1.5  # signed zeros: test_torch_reduce_scan.py
    if dtype == "bfloat16":
        j = dr_tpu.distributed_vector(n, dtype=jnp.bfloat16,
                                      halo=dr_tpu.halo_bounds(3, 2))
        j.assign_array(src.astype(jnp.bfloat16))
        t = dt.distributed_vector(n, dtype="bfloat16",
                                  halo=dt.halo_bounds(3, 2))
        t.assign_array(torch.from_numpy(src).to(torch.bfloat16))
    else:
        j = dr_tpu.distributed_vector.from_array(
            src, halo=dr_tpu.halo_bounds(3, 2))
        t = dt.distributed_vector.from_array(src, halo=dt.halo_bounds(3, 2))
    npdt = {"float32": np.float32, "bfloat16": np.float32}.get(dtype,
                                                               np.int64)
    for a, b in ((1, 70), (3, 64), (5, 66), (7, 9), (2, 3)):
        before = len(calls)
        ref = dr_tpu.reduce(j[a:b], op=op)
        got = dt.reduce(t[a:b], op=op)
        assert len(calls) - before == P
        assert_same_bits(_host_scalar(got, npdt), _host_scalar(ref, npdt))
