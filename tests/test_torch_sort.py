"""dr_tpu_torch's sort family against dr_tpu on the CPU, with the same
numpy-seeded inputs; the cases mirror ``tests/test_sort.py``.

Every comparison is bit-exact: a sort is a permutation, and both
packages decode the same order keys (a NaN decodes to the same
canonical NaN in both).  K6's plain version is held against
``dr_tpu.ops.sort_pallas`` in interpret mode at M = 256 (deeper networks
trace too slowly, as ``tests/test_fuzz.py`` marks them) and against
``lax.sort`` of the encoding up to M = 2^15."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.algorithms.sort import SORT_PHASES as J_SORT_PHASES
from dr_tpu.algorithms.sort import SORTKV_PHASES as J_SORTKV_PHASES
from dr_tpu.ops import sort_pallas as j_sp
from dr_tpu_torch.algorithms import sort as t_sort
from dr_tpu_torch.ops import sort_pallas as t_sp

_BITS = {2: np.int16, 4: np.int32, 8: np.int64}


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)


def _host(x):
    a = np.asarray(x)
    if str(a.dtype) == "bfloat16":
        a = a.astype(np.float32)
    return a


def assert_bits(got, want):
    """Bit-equal arrays (bf16 compared through its exact f32 values)."""
    got, want = _host(got), _host(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(_BITS[got.dtype.itemsize])
                                  if got.dtype.kind == "f" else got,
                                  want.view(_BITS[want.dtype.itemsize])
                                  if want.dtype.kind == "f" else want)


def _pair(arr, **kw):
    return (dr_tpu.distributed_vector.from_array(arr, **kw),
            dt.distributed_vector.from_array(arr, **kw))


def _both(fn, j, t):
    fn(dr_tpu, j)
    fn(dt, t)
    assert_bits(dt.to_numpy(t), dr_tpu.to_numpy(j))


def _specials(rng, n):
    """f32 data with NaN, +-0.0 and infinities planted."""
    v = rng.standard_normal(n).astype(np.float32)
    sp = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf], np.float32)
    pos = rng.integers(0, n, max(n // 4, 1))
    v[pos] = sp[rng.integers(0, len(sp), len(pos))]
    return v


# ------------------------------------------------------------------ K6

def _jax_key(k: np.ndarray) -> np.ndarray:
    """The port's signed int32 order key as the JAX package's uint32."""
    return (k.astype(np.int64) + 2 ** 31).astype(np.uint32)


@pytest.mark.parametrize("n", [256, 200, 1])
def test_k6_plain_matches_pallas_interpret(n):
    """Keys-only and (key, gid) pairs at M = 256, with duplicates, keys
    at the pad (INT32_MAX / uint32 max) and f32 NaN/+-0 encodings."""
    rng = np.random.default_rng(n)
    enc = t_sort._encode(torch.from_numpy(_specials(rng, n)))[0].numpy()
    for keys in (rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32),
                 rng.integers(0, 4, n).astype(np.int32),
                 np.where(rng.random(n) < 0.3, 2 ** 31 - 1,
                          rng.integers(-9, 9, n)).astype(np.int32), enc):
        gid = rng.permutation(n).astype(np.int32)
        ref = np.asarray(j_sp.sort_keys(jnp.asarray(_jax_key(keys)),
                                        interpret=True))
        got = t_sp.sort_keys(torch.from_numpy(keys)).numpy()
        np.testing.assert_array_equal(_jax_key(got), ref)
        rk, rg = j_sp.sort_kv(jnp.asarray(_jax_key(keys)), jnp.asarray(gid),
                              interpret=True)
        gk, gg = t_sp.sort_kv(torch.from_numpy(keys), torch.from_numpy(gid))
        np.testing.assert_array_equal(_jax_key(gk.numpy()), np.asarray(rk))
        np.testing.assert_array_equal(gg.numpy(), np.asarray(rg))


@pytest.mark.parametrize("M", [256, 4096, 1 << 15])
def test_k6_plain_matches_lax_sort(M):
    """Up to the cap, against ``lax.sort`` of the same int32 keys (one
    key, and the two-key (key, gid) order), padded blocks included, with
    keys at the pad and pad-like pairs."""
    rng = np.random.default_rng(M)
    n = M - 37
    keys = rng.integers(-50, 50, n).astype(np.int32)
    keys[::9] = np.iinfo(np.int32).max
    gid = rng.permutation(n).astype(np.int32)
    gid[-3:] = np.iinfo(np.int32).max
    keys[-3:] = np.iinfo(np.int32).max  # identical pairs
    assert t_sp.eligible(n, torch.int32)
    np.testing.assert_array_equal(
        t_sp.sort_keys(torch.from_numpy(keys)).numpy(),
        np.asarray(lax.sort(jnp.asarray(keys))))
    rk, rg = lax.sort((jnp.asarray(keys), jnp.asarray(gid)), num_keys=2)
    gk, gg = t_sp.sort_kv(torch.from_numpy(keys), torch.from_numpy(gid))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(gg.numpy(), np.asarray(rg))


def test_k6_plain_int64_keys_against_numpy():
    """8-byte keys (the f64 encoding) are not K6's and sort on the plain
    version: against numpy, the pairs by ``np.lexsort``."""
    rng = np.random.default_rng(2)
    n = 3000
    keys = rng.integers(-2 ** 62, 2 ** 62, n)
    keys[::7] = keys[3]
    keys[::11] = np.iinfo(np.int64).max
    gid = rng.permutation(n).astype(np.int32)
    assert not t_sp.eligible(n, torch.int64)
    np.testing.assert_array_equal(
        t_sp.sort_keys(torch.from_numpy(keys)).numpy(), np.sort(keys))
    order = np.lexsort((gid, keys))
    gk, gg = t_sp.sort_kv(torch.from_numpy(keys), torch.from_numpy(gid))
    np.testing.assert_array_equal(gk.numpy(), keys[order])
    np.testing.assert_array_equal(gg.numpy(), gid[order])


def _k6_batch(rng, b, n):
    """A (b, n) batch of int32 keys and distinct gids: random keys,
    duplicates, keys at the pad (INT32_MAX) and pad-like pairs
    (INT32_MAX, INT32_MAX) in every row."""
    imax = np.iinfo(np.int32).max
    keys = rng.integers(-2 ** 31, 2 ** 31 - 1, (b, n)).astype(np.int32)
    keys[:, ::3] = rng.integers(-4, 4, (b, len(range(0, n, 3))))
    keys[:, 1::7] = imax
    gid = np.stack([rng.permutation(n) for _ in range(b)]).astype(np.int32)
    keys[:, -2:] = imax
    gid[:, -2:] = imax
    return keys, gid


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("n", [256, 219])
def test_k6_plain_batch_matches_blocks_and_pallas_interpret(b, n):
    """The plain version on a (b, n) batch at M = 256, full and padded
    rows: every row equals the plain version of that row alone, and
    ``dr_tpu.ops.sort_pallas`` in interpret mode on that row, keys-only
    and (key, gid) pairs."""
    rng = np.random.default_rng(b * 1000 + n)
    keys, gid = _k6_batch(rng, b, n)
    tk, tg = torch.from_numpy(keys), torch.from_numpy(gid)
    assert t_sp.check_batch(tk, tg) == (b, n)
    got = t_sp.sort_keys(tk)
    gk, gg = t_sp.sort_kv(tk, tg)
    assert got.shape == gk.shape == gg.shape == (b, n)
    for r in range(b):
        np.testing.assert_array_equal(got[r].numpy(),
                                      t_sp.sort_keys(tk[r]).numpy())
        rk, rg = t_sp.sort_kv(tk[r], tg[r])
        np.testing.assert_array_equal(gk[r].numpy(), rk.numpy())
        np.testing.assert_array_equal(gg[r].numpy(), rg.numpy())
        ref = np.asarray(j_sp.sort_keys(jnp.asarray(_jax_key(keys[r])),
                                        interpret=True))
        np.testing.assert_array_equal(_jax_key(got[r].numpy()), ref)
        jk, jg = j_sp.sort_kv(jnp.asarray(_jax_key(keys[r])),
                              jnp.asarray(gid[r]), interpret=True)
        np.testing.assert_array_equal(_jax_key(gk[r].numpy()),
                                      np.asarray(jk))
        np.testing.assert_array_equal(gg[r].numpy(), np.asarray(jg))


def test_k6_plain_int64_batch_against_numpy():
    """8-byte keys on a batch take the plain version row by row: against
    ``np.lexsort`` of each row."""
    rng = np.random.default_rng(5)
    keys = rng.integers(-2 ** 62, 2 ** 62, (3, 500))
    keys[:, ::5] = keys[:, 2:3]
    gid = np.stack([rng.permutation(500) for _ in range(3)]).astype(np.int32)
    gk, gg = t_sp.sort_kv(torch.from_numpy(keys), torch.from_numpy(gid))
    for r in range(3):
        order = np.lexsort((gid[r], keys[r]))
        np.testing.assert_array_equal(gk[r].numpy(), keys[r][order])
        np.testing.assert_array_equal(gg[r].numpy(), gid[r][order])


_K6_REFUSED = {
    "3-D batch": lambda: (torch.zeros((2, 2, 256), dtype=torch.int32),
                          None),
    "gid of another shape": lambda: (
        torch.zeros((2, 256), dtype=torch.int32),
        torch.zeros((2, 255), dtype=torch.int32)),
    "int64 keys": lambda: (torch.zeros((2, 256), dtype=torch.int64), None),
    "int64 gids": lambda: (torch.zeros(256, dtype=torch.int32),
                           torch.zeros(256, dtype=torch.int64)),
    "non-contiguous batch": lambda: (
        torch.zeros((256, 4), dtype=torch.int32).t(), None),
    "non-contiguous row slices": lambda: (
        torch.zeros((3, 300), dtype=torch.int32)[:, :256], None),
    "n above 2^15": lambda: (
        torch.zeros((2, (1 << 15) + 1), dtype=torch.int32), None),
    "empty block": lambda: (torch.zeros((2, 0), dtype=torch.int32), None),
    "empty batch": lambda: (torch.zeros((0, 256), dtype=torch.int32), None),
}


@pytest.mark.parametrize("case", sorted(_K6_REFUSED))
def test_k6_check_batch_refuses(case):
    """The device-free validation of a K6 call raises on what the kernel
    does not take."""
    keys, gid = _K6_REFUSED[case]()
    with pytest.raises(ValueError):
        t_sp.check_batch(keys, gid)


@pytest.mark.parametrize("shape", [(1,), (256,), (1 << 15,), (1, 300),
                                   (133, 16384)])
def test_k6_check_batch_takes(shape):
    keys = torch.zeros(shape, dtype=torch.int32)
    want = (1,) + shape if len(shape) == 1 else shape
    assert t_sp.check_batch(keys, torch.zeros_like(keys)) == want
    assert t_sp.check_batch(keys) == want


def test_k6_eligibility():
    for n, ok in ((1, True), (256, True), (1 << 15, True),
                  ((1 << 15) + 1, False), (0, False)):
        assert j_sp.eligible(n, jnp.uint32) == ok
        assert t_sp.eligible(n, torch.int32) == ok
    # 8-byte keys: interpret-only in the JAX package, torch.sort here
    assert j_sp.eligible(100, np.dtype("int64"), interpret=True)
    assert not j_sp.eligible(100, np.dtype("int64"))
    assert not t_sp.eligible(100, torch.int64)
    assert not t_sp.eligible(100, torch.float32)
    assert [t_sp.padded(n) for n in (1, 256, 257, 5000)] == \
        [j_sp._padded(n) for n in (1, 256, 257, 5000)]


def _counting(monkeypatch):
    calls = []
    for name in ("sort_keys", "sort_kv"):
        real = getattr(t_sp, name)

        def wrapper(*a, real=real, name=name):
            calls.append((name, tuple(a[0].shape)))
            return real(*a)
        monkeypatch.setattr(t_sp, name, wrapper)
    return calls


@pytest.mark.parametrize("P,per", [(8, 2048), (4, 1 << 15), (2, 1 << 16)])
def test_local_sort_takes_k6_up_to_the_cap(monkeypatch, P, per):
    """The ranks' blocks go through the K6 wrapper as one (P, S) batch a
    device and sort (every CPU rank is one device) while the padded
    block is at most 2^15 keys, and through torch.sort above it; the
    results equal dr_tpu's."""
    _init_both(P)
    calls = _counting(monkeypatch)
    n = P * per - 5
    rng = np.random.default_rng(per)
    src = rng.standard_normal(n).astype(np.float32)
    _both(lambda m, v: m.sort(v), *_pair(src))
    keys = rng.integers(0, 9, n).astype(np.float32)
    pay = np.arange(n, dtype=np.int32)
    (jk, tk), (jv, tv) = _pair(keys), _pair(pay)
    dr_tpu.sort_by_key(jk, jv)
    dt.sort_by_key(tk, tv)
    assert_bits(dt.to_numpy(tv), dr_tpu.to_numpy(jv))
    S = -(-n // P)
    want = [] if S > 1 << 15 else \
        [("sort_keys", (P, S)), ("sort_kv", (P, S))]
    assert calls == want


# ------------------------------------------------------------- keys-only

def test_sort_rank_sweep(mesh_size):
    P = mesh_size
    dt.init(["cpu"] * P)
    n = 4 * P + 3
    src = np.random.default_rng(P).standard_normal(n).astype(np.float32)
    j, t = _pair(src)
    _both(lambda m, v: m.sort(v), j, t)
    np.testing.assert_array_equal(dt.to_numpy(t), np.sort(src))
    _both(lambda m, v: m.sort(v, descending=True), j, t)
    np.testing.assert_array_equal(dt.to_numpy(t), np.sort(src)[::-1])


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("kind", ["f32 specials", "int32", "bf16",
                                  "duplicates", "sentinels", "sorted",
                                  "reversed"])
def test_sort_dtypes_and_adversarial_inputs(P, kind):
    """NaNs last, -0.0 before +0.0, keys equal to the pad sentinel
    (inf / int32 max), skewed inputs; ascending and descending."""
    _init_both(P)
    rng = np.random.default_rng(P * 7 + len(kind))
    n = 150
    if kind == "f32 specials":
        src = _specials(rng, n)
    elif kind == "int32":
        src = rng.integers(-50, 50, n).astype(np.int32)
    elif kind == "bf16":
        src = _specials(rng, n).astype(jnp.bfloat16)
    elif kind == "duplicates":
        src = np.zeros(n, np.float32)
        src[7] = -1.0
    elif kind == "sentinels":
        src = np.where(rng.random(n) < 0.3, np.iinfo(np.int32).max,
                       rng.integers(-9, 9, n)).astype(np.int32)
    elif kind == "sorted":
        src = np.arange(n, dtype=np.float32)
    else:
        src = np.arange(n, 0, -1).astype(np.float32)
    if kind == "bf16":
        j = dr_tpu.distributed_vector(n, dtype=jnp.bfloat16)
        j.assign_array(src)
        t = dt.distributed_vector(n, dtype="bfloat16")
        t.assign_array(torch.from_numpy(src.astype(np.float32))
                       .to(torch.bfloat16))
    else:
        j, t = _pair(src)
    for desc in (False, True):
        _both(lambda m, v: m.sort(v, descending=desc), j, t)
    ref = np.sort(_host(src))[::-1]
    np.testing.assert_array_equal(dt.to_numpy(t), ref)  # NaN == NaN


def test_sort_is_bit_exact_permutation():
    _init_both(3)
    src = np.array([0.0, 3.0, -0.0, -1.0, 0.0, -0.0], dtype=np.float32)
    j, t = _pair(src)
    _both(lambda m, v: m.sort(v), j, t)
    assert list(np.signbit(dt.to_numpy(t))) == [True, True, True, False,
                                                False, False]


@pytest.mark.parametrize("P", [3, 4, 8])
def test_sort_uneven_and_team_distributions(P):
    _init_both(P)
    rng = np.random.default_rng(P)
    for sizes in ([7] + [3] * (P - 1), [5, 0] + [4] * (P - 2)):
        n = sum(sizes)
        src = rng.integers(0, 50, n).astype(np.int32)
        j = dr_tpu.distributed_vector(
            n, np.int32, distribution=dr_tpu.block_distribution(sizes))
        j.assign_array(src)
        t = dt.distributed_vector(
            n, np.int32, distribution=dt.block_distribution(sizes))
        t.assign_array(src)
        assert dt.is_sorted(t) == dr_tpu.is_sorted(j)
        for desc in (False, True):
            _both(lambda m, v: m.sort(v, descending=desc), j, t)
        assert not dt.is_sorted(t)
        _both(lambda m, v: m.sort(v), j, t)
        assert dt.is_sorted(t)


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_windows(P, descending):
    """Windows over uniform and team distributions, and over
    ghost-bearing rows: only the window's cells change.  Over a team
    distribution dr_tpu turns a -0.0 in the window into +0.0 (ROADMAP.md
    section 3), so there the zeros are held to numpy's bits instead."""
    _init_both(P)
    sizes = [5, 0] + [4] * (P - 2) if P >= 3 else None
    n = sum(sizes) if sizes else 37
    src = _specials(np.random.default_rng(n), n)
    b, e = 2, n - 3
    ref = src.copy()
    x = src[b:e]
    w = x[np.lexsort((~np.signbit(x), x))]  # -0.0 before +0.0
    ref[b:e] = w[::-1] if descending else w
    if sizes:
        t = dt.distributed_vector.from_array(src, distribution=sizes)
        dt.sort(t[b:e], descending=descending)
        assert_bits(dt.to_numpy(t)[~np.isnan(ref)], ref[~np.isnan(ref)])
        src[src == 0] = 0.5
    j, t = _pair(src, distribution=sizes) if sizes else _pair(src)
    _both(lambda m, v: m.sort(v[b:e], descending=descending), j, t)
    np.testing.assert_array_equal(dt.to_numpy(t)[b:e], np.sort(
        src[b:e])[::-1] if descending else np.sort(src[b:e]))
    if sizes is None:  # ghost-bearing rows
        jh = dr_tpu.distributed_vector.from_array(
            src, halo=dr_tpu.halo_bounds(2, 2))
        th = dt.distributed_vector.from_array(src, halo=dt.halo_bounds(2, 2))
        _both(lambda m, v: m.sort(v[1:n - 1], descending=descending), jh, th)


def test_sort_window_signed_zero_bit_exact():
    _init_both(4)
    src = np.array([1.0, -0.0, 0.0, -1.0, -0.0, 2.0], dtype=np.float32)
    j, t = _pair(src)
    _both(lambda m, v: m.sort(v[1:5]), j, t)
    assert list(np.signbit(dt.to_numpy(t))) == [False, True, True, True,
                                                False, False]


def test_sort_rejects_transform_views():
    dt.init(["cpu"] * 2)
    v = dt.distributed_vector.from_array(np.arange(8, dtype=np.float32))
    with pytest.raises(TypeError):
        dt.sort(dt.views.transform(v, lambda x: x * 2))


def test_sort_f64_keys_against_numpy():
    """Real float64 keys take the 64-bit encoding (the JAX package needs
    x64 for it, which this process does not enable): pairs closer than
    an f32 ulp keep their order, NaNs go last, -0.0 before +0.0."""
    dt.init(["cpu"] * 4)
    rng = np.random.default_rng(5)
    n = 97
    src = rng.standard_normal(n) + rng.uniform(-2 ** -40, 2 ** -40, n)
    src[[3, 50]] = np.nan
    src[[10, 60]] = [-0.0, 0.0]
    v = dt.distributed_vector.from_array(src)
    dt.sort(v)
    got = dt.to_numpy(v)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.sort(src))
    zeros = got[got == 0]
    assert np.signbit(zeros[0]) and not np.signbit(zeros[1])
    assert dt.is_sorted(v)
    w = dt.distributed_vector.from_array(np.array([1.0, 1.0 - 2 ** -53]))
    assert not dt.is_sorted(w)
    k = rng.standard_normal(n)
    k[13] = k[31]
    pay = np.arange(n, dtype=np.float64)
    kd = dt.distributed_vector.from_array(k)
    pd = dt.distributed_vector.from_array(pay)
    dt.sort_by_key(kd, pd, descending=True)
    order = np.argsort(k, kind="stable")[::-1]
    np.testing.assert_array_equal(dt.to_numpy(kd), k[order])
    np.testing.assert_array_equal(dt.to_numpy(pd), pay[order])


# ------------------------------------------------------------- key-value

def _kv_both(jk, jv, tk, tv, **kw):
    dr_tpu.sort_by_key(jk, jv, **kw)
    dt.sort_by_key(tk, tv, **kw)
    for j, t in ((jk, tk), (jv, tv)):
        base = j
        while not hasattr(base, "_data"):
            base = base.base
        tbase = t
        while not hasattr(tbase, "_rows"):
            tbase = tbase.base
        assert_bits(dt.to_numpy(tbase), dr_tpu.to_numpy(base))


@pytest.mark.parametrize("descending", [False, True])
def test_sort_by_key_rank_sweep(mesh_size, descending):
    """Random keys, heavy ties (stability), keys at int32 max, and
    -0.0/+0.0 ties (one key: original order; both decode to +0.0)."""
    P = mesh_size
    dt.init(["cpu"] * P)
    rng = np.random.default_rng(P + 50)
    n = 6 * P + 5
    zeros = np.where(rng.random(n) < 0.5, 0.0, -0.0).astype(np.float32)
    zeros[::3] = 1.0
    for keys in (rng.standard_normal(n).astype(np.float32),
                 rng.integers(0, 4, n).astype(np.int32),
                 np.where(rng.random(n) < 0.4, np.iinfo(np.int32).max,
                          rng.integers(0, 3, n)).astype(np.int32), zeros):
        pay = rng.standard_normal(n).astype(np.float32)
        (jk, tk), (jv, tv) = _pair(keys), _pair(pay)
        _kv_both(jk, jv, tk, tv, descending=descending)
        order = np.argsort(keys, kind="stable")
        if descending:
            order = order[::-1]
        np.testing.assert_array_equal(dt.to_numpy(tv), pay[order])


def test_sort_by_key_mixed_halo_and_distributions():
    _init_both(8)
    rng = np.random.default_rng(13)
    n = 200
    k = rng.standard_normal(n).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    (jk, tk) = _pair(k)
    jv = dr_tpu.distributed_vector.from_array(v,
                                              halo=dr_tpu.halo_bounds(2, 2))
    tv = dt.distributed_vector.from_array(v, halo=dt.halo_bounds(2, 2))
    _kv_both(jk, jv, tk, tv)
    ksz = [5, 0] + [4] * 6
    n = sum(ksz)
    k = rng.integers(0, 5, n).astype(np.float32)
    pay = np.arange(n, dtype=np.float32)
    vs = list(dt.even_sizes(n, 8))
    jk, tk = _pair(k, distribution=ksz)
    jv, tv = _pair(pay, distribution=vs)
    _kv_both(jk, jv, tk, tv, descending=True)


@pytest.mark.parametrize("P", [3, 8])
def test_sort_by_key_windows(P):
    """Key and payload windows at different offsets over different
    distributions; then windows of ONE container, disjoint and
    overlapping (the payload is written last and wins)."""
    _init_both(P)
    ksz = [5, 0] + [4] * (P - 2)
    n = sum(ksz)
    rng = np.random.default_rng(n + 1)
    k = rng.integers(0, 4, n).astype(np.float32)
    pay = np.arange(n, dtype=np.float32)
    jk, tk = _pair(k, distribution=ksz)
    jv, tv = _pair(pay, distribution=list(dt.even_sizes(n, P)))
    kb, ke, vb = 2, n - 3, 1
    _kv_both(jk[kb:ke], jv[vb:vb + ke - kb], tk[kb:ke], tv[vb:vb + ke - kb])
    src = rng.standard_normal(20).astype(np.float32)
    for (a, b), (c, d), desc in (((0, 8), (10, 18), False),
                                 ((11, 18), (2, 9), True),
                                 ((0, 8), (5, 13), False),
                                 ((9, 17), (4, 12), True)):
        jx, tx = _pair(src)
        _kv_both(jx[a:b], jx[c:d], tx[a:b], tx[c:d], descending=desc)


def test_sort_by_key_degenerate_calls():
    _init_both(4)
    src = np.random.default_rng(6).standard_normal(33).astype(np.float32)
    jx, tx = _pair(src)
    _kv_both(jx, jx, tx, tx)  # keys are the values: a plain sort
    jy, ty = _pair(src)
    _kv_both(jy[3:17], jy[3:17], ty[3:17], ty[3:17])
    jz, tz = _pair(src)
    _kv_both(jz[3:3], jz[5:5], tz[3:3], tz[5:5])  # empty windows
    np.testing.assert_array_equal(dt.to_numpy(tz), src)
    with pytest.raises(ValueError):
        dt.sort_by_key(dt.distributed_vector.from_array(src[:4]),
                       dt.distributed_vector.from_array(src[:5]))


def test_sort_by_key_payload_moves_as_bits():
    """A -0.0 or NaN payload arrives bit for bit (dr_tpu's masked-sum
    assembly turns -0.0 into +0.0 on more than one shard)."""
    dt.init(["cpu"] * 4)
    k = np.array([3.0, 1.0, 2.0, 0.0, 5.0, 4.0], np.float32)
    pay = np.array([-0.0, 1.0, np.nan, -0.0, 0.0, -2.0], np.float32)
    kd = dt.distributed_vector.from_array(k)
    pd = dt.distributed_vector.from_array(pay)
    dt.sort_by_key(kd, pd)
    order = np.argsort(k, kind="stable")
    assert_bits(dt.to_numpy(pd), pay[order])


def test_sort_by_key_on_two_rank_lists():
    """Keys on 8 ranks, payload on 4: the payload is copied onto the
    keys' ranks, sorted there and copied back."""
    dt.init(["cpu"] * 8)
    rt_small = dt.parallel.runtime.Runtime([torch.device("cpu")] * 4)
    rng = np.random.default_rng(7)
    n = 101
    k = rng.standard_normal(n).astype(np.float32)
    pay = np.arange(n, dtype=np.int32)
    kd = dt.distributed_vector.from_array(k)
    vd = dt.distributed_vector.from_array(pay, runtime=rt_small)
    dt.sort_by_key(kd, vd)
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(dt.to_numpy(kd), k[order])
    np.testing.assert_array_equal(dt.to_numpy(vd), pay[order])
    kd2 = dt.distributed_vector.from_array(k)
    vd2 = dt.distributed_vector.from_array(pay, runtime=rt_small)
    dt.sort_by_key(kd2[5:60], vd2[10:65], descending=True)
    kref, pref = k.copy(), pay.copy()
    o = np.argsort(k[5:60], kind="stable")[::-1]
    kref[5:60] = k[5:60][o]
    pref[10:65] = pay[10:65][o]
    np.testing.assert_array_equal(dt.to_numpy(kd2), kref)
    np.testing.assert_array_equal(dt.to_numpy(vd2), pref)


# ------------------------------------------------- argsort and is_sorted

@pytest.mark.parametrize("P", [1, 4])
def test_argsort(P):
    _init_both(P)
    src = np.random.default_rng(21).integers(0, 9, 300).astype(np.float32)
    j, t = _pair(src)
    for desc in (False, True):
        got = dt.argsort(t, descending=desc)
        assert got.dtype == torch.int32
        assert_bits(dt.to_numpy(got),
                    dr_tpu.to_numpy(dr_tpu.argsort(j, descending=desc)))
    np.testing.assert_array_equal(dt.to_numpy(t), src)  # read only
    got = dt.argsort(dt.views.transform(t, lambda x: -x))
    ref = dr_tpu.argsort(dr_tpu.views.transform(j, lambda x: -x))
    assert_bits(dt.to_numpy(got), dr_tpu.to_numpy(ref))


def test_is_sorted_cases(mesh_size):
    P = mesh_size
    dt.init(["cpu"] * P)
    n = 5 * P + 2
    src = np.arange(n, dtype=np.float32)
    bad = src.copy()
    bad[0] = 1e9
    seg = 6
    cross = np.concatenate([(P - r) * 1000.0 + np.arange(seg)
                            for r in range(P)]).astype(np.float32)
    cases = [src, bad, cross, np.zeros(n, np.float32),
             np.sort(np.r_[src[:n - 1], [np.nan]]).astype(np.float32),
             np.r_[[np.nan], src[:n - 1]].astype(np.float32),
             np.array([0.0, -0.0, 1.0], np.float32)]
    for c in cases:
        j, t = _pair(c)
        assert dt.is_sorted(t) == dr_tpu.is_sorted(j), c
    v = np.array([9, 1, 2, 3, 0], dtype=np.float32)
    j, t = _pair(v)
    for a, b in ((0, 5), (1, 4), (0, 3), (2, 5), (3, 3)):
        assert dt.is_sorted(t[a:b]) == dr_tpu.is_sorted(j[a:b]), (a, b)


@pytest.mark.parametrize("P", [3, 8])
def test_is_sorted_uneven_boundary_and_windows(P):
    _init_both(P)
    sizes = [4, 0] + [4] * (P - 2)
    n = sum(sizes)
    src = np.concatenate([1000.0 + np.arange(4),
                          np.arange(n - 4, dtype=np.float64)]) \
        .astype(np.float32)
    j, t = _pair(src, distribution=sizes)
    assert dt.is_sorted(t) == dr_tpu.is_sorted(j) is False
    w = np.arange(n, dtype=np.float32)
    w[0] = 99.0
    j, t = _pair(w, distribution=sizes)
    for a, b in ((0, n), (1, n), (0, 4), (3, 9)):
        assert dt.is_sorted(t[a:b]) == dr_tpu.is_sorted(j[a:b]), (a, b)


def _shift(x, mu):
    return x + mu


def test_is_sorted_view_chains(mesh_size):
    """Transform chains (and bound scalars) over containers and windows,
    with a violation only at a rank boundary."""
    P = mesh_size
    dt.init(["cpu"] * P)
    src = np.arange(40, dtype=np.float32)
    j, t = _pair(src)
    jv, tv = dr_tpu.views, dt.views
    for fj, ft in ((jv.transform(j, lambda x: x * 2.0),
                    tv.transform(t, lambda x: x * 2.0)),
                   (jv.transform(j, lambda x: -x),
                    tv.transform(t, lambda x: -x)),
                   (jv.transform(j[5:30], lambda x: x + 3.0),
                    tv.transform(t[5:30], lambda x: x + 3.0)),
                   (jv.transform(j[5:30], lambda x: -x),
                    tv.transform(t[5:30], lambda x: -x)),
                   (jv.transform(j, _shift, -1.5),
                    tv.transform(t, _shift, -1.5))):
        assert dt.is_sorted(ft) == dr_tpu.is_sorted(fj)
    if P >= 2:
        w = np.arange(32, dtype=np.float32)
        w[-(-32 // P)] = -50.0
        j, t = _pair(w)
        assert dt.is_sorted(tv.transform(t, lambda x: x * 2.0)) == \
            dr_tpu.is_sorted(jv.transform(j, lambda x: x * 2.0)) is False


# ------------------------------------------- sort_n and the phase ladder

def test_sort_n_fused_loops():
    _init_both(8)
    n = 200
    src = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    from dr_tpu.algorithms.sort import sort_by_key_n, sort_n
    _both(lambda m, v: (sort_n if m is dr_tpu else dt.sort_n)(v, 3),
          *_pair(src))
    k = np.random.default_rng(10).standard_normal(n).astype(np.float32)
    (jk, tk), (jp, tp) = _pair(k), _pair(np.arange(n, dtype=np.int32))
    sort_by_key_n(jk, jp, 2)
    dt.sort_by_key_n(tk, tp, 2)
    assert_bits(dt.to_numpy(tp), dr_tpu.to_numpy(jp))
    np.testing.assert_array_equal(dt.to_numpy(tp),
                                  np.argsort(k, kind="stable"))


@pytest.mark.parametrize("P", [1, 8])
def test_phase_truncations(P):
    """Every truncation keeps the containers' shapes and dtypes; the
    last phase is the full sort; key-value truncations before
    "payload" leave the payload bit-untouched."""
    dt.init(["cpu"] * P)
    rng = np.random.default_rng(5)
    n = 96
    src = rng.standard_normal(n).astype(np.float32)
    pay = rng.standard_normal(n).astype(np.float32)
    for phase in t_sort.SORT_PHASES:
        v = dt.distributed_vector.from_array(src)
        t_sort.sort_phases_n(v, phase, 2)
        got = dt.to_numpy(v)
        assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.sort(src))
    for phase in t_sort.SORTKV_PHASES:
        kd = dt.distributed_vector.from_array(src)
        vd = dt.distributed_vector.from_array(pay)
        t_sort.sort_by_key_phases_n(kd, vd, phase, 2)
        if phase != "payload":
            assert_bits(dt.to_numpy(vd), pay)
    order = np.argsort(src, kind="stable")
    np.testing.assert_array_equal(dt.to_numpy(kd), src[order])
    np.testing.assert_array_equal(dt.to_numpy(vd), pay[order])
    assert (t_sort.SORT_PHASES, t_sort.SORTKV_PHASES) == \
        (J_SORT_PHASES, J_SORTKV_PHASES)
