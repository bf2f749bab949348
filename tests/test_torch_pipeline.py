"""dr_tpu_torch's ring schedules (``parallel/pipeline.py``) against
dr_tpu's, on the CPU: the port's eager rank-list loops against the JAX
functions inside small ``shard_map`` bodies built here, with the same
numpy-seeded inputs on 8 ranks.

Every comparison is bit for bit: the bodies move data and do float
arithmetic that rounds once per operation (``acc * 0.5 + x``, where the
product is exact, and ``x * (t + 1)``), and ``ring_combine`` sums in the
canonical rank order in both packages.  ``serial`` and ``pipelined``
must give the same bits, as in ``tests/test_pipeline.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as PS

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.parallel import pipeline as jpl
from dr_tpu_torch.parallel import pipeline as tpl

SCHEDULES = ("serial", "pipelined")


@pytest.fixture
def ranks():
    """The reference's 8-device mesh (conftest) and 8 CPU ranks."""
    rt = dr_tpu.parallel.runtime.runtime()
    dt.init(["cpu"] * rt.nprocs)
    yield rt
    dt.final()


def _data(P, n=37, seed=0):
    """Per-rank f32 rows of mixed magnitudes and int32 pairs."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((P, n))
         * 10.0 ** rng.integers(-3, 4, (P, n))).astype(np.float32)
    y = rng.integers(-1000, 1000, (P, 2)).astype(np.int32)
    return x, y


def _shard_map(rt, body, nin):
    return jax.jit(jax.shard_map(body, mesh=rt.mesh,
                                 in_specs=(PS(rt.axis),) * nin,
                                 out_specs=PS(rt.axis)))


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _rows(ts):
    return np.stack([t.numpy() for t in ts])


# --------------------------------------------------------- ring_pipeline

def _jax_pipeline(rt, X, Y, sched, restore, perm):
    P = rt.nprocs

    def body(x, y):
        x, y = x[0], y[0]
        my = lax.axis_index(rt.axis)
        carry = (jnp.zeros((P,) + x.shape, x.dtype), jnp.zeros_like(x),
                 jnp.zeros((P,) + y.shape, y.dtype))

        def compute(t, carry, blocks):
            hist, acc, ih = carry
            bx, by = blocks
            return (hist.at[t].set(bx), acc * 0.5 + bx,
                    ih.at[t].set(by + my))

        res = jpl.ring_pipeline(rt.axis, P, carry, (x, y), compute,
                                perm=perm, schedule=sched,
                                restore_blocks=restore)
        (hist, acc, ih), blocks = res if restore else (res, (x, y))
        return (hist[None], acc[None], ih[None], blocks[0][None],
                blocks[1][None])

    return [np.asarray(o) for o in _shard_map(rt, body, 2)(X, Y)]


def _torch_pipeline(X, Y, sched, restore, perm):
    devs = dt.devices()
    P = len(devs)
    carry = [(torch.zeros((P, X.shape[1])), torch.zeros(X.shape[1]),
              torch.zeros((P, 2), dtype=torch.int32)) for _ in devs]
    blocks = [(torch.from_numpy(X[r]), torch.from_numpy(Y[r]))
              for r in range(P)]

    def compute(t, r, carry, blocks):
        hist, acc, ih = (c.clone() for c in carry)
        bx, by = blocks
        hist[t] = bx
        ih[t] = by + r
        return hist, acc * 0.5 + bx, ih

    res = tpl.ring_pipeline(devs, carry, blocks, compute, perm=perm,
                            schedule=sched, restore_blocks=restore)
    carry, blocks = res if restore else (res, blocks)
    return [_rows(c[i] for c in carry) for i in range(3)] + \
        [_rows(b[i] for b in blocks) for i in range(2)]


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("restore", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_ring_pipeline_matches_jax_bitwise(ranks, sched, restore, backward):
    """Which block every rank holds at every step, the carry folded in
    step order, and (restore_blocks) the blocks back at their origin."""
    P = ranks.nprocs
    perm = [(i, (i - 1) % P) for i in range(P)] if backward else None
    X, Y = _data(P, seed=1)
    got = _torch_pipeline(X, Y, sched, restore, perm)
    want = _jax_pipeline(ranks, X, Y, sched, restore, perm)
    for g, w in zip(got, want):
        _bits_equal(g, w)
    if restore:
        _bits_equal(got[3], X)
        _bits_equal(got[4], Y)


def test_ring_pipeline_schedules_bitwise(ranks):
    X, Y = _data(ranks.nprocs, seed=2)
    a = _torch_pipeline(X, Y, "serial", True, None)
    b = _torch_pipeline(X, Y, "pipelined", True, None)
    for g, w in zip(a, b):
        _bits_equal(g, w)


# --------------------------------------------------------- ring_exchange

def _jax_exchange(rt, X, sched, steps):
    P = rt.nprocs

    def body(x):
        x = x[0]
        carry = (jnp.zeros((P,) + x.shape, x.dtype), jnp.zeros_like(x))

        def consume(t, carry, bucket):
            hist, acc = carry
            return hist.at[t].set(bucket), acc * 0.5 + bucket

        hist, acc = jpl.ring_exchange(rt.axis, P, carry,
                                      lambda t: x * (t + 1), consume,
                                      steps=steps, schedule=sched)
        return hist[None], acc[None]

    return [np.asarray(o) for o in _shard_map(rt, body, 1)(X)]


def _torch_exchange(X, sched, steps):
    devs = dt.devices()
    P = len(devs)
    carry = [(torch.zeros((P, X.shape[1])), torch.zeros(X.shape[1]))
             for _ in devs]

    def consume(t, r, carry, bucket):
        hist, acc = carry
        hist = hist.clone()
        hist[t] = bucket
        return hist, acc * 0.5 + bucket

    carry = tpl.ring_exchange(
        devs, carry, lambda t, r: torch.from_numpy(X[r]) * (t + 1), consume,
        steps=steps, schedule=sched)
    return [_rows(c[i] for c in carry) for i in range(2)]


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("steps", [None, [1, 3, 6], [5], []])
def test_ring_exchange_matches_jax_bitwise(ranks, sched, steps):
    """Every hop distance (or the kept ones: dropped hops move nothing)
    delivers rank r-t's bucket to rank r, folded in hop order."""
    X, _ = _data(ranks.nprocs, seed=3)
    got = _torch_exchange(X, sched, steps)
    want = _jax_exchange(ranks, X, sched, steps)
    for g, w in zip(got, want):
        _bits_equal(g, w)
    if sched == "pipelined":
        for g, w in zip(got, _torch_exchange(X, "serial", steps)):
            _bits_equal(g, w)


# ------------------------------------------------ allgather and combine

@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("shape", [(37,), (3, 5)])
def test_ring_allgather_and_combine_match_jax_bitwise(ranks, sched, shape):
    """Slot s holds rank s's block on every rank; the combine sums ranks
    0..P-1 left to right, so every rank and both packages agree to the
    bit on data whose sum rounds."""
    rt = ranks
    P = rt.nprocs
    rng = np.random.default_rng(4)
    X = (rng.standard_normal((P,) + shape)
         * 10.0 ** rng.integers(-3, 4, (P,) + shape)).astype(np.float32)

    def body(x):
        x = x[0]
        return (jpl.ring_allgather(rt.axis, P, x, schedule=sched)[None],
                jpl.ring_combine(rt.axis, P, x, schedule=sched)[None])

    want_g, want_c = (np.asarray(o) for o in _shard_map(rt, body, 1)(X))
    devs = dt.devices()
    xs = [torch.from_numpy(X[r]) for r in range(P)]
    got_g = _rows(tpl.ring_allgather(devs, xs, schedule=sched))
    got_c = _rows(tpl.ring_combine(devs, xs, schedule=sched))
    _bits_equal(got_g, want_g)
    _bits_equal(got_c, want_c)
    for r in range(P):
        _bits_equal(got_g[r], X)
        _bits_equal(got_c[r], got_c[0])
    # a one-rank ring returns its input
    one = tpl.ring_combine(devs[:1], xs[:1], schedule=sched)
    assert one[0] is xs[0]


# ----------------------------------------------------- schedule choice

def test_perms_match_jax():
    for P in (1, 2, 5, 8):
        assert tpl.ring_perm(P) == jpl.ring_perm(P)
        for t in range(P):
            assert tpl.shift_perm(P, t) == jpl.shift_perm(P, t)


@pytest.mark.parametrize("raw", [None, "serial", " Serial ", "pipelined",
                                 "PIPELINED", "bogus", ""])
def test_schedule_mode_reads_env_like_jax(monkeypatch, raw):
    """DR_GPU_RING_SCHEDULE is read as DR_TPU_RING_SCHEDULE is: stripped,
    lowercased, a malformed value falls back to pipelined."""
    for var in ("DR_GPU_RING_SCHEDULE", "DR_TPU_RING_SCHEDULE"):
        if raw is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, raw)
    assert tpl.schedule_mode() == jpl.schedule_mode()


def test_unknown_schedule_argument_raises(ranks):
    xs = [torch.zeros(3) for _ in dt.devices()]
    with pytest.raises(ValueError):
        tpl.ring_allgather(dt.devices(), xs, schedule="bogus")
