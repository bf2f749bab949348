"""dr_tpu_torch's ``unstructured_halo`` against dr_tpu and numpy on the
CPU.

``exchange()`` is data movement: bit for bit with both.  ``reduce(op)``
folds duplicate indices in entry order, so it is bit for bit with
numpy's ``ufunc.at`` (``plus``, ``multiplies``, ``max``, ``min``) and
fancy assignment (``second``), and gives the same bits on every call.
The JAX package's XLA scatter leaves the order of duplicates
unspecified: against it, ``plus`` and ``multiplies`` hold within the
tolerance of a reordered f32 fold, ``max`` and ``min`` bit for bit, and
``second`` bit for bit on the cells no other entry writes."""

import jax
import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.parallel.unstructured_halo import unstructured_halo as JHalo

OPS = ["plus", "multiplies", "max", "min", "second"]


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)


def _numpy_reduce(owner, flat, ghosts, op):
    ref = owner.copy()
    if op == "plus":
        np.add.at(ref, flat, ghosts)
    elif op == "multiplies":
        np.multiply.at(ref, flat, ghosts)
    elif op == "max":
        np.maximum.at(ref, flat, ghosts)
    elif op == "min":
        np.minimum.at(ref, flat, ghosts)
    else:
        ref[flat] = ghosts
    return ref


def _ghost_map(P, n, seed, per=12):
    """Each rank mirrors ``per`` indices: half from its neighbours'
    blocks, half uniform, duplicates (and negative spellings) included."""
    rng = np.random.default_rng(seed)
    seg = -(-n // P)
    out = {}
    for r in range(P):
        nb = rng.choice([(r - 1) % P, (r + 1) % P], per // 2)
        near = np.minimum(nb * seg + rng.integers(0, seg, per // 2), n - 1)
        ix = np.concatenate([near, rng.integers(0, n, per - per // 2)])
        ix[::5] -= n  # numpy's negative indices
        out[r] = ix
    return out


def test_reference_cases():
    """The JAX package's own oracle cases (test_collectives.py:65,76)."""
    _init_both(8)
    v = dt.distributed_vector.from_array(np.arange(32, dtype=np.float32))
    uh = dt.unstructured_halo(v, {1: [0, 5], 2: [31]})
    uh.exchange()
    np.testing.assert_array_equal(uh.ghost_values(1).numpy(), [0., 5.])
    np.testing.assert_array_equal(uh.ghost_values(2).numpy(), [31.])
    assert uh.ghost_values(3).numel() == 0
    v = dt.distributed_vector.from_array(np.zeros(16, np.float32))
    uh = dt.unstructured_halo(v, {0: [3, 7], 1: [7]})
    uh.set_ghost_values(0, np.array([1.0, 2.0]))
    uh.set_ghost_values(1, np.array([10.0]))
    uh.reduce("plus")
    got = dt.to_numpy(v)
    assert got[3] == 1.0 and got[7] == 12.0
    uh2 = dt.unstructured_halo(v, {0: [3]})
    uh2.set_ghost_values(0, np.array([100.0]))
    uh2.reduce("max")
    assert dt.to_numpy(v)[3] == 100.0


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_exchange_bit_exact(mesh_size, dtype):
    _init_both(mesh_size)
    n = 61
    src = (np.random.default_rng(1).standard_normal(n) * 50).astype(dtype)
    gmap = _ghost_map(mesh_size, n, seed=mesh_size)
    jv = dr_tpu.distributed_vector.from_array(src)
    tv = dt.distributed_vector.from_array(src)
    ju, tu = JHalo(jv, gmap), dt.unstructured_halo(tv, gmap)
    ju.exchange()
    tu.exchange_begin()
    tu.exchange_finalize()
    for r in range(mesh_size):
        got = tu.ghost_values(r)
        assert got.device == tv.runtime.devices[r] and got.dtype == tv.dtype
        np.testing.assert_array_equal(got.numpy(), src[gmap[r]])
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ju.ghost_values(r)))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_reduce_matches_numpy_and_reference(mesh_size, op, dtype):
    _init_both(mesh_size)
    n = 61
    rng = np.random.default_rng(len(op) + mesh_size)
    scale = 3 if dtype == np.int32 else 1
    src = (rng.standard_normal(n) * scale).astype(dtype)
    gmap = _ghost_map(mesh_size, n, seed=7 * mesh_size)
    contrib = {r: (rng.standard_normal(len(ix)) * scale).astype(dtype)
               for r, ix in gmap.items()}
    flat = np.concatenate([gmap[r] for r in range(mesh_size)])
    ghosts = np.concatenate([contrib[r] for r in range(mesh_size)])
    want = _numpy_reduce(src, flat, ghosts, op)
    jv = dr_tpu.distributed_vector.from_array(src)
    ju = JHalo(jv, gmap)
    outs = []
    for _ in range(2):  # the same bits on a second call
        tv = dt.distributed_vector.from_array(src)
        tu = dt.unstructured_halo(tv, gmap)
        for r, vals in contrib.items():
            tu.set_ghost_values(r, vals)
        tu.reduce_begin(op)
        tu.reduce_finalize()
        outs.append(dt.to_numpy(tv))
        np.testing.assert_array_equal(outs[-1], want)
    np.testing.assert_array_equal(outs[0].view(np.int32),
                                  outs[1].view(np.int32))
    for r, vals in contrib.items():
        ju.set_ghost_values(r, vals)
    ju.reduce(op)
    ref = dr_tpu.to_numpy(jv)
    if op in ("plus", "multiplies") and dtype == np.float32:
        # f32 folds of the same few contributions in another order
        np.testing.assert_allclose(outs[0], ref, rtol=1e-5, atol=1e-5)
    elif op == "second":
        idx = np.where(flat < 0, flat + n, flat)
        once = np.bincount(idx, minlength=n) <= 1
        np.testing.assert_array_equal(outs[0][once], ref[once])
    else:
        np.testing.assert_array_equal(outs[0], ref)


def test_reduce_after_exchange_and_rows_untouched_elsewhere():
    """exchange then reduce("plus") doubles every mirrored cell once a
    mirror; halo and pad cells of the rows stay as they were."""
    _init_both(4)
    n = 30
    src = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    hb = dt.halo_bounds(1, 1, periodic=True)
    tv = dt.distributed_vector.from_array(src, halo=hb)
    dt.halo(tv).exchange()
    before = [r.clone() for r in tv.rows]
    gmap = {0: [29, 29, 3], 2: [3], 3: [0]}
    uh = dt.unstructured_halo(tv, gmap)
    uh.exchange()
    uh.reduce("plus")
    want = src.copy()
    np.add.at(want, [29, 29, 3, 3, 0], src[[29, 29, 3, 3, 0]])
    np.testing.assert_array_equal(dt.to_numpy(tv), want)
    for b, a in zip(before, tv.rows):  # the ghost cells keep their values
        assert torch.equal(b[0, 0], a[0, 0]) and torch.equal(b[0, -1],
                                                             a[0, -1])


def test_validation_and_empty_maps():
    _init_both(4)
    v = dt.distributed_vector.from_array(np.arange(10, dtype=np.float32))
    with pytest.raises(IndexError):
        dt.unstructured_halo(v, {0: [10]})
    with pytest.raises(IndexError):
        dt.unstructured_halo(v, {1: [-11]})
    empty = dt.unstructured_halo(v, {0: [], 1: []})
    empty.exchange()
    empty.reduce("plus")
    assert empty.ghost_values(0).numel() == 0
    np.testing.assert_array_equal(dt.to_numpy(v), np.arange(10))
    uh = dt.unstructured_halo(v, {2: [1, 9]})
    with pytest.raises(ValueError):
        uh.reduce("xor")
    with pytest.raises(ValueError):
        uh.set_ghost_values(2, [1.0])
    with pytest.raises(KeyError):
        uh.set_ghost_values(0, [1.0])
