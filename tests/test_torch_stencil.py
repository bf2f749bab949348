"""dr_tpu_torch stencils and the plain versions of K1 and K2 against
dr_tpu on the CPU.

K1's Pallas apply runs in interpret mode (``impl="pallas_interpret"``)
and its XLA P-form (``impl="xla"``), as ``tests/test_stencil_matmul.py``
runs them; K2's Pallas kernel runs with ``interpret=True``, as
``tests/test_stencil_blocked.py`` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.algorithms.stencil import (stencil_iterate_blocked as j_blocked,
                                       stencil_iterate_matmul as j_matmul)
from dr_tpu.ops import stencil_matmul as j_sm
from dr_tpu.ops import stencil_pallas as j_sp
from dr_tpu_torch.ops import stencil_matmul as t_sm
from dr_tpu_torch.ops import stencil_pallas as t_sp

W5 = [0.05, 0.25, 0.4, 0.25, 0.05]
W3A = [0.1, 0.2, 0.7]  # asymmetric: catches a flipped band or ring


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)


def _vectors(src, hb):
    j = dr_tpu.distributed_vector.from_array(src,
                                             halo=dr_tpu.halo_bounds(*hb))
    t = dt.distributed_vector.from_array(src, halo=dt.halo_bounds(*hb))
    return j, t


# K1: the composed operator's f32 apply.  The Pallas kernel emulates
# HIGH precision with bf16x3 passes (~5e-6 scaled error) and the P-form
# runs XLA's f32 dot; the port's plain version is an f32 matmul of the
# same float64-composed band — tolerances as in test_stencil_matmul.py
K1_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("seg,halo,k,w", [(512, 128, 16, W5),
                                          (512, 256, 128, W5),
                                          (1024, 512, 256, W5),
                                          (384, 128, 20, W3A)])
def test_k1_plain_matches_pallas_interpret_and_xla(seg, halo, k, w):
    rng = np.random.default_rng(seg + k)
    row = rng.standard_normal((1, 2 * halo + seg)).astype(np.float32)
    got = t_sm.matmul_stencil_row(torch.from_numpy(row), seg, halo, w, k)
    assert torch.equal(got, t_sm.plain_apply(torch.from_numpy(row), seg,
                                             halo, tuple(w), k))
    got = got.numpy()
    xla = np.asarray(j_sm.matmul_stencil_row(jnp.asarray(row), seg, halo,
                                             w, k, impl="xla"))
    pal = np.asarray(j_sm.matmul_stencil_row(jnp.asarray(row), seg, halo,
                                             w, k, impl="pallas_interpret"))
    np.testing.assert_allclose(got, xla, **K1_TOL)
    np.testing.assert_allclose(got, pal, **K1_TOL)
    # ghost columns pass through untouched
    np.testing.assert_array_equal(got[:, :halo], row[:, :halo])
    np.testing.assert_array_equal(got[:, halo + seg:], row[:, halo + seg:])


def test_k1_helpers_match_reference():
    np.testing.assert_array_equal(t_sm.composed_taps(W5, 7),
                                  j_sm.composed_taps(W5, 7))
    for r in (1, 2, 3):
        assert t_sm.max_ksteps(r) == j_sm.max_ksteps(r)
        assert t_sm.band_cols(40, r) == j_sm.band_cols(40, r)


# K2: both sides step in f32 with the products and sums in the same
# order; 1e-6 absolute allows for a fused multiply-add in XLA's CPU code
K2_TOL = dict(rtol=0, atol=1e-6)


@pytest.mark.parametrize("seg,halo,T,w", [(2048, 1024, 4, W5),
                                          (1024, 1024, 7, W3A)])
def test_k2_plain_matches_pallas_interpret(seg, halo, T, w):
    rng = np.random.default_rng(T)
    row = rng.standard_normal((1, 2 * halo + seg)).astype(np.float32)
    got = t_sp.blocked_stencil_row(torch.from_numpy(row), seg, halo, w, T)
    ref = np.asarray(j_sp.blocked_stencil_row(jnp.asarray(row), seg, halo,
                                              w, T, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, **K2_TOL)
    np.testing.assert_array_equal(got.numpy()[:, :halo], row[:, :halo])


# stepwise stencils: one f32 weighted sum per step on both sides; 30
# steps of f32 rounding at O(1) values stay far inside 1e-5
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("periodic", [False, True])
def test_stencil_transform_and_iterate(mesh_size, periodic):
    _init_both(mesh_size)
    n = 16 * mesh_size + 3 if not periodic else 16 * mesh_size
    src = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    ja, ta = _vectors(src, (2, 2, periodic))
    jo, to = _vectors(np.zeros(n, np.float32), (2, 2, periodic))
    dr_tpu.stencil_transform(ja, jo, W5)
    dt.stencil_transform(ta, to, W5)
    np.testing.assert_allclose(dt.to_numpy(to), dr_tpu.to_numpy(jo),
                               **STEP_TOL)

    def op(a, b, c):
        return 0.5 * b + 0.25 * (a + c)
    dr_tpu.stencil_transform(ja, jo, op, radius=1)
    dt.stencil_transform(ta, to, op, radius=1)
    np.testing.assert_allclose(dt.to_numpy(to), dr_tpu.to_numpy(jo),
                               **STEP_TOL)
    jb, tb = _vectors(src, (2, 2, periodic))
    jr = dr_tpu.stencil_iterate(ja, jb, W5, steps=7)
    tr = dt.stencil_iterate(ta, tb, W5, steps=7)
    np.testing.assert_allclose(dt.to_numpy(tr), dr_tpu.to_numpy(jr),
                               **STEP_TOL)


def test_stencil_iterate_matmul_matches_reference(mesh_size):
    """K1's path: dr_tpu's XLA P-form vs the port (plain K1 on the CPU),
    full blocks plus a remainder block."""
    _init_both(mesh_size)
    n = mesh_size * 1024
    src = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    for w, k, steps, halo in ((W5, 8, 20, 128), (W3A, 4, 6, 128),
                              (W5, 256, 256, 512)):
        j, t = _vectors(src, (halo, halo, True))
        j_matmul(j, w, steps, k_block=k)
        dt.stencil_iterate_matmul(t, w, steps, k_block=k)
        np.testing.assert_allclose(dt.to_numpy(t), dr_tpu.to_numpy(j),
                                   **K1_TOL)


def test_stencil_iterate_blocked_matches_reference():
    """K2's path on 8 ranks: dr_tpu's interpret-mode kernel vs the port."""
    _init_both(8)
    n = 8 * 1024
    src = np.random.default_rng(6).standard_normal(n).astype(np.float32)
    j, t = _vectors(src, (1024, 1024, True))
    j_blocked(j, W5, 10, time_block=4)
    dt.stencil_iterate_blocked(t, W5, 10, time_block=4)
    np.testing.assert_allclose(dt.to_numpy(t), dr_tpu.to_numpy(j), **K2_TOL)


@pytest.mark.parametrize("case", [
    # (n, halo, periodic, kind, block): every one is refused by both
    (1024 * 2, 128, False, "matmul", 8),      # not the periodic ring
    (1024 * 2, 128, True, "matmul", 128),     # halo < k * r
    (1000, 128, True, "matmul", 8),           # unequal shards
    (1024 * 2, 1024, True, "matmul", 1024),   # k beyond the band reach
    (200 * 2, 128, True, "matmul", 8),        # seg not 128-aligned
    (1024 * 2, 1024, True, "blocked", 1024),  # halo < T * r
    (1024 * 2, 1024, False, "blocked", 4),    # not the periodic ring
])
def test_blocked_paths_refuse_like_reference(case):
    _init_both(2)
    n, halo, periodic, kind, block = case
    src = np.ones(n, np.float32)
    j, t = _vectors(src, (halo, halo, periodic))
    for fn, v in ((j_matmul if kind == "matmul" else j_blocked, j),
                  (dt.stencil_iterate_matmul if kind == "matmul"
                   else dt.stencil_iterate_blocked, t)):
        kw = {"k_block" if kind == "matmul" else "time_block": block}
        with pytest.raises(AssertionError):
            fn(v, W5, 4, **kw)
