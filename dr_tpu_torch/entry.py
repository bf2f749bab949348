"""The port's main-path entry points (counterpart of
``__graft_entry__.py``'s ``entry`` and ``dryrun_multichip``).

``entry(device=None)`` -> ``(fn, args)``: one rank, the flagship step
(one 5-point stencil step with a halo of 2, then the masked sum of the
owned cells) as a function of rank rows.

``dryrun(n_ranks, devices=None)``: the whole distributed pipeline, one
small step of each section, over ``n_ranks`` logical ranks, each section
held to a numpy oracle or a finite-ness check as the JAX drive holds it.

Both run on the card unless the caller names the CPU (``entry("cpu")``,
``dryrun(8, ["cpu"] * 8)``).  Ranks are a device list: several ranks
may share one device, so no subprocess or device-count flag is needed.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .parallel import collectives
from .parallel import runtime as _rt

__all__ = ["entry", "dryrun"]

ENTRY_N = 1 << 16
ENTRY_WEIGHTS = (0.05, 0.25, 0.4, 0.25, 0.05)


def entry(device=None):
    """The flagship step on one rank of ``device`` (default: the first
    CUDA device; raises without one).  Returns ``(fn, args)``:
    ``fn(a_rows, b_rows)`` makes one halo exchange and one 5-point step
    from ``a_rows`` into ``b_rows`` and returns ``(out_rows, total)``,
    ``total`` the sum of the owned cells as a device scalar."""
    import dr_tpu_torch as dt
    from .algorithms.stencil import _weights_op, build_stencil_step
    dev = device if device is not None else _rt.get_duplicated_devices(1)[0]
    rt = dt.init([dev])
    hb = dt.halo_bounds(2, 2)
    a = dt.distributed_vector(ENTRY_N, np.float32, halo=hb)
    dt.fill(a, 1.0)
    b = dt.distributed_vector(ENTRY_N, np.float32, halo=hb)
    layout = a.layout
    step = build_stencil_step(layout, False, _weights_op(ENTRY_WEIGHTS)[0],
                              2, 2, rt.devices)

    def fn(a_rows, b_rows):
        out = step(a_rows, b_rows)
        nshards, seg, prev, nxt, total = layout
        sums = []
        for r, row in enumerate(out):
            owned = min(seg, max(total - r * seg, 0))
            sums.append(row[0, prev:prev + owned].sum())
        return out, collectives.psum(sums, rt.devices[0])

    return fn, (a.rows, b.rows)


def _check(name, ok):
    if not ok:
        raise AssertionError(f"dryrun: {name} failed")


def dryrun(n_ranks: int, devices=None) -> None:
    """Every section of ``dryrun_multichip`` whose modules the port has,
    over ``n_ranks`` ranks of ``devices`` (default: the CUDA devices,
    repeated to ``n_ranks``).  Raises AssertionError on the first
    section that disagrees with its oracle.

    Left out until its module is ported (``tuning``): the env-forced
    streaming flash ring (the bf16 ring-attention call below takes the
    port's flash route instead)."""
    import dr_tpu_torch as dt
    devs = _rt.get_duplicated_devices(n_ranks, devices)
    dt.init(devs)
    P = n_ranks
    n = max(16 * P, 64)
    src = np.linspace(0.0, 1.0, n).astype(np.float32)

    # ring stencil (periodic: every rank talks to both neighbours)
    hb = dt.halo_bounds(1, 1, periodic=True)
    a = dt.distributed_vector.from_array(src, halo=hb)
    b = dt.distributed_vector.from_array(src, halo=hb)
    out = dt.stencil_iterate(a, b, [0.25, 0.5, 0.25], steps=2)
    _check("ring stencil", np.isfinite(dt.to_numpy(out)).all())

    # the composed-operator stencil (K1): halo 128 with k_block 8, and
    # the wide band, halo 256 with k_block 96
    nm = P * 1024
    msrc = np.linspace(0.0, 1.0, nm).astype(np.float32)
    for halo, steps, kb in ((128, 10, 8), (256, 96, 96)):
        mv = dt.distributed_vector.from_array(
            msrc, halo=dt.halo_bounds(halo, halo, periodic=True))
        mm = dt.stencil_iterate_matmul(mv, ENTRY_WEIGHTS, steps, k_block=kb)
        _check(f"stencil_iterate_matmul halo {halo}",
               np.isfinite(dt.to_numpy(mm)).all())

    # zip | transform | reduce (dot), and the port's fused dot_n (K3)
    x = dt.distributed_vector.from_array(src)
    y = dt.distributed_vector.from_array(2.0 - src)
    d = dt.dot(x, y)
    ref = float(src.astype(np.float64) @ (2.0 - src.astype(np.float64)))
    _check("dot", abs(d - ref) <= 1e-5 * abs(ref))
    _check("dot_n", abs(float(dt.dot_n(x, y, 1)) - ref) <= 1e-5 * abs(ref))

    # distributed prefix scan (K4 on f32 adds)
    s = dt.distributed_vector(n)
    dt.inclusive_scan(x, s)
    _check("inclusive_scan", np.allclose(dt.to_numpy(s), np.cumsum(src),
                                         rtol=1e-4, atol=1e-5))

    # halo exchange and the ghost -> owner fold
    dt.halo(a).exchange()
    dt.halo(a).reduce_plus()
    a.block_until_ready()

    # distributed sample sort, keys-only and key-value
    sv = dt.distributed_vector.from_array(src[::-1].copy())
    dt.sort(sv)
    _check("sort", np.array_equal(dt.to_numpy(sv), np.sort(src)))
    kk = np.asarray(src[::-1] % 0.25, dtype=np.float32)
    pp = np.arange(n, dtype=np.float32)
    kd = dt.distributed_vector.from_array(kk)
    pd = dt.distributed_vector.from_array(pp)
    dt.sort_by_key(kd, pd)
    _check("sort_by_key", np.array_equal(
        dt.to_numpy(pd), pp[np.argsort(kk, kind="stable")]))

    # a windowed sort, and a scan between mismatched windows (the realign)
    wv = dt.distributed_vector.from_array(src[::-1].copy())
    wb, we = 3, max(3 + 2 * P, n - 5)
    dt.sort(wv[wb:we])
    wref = src[::-1].copy()
    wref[wb:we] = np.sort(wref[wb:we])
    _check("windowed sort", np.array_equal(dt.to_numpy(wv), wref))
    ws = dt.distributed_vector(n)
    dt.inclusive_scan(x[0:n - 4], ws[4:n])
    _check("mismatched-window scan", np.allclose(
        dt.to_numpy(ws)[4:n], np.cumsum(src[0:n - 4]), rtol=1e-4,
        atol=1e-5))

    # an identityless custom-op reduce
    pos = dt.distributed_vector(n)
    dt.fill(pos, 1.01)
    got = dt.reduce(pos, op=lambda p, q: p * q * 1.0)
    _check("identityless reduce", abs(got - 1.01 ** n) < 1e-3 * 1.01 ** n)

    # unstructured (index-list) halo: exchange refreshes the ghosts from
    # their owners across the ranks, reduce folds them back
    uv = dt.distributed_vector.from_array(src)
    gmap = {0: [n - 1, n - 2], P - 1: [0, 1]}
    uh = dt.unstructured_halo(uv, gmap)
    uh.exchange()
    _check("unstructured halo exchange", all(
        np.array_equal(uh.ghost_values(r).cpu().numpy(), src[ix])
        for r, ix in gmap.items()))
    uh.reduce("plus")
    uref = src.copy()
    for ix in gmap.values():  # each ghost adds its owner's value
        uref[ix] += src[ix]
    _check("unstructured halo reduce", np.array_equal(dt.to_numpy(uv), uref))

    # checkpoint save / load round trip through the distributed container
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "dryrun_ckpt.npz")
        dt.checkpoint.save(ck, x)
        _check("checkpoint round trip", np.array_equal(
            dt.to_numpy(dt.checkpoint.load(ck)), src))

    # N-D mdarray: a 3-D transpose and a submdspan window
    a3 = 2 * P
    cube = np.arange(a3 * 6 * 5, dtype=np.float32).reshape(a3, 6, 5)
    M3 = dt.distributed_mdarray.from_array(cube)
    T3 = dt.distributed_mdarray((5, a3, 6))
    dt.transpose(T3, M3, axes=(2, 0, 1))
    _check("mdarray transpose", np.array_equal(
        T3.materialize(), np.transpose(cube, (2, 0, 1))))
    W3 = M3.submdspan(slice(1, a3), slice(2, 5), slice(0, 3))
    _check("submdspan", np.array_equal(W3.materialize(), cube[1:, 2:5, 0:3]))

    # 2-D tiled dense matrix: heat stencil and gemm, block and
    # block-cyclic layouts
    msize = 4 * P
    grid_src = np.random.default_rng(0).standard_normal(
        (msize, msize)).astype(np.float32)
    A = dt.dense_matrix.from_array(grid_src)
    B = dt.dense_matrix.from_array(grid_src)
    H = dt.stencil2d_iterate(A, B, dt.heat_step_weights(0.25), 2)
    _check("heat stencil", np.isfinite(H.materialize()).all())
    a64 = A.materialize().astype(np.float64)  # the stencil's result
    C = dt.gemm(A, A)
    _check("gemm", np.allclose(C.materialize(), a64 @ a64, rtol=1e-4,
                               atol=1e-4))
    g64 = grid_src.astype(np.float64)
    gref = g64 @ g64
    cyc = dt.block_cyclic(tile=(4, 4), grid=dt.factor(P))
    Ac = dt.dense_matrix.from_array(grid_src, cyc)
    _check("block-cyclic round trip",
           np.array_equal(Ac.materialize(), grid_src))
    Cc = dt.gemm(Ac, Ac)
    _check("block-cyclic gemm", np.allclose(Cc.materialize(), gref,
                                            rtol=1e-4, atol=1e-4))

    # sparse: row-tiled gemv and spmm, a 2-D-partitioned gemv, and the
    # banded matrix on the 2-D grid (BCSR)
    sp = dt.random_sparse_matrix((8 * P, 32), density=0.2, seed=1)
    dense = sp.to_dense().astype(np.float64)
    cvec = dt.distributed_vector(8 * P)
    dt.gemv(cvec, sp, np.ones(32, dtype=np.float32))
    _check("gemv", np.allclose(dt.to_numpy(cvec), dense.sum(1), rtol=1e-4,
                               atol=1e-5))
    Ymm = dt.spmm(sp, np.ones((32, 3), dtype=np.float32))
    _check("spmm", tuple(Ymm.shape) == (8 * P, 3) and np.allclose(
        Ymm.cpu().numpy(), dense.sum(1)[:, None].repeat(3, 1), rtol=1e-4,
        atol=1e-5))
    part = dt.block_cyclic(grid=dt.factor(P))
    sp2 = dt.random_sparse_matrix((8 * P, 8 * P), density=0.2, seed=3,
                                  partition=part)
    cvec2 = dt.distributed_vector(8 * P)
    dt.gemv(cvec2, sp2, np.ones(8 * P, dtype=np.float32))
    _check("2-D gemv", np.allclose(dt.to_numpy(cvec2),
                                   sp2.to_dense().astype(np.float64).sum(1),
                                   rtol=1e-4, atol=1e-5))
    mb = 16 * P
    band = np.zeros((mb, mb), dtype=np.float32)
    for i in range(mb):
        band[i, max(0, i - 2):min(mb, i + 3)] = 1.0 + 0.01 * i
    spb = dt.sparse_matrix.from_dense(band, partition=part)
    spb.ensure_bcsr()  # viable or not, gemv must agree with the oracle
    cb = dt.distributed_vector(mb)
    dt.gemv(cb, spb, np.ones(mb, dtype=np.float32))
    _check("banded 2-D gemv", np.allclose(dt.to_numpy(cb), band.sum(1),
                                          rtol=1e-4))

    # an expression-DSL op (the native bridge's lambda contract) under
    # the SPMD dispatch-order guard
    from .utils import spmd_guard
    from .utils.expr import op_from_expr
    with spmd_guard.guard() as guard_handle:
        ex_out = dt.distributed_vector(n)
        dt.transform(x, ex_out, op_from_expr("(x0 * 2.0 + 1.0)", 1))
        guard_handle.verify()
    _check("op_from_expr under spmd_guard", len(guard_handle.trace) >= 2)
    _check("op_from_expr transform", np.allclose(dt.to_numpy(ex_out),
                                                 2.0 * src + 1.0, rtol=1e-5))

    # sequence-parallel ring attention, causal: f32 (the blockwise ring)
    # and bf16 at head dim 128 (the flash ring, K9), held to each other
    rng = np.random.default_rng(2)
    S, h, dd = 4 * P, 2, 8
    q, k, v = (rng.standard_normal((1, S, h, dd)).astype(np.float32)
               for _ in range(3))
    attn = dt.ring_attention(q, k, v, causal=True)
    _check("ring attention", bool(torch.isfinite(attn).all()))
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 128 * P, 1, 128)).astype(np.float32)) for _ in range(3))
    f32 = dt.ring_attention(q, k, v, causal=True)
    bf = dt.ring_attention(*(t.to(torch.bfloat16) for t in (q, k, v)),
                           causal=True)
    # bf16 inputs and p: a few bf16 ulps of outputs of O(1)
    _check("flash ring attention", float(
        (bf.float() - f32).abs().max()) < 5e-2)
