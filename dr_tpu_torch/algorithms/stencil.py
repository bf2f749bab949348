"""1-D stencils: halo exchange + neighbourhood transform — the
framework's north-star workload (counterpart of
``dr_tpu/algorithms/stencil.py``; reference
``examples/mhp/stencil-1d.cpp:47-66``).

* ``stencil_transform`` / ``stencil_iterate``: one exchange and one
  weighted (or user-op) step per step.  A weight vector of radius 1..8
  on float32 CUDA rows steps in one pass of ``ops/stencil_step.py``'s
  kernel, its ghosts read from the exchange's received slices; a
  callable op, another dtype, a wider radius or CPU rows step with
  torch ops on copies of the rows.
* ``stencil_iterate_matmul``: ``k_block`` steps composed into one banded
  operator per pass (K1, ``ops/stencil_matmul.py``), one full-width ring
  exchange per block.
* ``stencil_iterate_blocked``: ``time_block`` steps per pass on a tile
  with a trapezoid margin (K2, ``ops/stencil_pallas.py``).

The op is a weight vector ``w[-prev..+next]`` or a callable over the
``prev+next+1`` shifted neighbourhood tensors.  Preconditions are the
JAX package's asserts, so both packages accept and refuse the same calls.

In a multi-process runtime each process steps its own ranks' rows (K1
/ K2 on its row); the ring exchanges between steps and passes cross the
process boundary through ``collectives.ring_shift``.

Inside ``dt.deferred()``, ``stencil_transform`` records one fused
exchange + step (``Plan.record_stencil``, :func:`_step_rows` at the
flush), and the iterated, blocked (K2) and matmul (K1) stencils record
OPAQUE: they run through their eager path at the flush, in record order.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from .. import obs as _obs
from ._common import uniform_layout
from .elementwise import (_op_key, _out_chain, _plan_active, _prog_cache,
                          _resolve)
from ..core.pinning import pinned_id
from ..utils import spmd_guard
from ..utils.spmd_guard import dtype_name
from ..parallel import collectives
from ..parallel import runtime as _rt
from ..parallel.halo import _valid, exchange_rows, ghost_slices
from ..ops import kernels, stencil_step

__all__ = ["stencil_transform", "stencil_iterate", "build_stencil_step",
           "stencil_iterate_blocked", "stencil_iterate_matmul"]


def _weights_op(weights):
    """The op of a weight vector (:func:`stencil_step.plain_step` over
    the shifted neighbourhoods); it carries its weights as ``.weights``,
    which routes its steps to the kernel."""
    w = tuple(float(x) for x in weights)

    def op(*shifted):
        return stencil_step.plain_step(shifted, w)
    op.weights = w
    return op, w


def _kernel_weights(op, prev, nxt):
    """The weights of an op whose steps the kernel takes, else None: an
    op carrying 2r + 1 weights, r in 1..8, stepping its own radius."""
    w = getattr(op, "weights", None)
    if w is None:
        return None
    r = stencil_step.radius(w)
    if len(w) != 2 * r + 1 or not 1 <= r <= stencil_step.MAX_RADIUS \
            or prev != r or nxt != r:
        return None
    return w


def _kernel_rows(in_rows, out_rows):
    """True where the kernel takes the rows: float32, every one on CUDA
    (a mix of devices keeps the torch-op step), and ``kernels.on_cuda``,
    the rule every wrapper routes by, sends them to a kernel."""
    rows = [t for t in list(in_rows) + list(out_rows) if t is not None]
    return bool(rows) and all(t.dtype == torch.float32
                              and t.device.type == "cuda"
                              for t in rows) and kernels.on_cuda(*rows)


def _kernel_step(layout, devices, in_rows, out_rows, w, periodic):
    """The kernel route of :func:`_step_rows`: the ghosts as slices
    (``ghost_slices``), one ``stencil_step`` pass a rank into a fresh out
    row; no row is cloned and the in rows are not written."""
    nshards, seg, hprev, hnxt, n = layout
    r = stencil_step.radius(w)
    none = [None] * nshards
    got_p, got_n = (ghost_slices(in_rows, devices, layout, periodic)
                    if (hprev or hnxt) and (nshards > 1 or periodic)
                    else (none, none))
    lo_g, hi_g = (0, n) if periodic else (r, n - r)
    new = []
    for idx, (row, out) in enumerate(zip(in_rows, out_rows)):
        if row is None:  # another process steps this rank
            new.append(None)
            continue
        a = max(lo_g - idx * seg, 0)
        b = min(hi_g - idx * seg, seg)
        new.append(stencil_step.step_row(
            row, out, w, hprev, _valid(nshards, seg, n, idx), a, b,
            got_p[idx], got_n[idx]))
    return new


def _torch_step(layout, devices, in_rows, out_rows, op, prev, nxt,
                periodic):
    """The torch-op route of :func:`_step_rows`: the exchange into
    clones of the in rows, ``op`` over the shifted slices, the stepped
    cells written into a clone of each out row."""
    nshards, seg, hprev, hnxt, n = layout
    with _obs.span("rows.copy", cat="rows"):
        rows = [None if r is None else r.clone() for r in in_rows]
    if (hprev or hnxt) and (nshards > 1 or periodic):
        exchange_rows(rows, devices, layout, periodic)
    lo_g, hi_g = (0, n) if periodic else (prev, n - nxt)
    new = []
    for idx, (row, out) in enumerate(zip(rows, out_rows)):
        if row is None:  # another process steps this rank
            new.append(None)
            continue
        shifted = [row[0, hprev + d: hprev + d + seg]
                   for d in range(-prev, nxt + 1)]
        vals = op(*shifted)
        a = max(lo_g - idx * seg, 0)
        b = min(hi_g - idx * seg, seg)
        with _obs.span("rows.copy", cat="rows"):
            out = out.clone()
        if a < b:
            out[0, hprev + a: hprev + b] = vals[a:b].to(out.dtype)
        new.append(out)
    return new


def _step_rows(layout, devices, in_rows, out_rows, op, prev, nxt,
               periodic):
    """One fused exchange + transform step: returns the new output rows;
    the input rows and their ghosts stay as they were, as in the JAX
    program.  A weight-vector op (``_weights_op``) of radius 1..8 over
    float32 CUDA rows takes the ``stencil_step`` kernel, one launch a
    rank (:func:`_kernel_step`).  A callable op, another dtype, a radius
    above 8, a ``radius`` other than the weights' and CPU rows keep the
    torch-op step (:func:`_torch_step`); on CUDA rows an armed
    ``stencil.step.torch`` count marks each such step."""
    nshards, seg, hprev, hnxt, n = layout
    assert hprev >= prev and hnxt >= nxt, "halo narrower than stencil radius"
    w = _kernel_weights(op, prev, nxt)
    if w is not None and _kernel_rows(in_rows, out_rows):
        return _kernel_step(layout, devices, in_rows, out_rows, w, periodic)
    if any(r is not None and r.device.type == "cuda" for r in in_rows):
        _obs.count("stencil.step.torch")
    return _torch_step(layout, devices, in_rows, out_rows, op, prev, nxt,
                       periodic)


def build_stencil_step(layout, periodic, op, prev, nxt, devices=None):
    """One fused exchange + transform step as a function of rank rows
    (counterpart of ``dr_tpu/algorithms/stencil.py:46``): ``step(in_rows,
    out_rows)`` returns the new output rows of a container with
    ``layout`` (nshards, seg, prev, nxt, n) on ``devices`` (default: the
    runtime's).  ``op`` maps the ``prev+nxt+1`` shifted neighbourhoods to
    the output cells; the input rows are not changed."""
    devs = devices if devices is not None else _rt.devices()

    def step(in_rows, out_rows):
        return _step_rows(layout, devs, in_rows, out_rows, op, prev, nxt,
                          periodic)
    return step


def _key_op(op):
    """The JAX key's op entry: a callable's pinned identity, else the
    weights."""
    return _op_key(op) if callable(op) else tuple(float(x) for x in op)


def _radius(cont, op):
    hb = cont.halo_bounds
    if callable(op):
        return op, hb.prev, hb.next
    body_op, w = _weights_op(op)
    rad = (len(w) - 1) // 2  # the weights fix the radius; halo may be wider
    assert hb.prev >= rad and hb.next >= rad, \
        "halo narrower than the weight-stencil radius"
    return body_op, rad, rad


def stencil_transform(in_dv, out_dv, op: Union[Callable, Sequence[float]],
                      radius: Optional[int] = None) -> None:
    """One fused halo-exchange + stencil-transform step into ``out_dv``."""
    ic = _resolve(in_dv)
    oc = _out_chain(out_dv)
    assert ic is not None and len(ic) == 1 and not ic[0].ops and \
        ic[0].off == 0 and ic[0].n == len(ic[0].cont), \
        "stencil input must be a whole distributed_vector"
    cont = ic[0].cont
    assert oc.off == 0 and oc.n == len(oc.cont) and \
        oc.cont.layout == cont.layout, \
        "stencil output must be a whole aligned distributed_vector"
    assert uniform_layout(cont.layout), \
        "stencils require the uniform block distribution"
    body_op, prev, nxt = _radius(cont, op)
    if radius is not None:
        prev = nxt = radius
    p = _plan_active()
    if p is not None:
        p.record_stencil(cont, oc.cont, cont.halo_bounds.periodic, prev, nxt,
                         _key_op(op), body_op)
        return
    _prog_cache.tap(("stencil", pinned_id(cont.runtime), cont.layout,
                     cont.halo_bounds.periodic, prev, nxt, _key_op(op),
                     dtype_name(cont.dtype)))
    oc.cont._rows = _step_rows(cont.layout, cont.runtime.devices,
                               cont._rows, oc.cont._rows, body_op, prev,
                               nxt, cont.halo_bounds.periodic)


def stencil_iterate(a_dv, b_dv, op: Union[Callable, Sequence[float]],
                    steps: int):
    """``steps`` fused stencil steps with double buffering; returns
    ``a_dv`` holding the final state (``b_dv`` holds the other buffer)."""
    p = _plan_active()
    if p is not None:
        p.record_opaque("stencil_iterate",
                        lambda: stencil_iterate(a_dv, b_dv, op, steps),
                        reads=(a_dv, b_dv),
                        writes=((a_dv, False), (b_dv, False)))
        return a_dv
    cont = a_dv
    assert b_dv.layout == cont.layout
    assert uniform_layout(cont.layout), \
        "stencils require the uniform block distribution"
    body_op, prev, nxt = _radius(cont, op)
    _prog_cache.tap(("stencil_it", pinned_id(cont.runtime), cont.layout,
                     cont.halo_bounds.periodic, _key_op(op), steps,
                     dtype_name(cont.dtype)))
    x, y = a_dv._rows, b_dv._rows
    for _ in range(steps):
        y = _step_rows(cont.layout, cont.runtime.devices, x, y, body_op,
                       prev, nxt, cont.halo_bounds.periodic)
        x, y = y, x
    a_dv._rows, b_dv._rows = x, y
    return a_dv


def _ring_exchange_full(rows, devices, seg: int, halo_w: int) -> None:
    """Periodic full-width ghost refresh for the blocked paths, in place:
    both edge slices of every owned block move one hop around the ring."""
    with _obs.span("halo.exchange", cat="halo"):
        # both slices are owned cells and every write a ghost cell, so the
        # two shifts travel together
        fwd, bwd = collectives.ring_shifts(
            [([None if r is None else r[:, seg: halo_w + seg].clone()
               for r in rows], +1),
             ([None if r is None else r[:, halo_w: 2 * halo_w].clone()
               for r in rows], -1)], devices, True,
            like=((1, halo_w), collectives.present(rows).dtype))
        for r, g, h in zip(rows, fwd, bwd):
            if r is not None:
                r[:, :halo_w] = g
                r[:, r.shape[-1] - halo_w:] = h


def _blocked_drive(cont, key, steps, block, apply):
    """Full blocks then the remainder block; each block is one ring
    exchange plus one ``apply(row, nsteps)`` per rank.  ``key`` is the
    dispatch tap's; each step count's first use counts as a compile
    (the JAX package's per-step-count programs)."""
    nshards, seg, prev, nxt, n = cont.layout
    nfull, rest = divmod(steps, block)
    seen = _prog_cache.setdefault(key, set())
    for nst in ([block] if nfull else []) + ([rest] if rest else []):
        if nst not in seen:
            seen.add(nst)
            spmd_guard.note_compile(key + (nst,))
    for nst in [block] * nfull + ([rest] if rest else []):
        _ring_exchange_full(cont._rows, cont.runtime.devices, seg, prev)
        cont._rows = [None if row is None else apply(row, nst)
                      for row in cont._rows]
    return cont


def _blocked_asserts(cont, weights, block, name):
    r = (len(weights) - 1) // 2
    nshards, seg, prev, nxt, n = cont.layout
    assert cont.halo_bounds.periodic, "blocked stencil runs on the periodic ring"
    assert prev == nxt and prev >= block * r, \
        f"halo width must cover {name} * radius"
    assert n == nshards * seg, "blocked stencil needs equal full shards"
    return r, seg, prev


def stencil_iterate_blocked(dv, weights, steps: int, *, time_block: int = 8):
    """Temporally blocked stencil: ``time_block`` steps per pass over the
    data (K2), one ring exchange per block.  Needs the periodic ring,
    halo >= time_block * radius and equal full shards.  Returns ``dv``
    stepped ``steps`` times."""
    p = _plan_active()
    if p is not None:
        p.record_opaque("stencil_iterate_blocked",
                        lambda: stencil_iterate_blocked(
                            dv, weights, steps, time_block=time_block),
                        reads=(dv,), writes=((dv, False),))
        return dv
    from ..ops import stencil_pallas
    r, seg, halo = _blocked_asserts(dv, weights, time_block, "time_block")
    # one hop supplies at most seg fresh neighbour cells
    assert time_block * r <= seg, \
        "time_block * radius exceeds the per-shard segment"
    w = tuple(float(x) for x in weights)
    key = ("stencil_blk", pinned_id(dv.runtime), dv.layout, w, time_block,
           dtype_name(dv.dtype))
    return _blocked_drive(
        dv, key, steps, time_block,
        lambda row, nst: stencil_pallas.blocked_stencil_row(
            row, seg, halo, w, nst))


def stencil_iterate_matmul(dv, weights, steps: int, *, k_block: int = 32):
    """Temporally blocked stencil with ``k_block`` steps composed into
    one banded operator per pass (K1), one ring exchange per block.  Same
    contract as :func:`stencil_iterate_blocked`, plus
    k_block <= max_ksteps(radius) and 128-aligned seg and halo."""
    p = _plan_active()
    if p is not None:
        p.record_opaque("stencil_iterate_matmul",
                        lambda: stencil_iterate_matmul(
                            dv, weights, steps, k_block=k_block),
                        reads=(dv,), writes=((dv, False),))
        return dv
    from ..ops import stencil_matmul
    r, seg, halo = _blocked_asserts(dv, weights, k_block, "k_block")
    assert k_block <= stencil_matmul.max_ksteps(r), \
        "composed band exceeds the supported lane-column reach"
    assert k_block * r <= seg, \
        "k_block * radius exceeds the per-shard segment"
    la = stencil_matmul.LANES
    assert seg % la == 0, (
        f"stencil_iterate_matmul requires the per-shard segment "
        f"({seg}) to be a multiple of {la} lanes")
    assert halo % la == 0, (
        f"stencil_iterate_matmul requires the halo width ({halo}) "
        f"to be a multiple of {la} lanes")
    w = tuple(float(x) for x in weights)
    key = ("stencil_mm", pinned_id(dv.runtime), dv.layout, w, k_block,
           dtype_name(dv.dtype))
    return _blocked_drive(
        dv, key, steps, k_block,
        lambda row, nst: stencil_matmul.matmul_stencil_row(
            row, seg, halo, w, nst))
