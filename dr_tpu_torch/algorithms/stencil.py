"""1-D stencils: halo exchange + neighbourhood transform — the
framework's north-star workload (counterpart of
``dr_tpu/algorithms/stencil.py``; reference
``examples/mhp/stencil-1d.cpp:47-66``).

* ``stencil_transform`` / ``stencil_iterate``: one exchange and one
  weighted (or user-op) step per step, in plain PyTorch.
* ``stencil_iterate_matmul``: ``k_block`` steps composed into one banded
  operator per pass (K1, ``ops/stencil_matmul.py``), one full-width ring
  exchange per block.
* ``stencil_iterate_blocked``: ``time_block`` steps per pass on a tile
  with a trapezoid margin (K2, ``ops/stencil_pallas.py``).

The op is a weight vector ``w[-prev..+next]`` or a callable over the
``prev+next+1`` shifted neighbourhood tensors.  Preconditions are the
JAX package's asserts, so both packages accept and refuse the same calls.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from ._common import uniform_layout
from .elementwise import _out_chain, _resolve
from ..parallel import collectives
from ..parallel.halo import exchange_rows

__all__ = ["stencil_transform", "stencil_iterate", "stencil_iterate_blocked",
           "stencil_iterate_matmul"]


def _weights_op(weights):
    w = tuple(float(x) for x in weights)

    def op(*shifted):
        acc = shifted[0] * w[0]
        for wi, s in zip(w[1:], shifted[1:]):
            acc = acc + s * wi
        return acc
    return op, w


def _step_rows(cont, in_rows, out_rows, op, prev, nxt, periodic):
    """One fused exchange + transform step: returns the new output rows.
    The exchange works on copies: the input rows' ghosts stay as they
    were, as in the JAX program."""
    nshards, seg, hprev, hnxt, n = cont.layout
    assert hprev >= prev and hnxt >= nxt, "halo narrower than stencil radius"
    rows = [r.clone() for r in in_rows]
    if (hprev or hnxt) and (nshards > 1 or periodic):
        exchange_rows(rows, cont.runtime.devices, cont.layout, periodic)
    lo_g, hi_g = (0, n) if periodic else (prev, n - nxt)
    new = []
    for idx, (row, out) in enumerate(zip(rows, out_rows)):
        shifted = [row[0, hprev + d: hprev + d + seg]
                   for d in range(-prev, nxt + 1)]
        vals = op(*shifted)
        a = max(lo_g - idx * seg, 0)
        b = min(hi_g - idx * seg, seg)
        out = out.clone()
        if a < b:
            out[0, hprev + a: hprev + b] = vals[a:b].to(out.dtype)
        new.append(out)
    return new


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
    oc.cont._rows = _step_rows(cont, cont._rows, oc.cont._rows, body_op,
                               prev, nxt, cont.halo_bounds.periodic)


def stencil_iterate(a_dv, b_dv, op: Union[Callable, Sequence[float]],
                    steps: int):
    """``steps`` fused stencil steps with double buffering; returns
    ``a_dv`` holding the final state (``b_dv`` holds the other buffer)."""
    cont = a_dv
    assert b_dv.layout == cont.layout
    assert uniform_layout(cont.layout), \
        "stencils require the uniform block distribution"
    body_op, prev, nxt = _radius(cont, op)
    x, y = a_dv._rows, b_dv._rows
    for _ in range(steps):
        y = _step_rows(cont, x, y, body_op, prev, nxt,
                       cont.halo_bounds.periodic)
        x, y = y, x
    a_dv._rows, b_dv._rows = x, y
    return a_dv


def _ring_exchange_full(rows, devices, seg: int, halo_w: int) -> None:
    """Periodic full-width ghost refresh for the blocked paths, in place:
    both edge slices of every owned block move one hop around the ring."""
    sends = [r[:, seg: halo_w + seg].clone() for r in rows]
    for r, g in zip(rows, collectives.ring_shift(sends, devices, +1, True)):
        r[:, :halo_w] = g
    sends = [r[:, halo_w: 2 * halo_w].clone() for r in rows]
    for r, g in zip(rows, collectives.ring_shift(sends, devices, -1, True)):
        r[:, r.shape[-1] - halo_w:] = g


def _blocked_drive(cont, steps, block, apply):
    """Full blocks then the remainder block; each block is one ring
    exchange plus one ``apply(row, nsteps)`` per rank."""
    nshards, seg, prev, nxt, n = cont.layout
    nfull, rest = divmod(steps, block)
    for nst in [block] * nfull + ([rest] if rest else []):
        _ring_exchange_full(cont._rows, cont.runtime.devices, seg, prev)
        cont._rows = [apply(row, nst) for row in cont._rows]
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
    from ..ops import stencil_pallas
    r, seg, halo = _blocked_asserts(dv, weights, time_block, "time_block")
    # one hop supplies at most seg fresh neighbour cells
    assert time_block * r <= seg, \
        "time_block * radius exceeds the per-shard segment"
    w = tuple(float(x) for x in weights)
    return _blocked_drive(
        dv, steps, time_block,
        lambda row, nst: stencil_pallas.blocked_stencil_row(
            row, seg, halo, w, nst))


def stencil_iterate_matmul(dv, weights, steps: int, *, k_block: int = 32):
    """Temporally blocked stencil with ``k_block`` steps composed into
    one banded operator per pass (K1), one ring exchange per block.  Same
    contract as :func:`stencil_iterate_blocked`, plus
    k_block <= max_ksteps(radius) and 128-aligned seg and halo."""
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
    return _blocked_drive(
        dv, steps, k_block,
        lambda row, nst: stencil_matmul.matmul_stencil_row(
            row, seg, halo, w, nst))
