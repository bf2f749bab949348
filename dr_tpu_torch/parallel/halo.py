"""Structured halo (ghost-cell) exchange over rank rows.

Counterpart of ``dr_tpu/parallel/halo.py`` (reference
``include/dr/details/halo.hpp``).  Each rank row is
``[ghost_prev(prev) | owned(valid) | ghost_next(next) | pad]``; after
``exchange()``:

* ``ghost_prev`` of rank r == the last ``prev`` valid owned cells of r-1,
* ``ghost_next`` of rank r == the first ``next`` owned cells of r+1,
  stored right after r's valid tail,

with ring wraparound iff ``periodic``; non-periodic edge ghosts keep
their old values.  Edge slices move between ranks with
``collectives.ring_shift``; every copy is a plain slice assignment, so
the results are bit-identical to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import collectives

__all__ = ["halo_bounds", "span_halo", "halo_ops"]


@dataclass(frozen=True)
class halo_bounds:
    """Ghost-region widths + ring flag (reference halo.hpp:315-331)."""
    prev: int = 0
    next: int = 0
    periodic: bool = False

    def __post_init__(self):
        assert self.prev >= 0 and self.next >= 0

    @property
    def width(self) -> int:
        return self.prev + self.next


class halo_ops:
    """Fold ops for the ghost->owner reduction (reference halo.hpp:92-110)."""
    second = "second"
    plus = "plus"
    max = "max"
    min = "min"
    multiplies = "multiplies"


def _combine(op: str, owned, incoming):
    if op == halo_ops.second:
        return incoming
    if op == halo_ops.plus:
        return owned + incoming
    if op == halo_ops.max:
        return torch.maximum(owned, incoming)
    if op == halo_ops.min:
        return torch.minimum(owned, incoming)
    if op == halo_ops.multiplies:
        return owned * incoming
    raise ValueError(f"unknown halo reduction op: {op}")


def _valid(nshards, seg, n, r) -> int:
    """Rank r's valid owned width (the last rank may be short)."""
    return n - (nshards - 1) * seg if r == nshards - 1 else seg


def exchange_rows(rows, devices, layout, periodic):
    """One ghost exchange over the rank rows, in place.  ``layout`` is
    the uniform container layout (nshards, seg, prev, nxt, n)."""
    nshards, seg, prev, nxt, n = layout
    # a one-rank ring exchanges with itself only when periodic
    ring = periodic or nshards == 1
    use = periodic or not ring
    valid = [_valid(nshards, seg, n, r) for r in range(nshards)]
    if prev:
        # last `prev` valid owned cells -> next rank's ghost_prev
        sends = [rows[r][:, prev + valid[r] - prev: prev + valid[r]]
                 for r in range(nshards)]
        got_p = collectives.ring_shift(sends, devices, +1, ring)
    if nxt:
        # first `nxt` owned cells -> prev rank's ghost_next
        sends = [rows[r][:, prev: prev + nxt] for r in range(nshards)]
        got_n = collectives.ring_shift(sends, devices, -1, ring)
    # the sends are owned cells and the writes ghost cells, so views
    # taken above stay valid while the ghosts are written
    for r in range(nshards):
        if prev and use and got_p[r] is not None:
            rows[r][:, :prev] = got_p[r]
        if nxt and use and got_n[r] is not None:
            rows[r][:, prev + valid[r]: prev + valid[r] + nxt] = got_n[r]


def reduce_rows(rows, devices, layout, periodic, op):
    """Ghost -> owner fold over the rank rows, in place."""
    nshards, seg, prev, nxt, n = layout
    ring = periodic or nshards == 1
    use = periodic or not ring
    valid = [_valid(nshards, seg, n, r) for r in range(nshards)]
    if prev:
        # my ghost_prev mirrors rank r-1's last `prev` valid cells
        sends = [rows[r][:, :prev].clone() for r in range(nshards)]
        got_p = collectives.ring_shift(sends, devices, -1, ring)
    if nxt:
        # my ghost_next mirrors rank r+1's first `nxt` owned cells
        sends = [rows[r][:, prev + valid[r]: prev + valid[r] + nxt].clone()
                 for r in range(nshards)]
        got_n = collectives.ring_shift(sends, devices, +1, ring)
    for r in range(nshards):
        if prev and use and got_p[r] is not None:
            s = prev + valid[r] - prev
            owned = rows[r][:, s: s + prev]
            rows[r][:, s: s + prev] = _combine(op, owned, got_p[r])
        if nxt and use and got_n[r] is not None:
            owned = rows[r][:, prev: prev + nxt]
            rows[r][:, prev: prev + nxt] = _combine(op, owned, got_n[r])


class span_halo:
    """Halo controller bound to one distributed_vector: ``exchange()``,
    ``exchange_n()``, ``exchange_begin()/exchange_finalize()``,
    ``reduce(op)`` and the per-op helpers (reference halo.hpp:55-110).
    The min-size checks are the JAX package's."""

    def __init__(self, dv):
        self._dv = dv
        hb = dv.halo_bounds
        if hb.width and dv.segment_size < max(hb.prev, hb.next):
            raise ValueError(
                "segment smaller than halo radius "
                f"(segment_size={dv.segment_size}, halo={hb})")
        tail = len(dv) - (dv.nshards - 1) * dv.segment_size
        if hb.width and dv.nshards > 1 and tail < 1:
            raise ValueError(
                "halo requires every shard to own at least one "
                f"element (n={len(dv)}, shards={dv.nshards}, "
                f"segment={dv.segment_size})")
        if hb.width and hb.periodic and tail < max(hb.prev, hb.next):
            raise ValueError(
                f"periodic halo: last shard owns {tail} element(s), "
                f"smaller than the radius {max(hb.prev, hb.next)}; "
                "grow the vector or shrink the mesh")

    @property
    def bounds(self) -> halo_bounds:
        return self._dv.halo_bounds

    def _active(self) -> bool:
        return self._dv.halo_bounds.width > 0 and self._dv.nshards > 0

    def exchange(self) -> None:
        if self._active():
            dv = self._dv
            exchange_rows(dv._rows, dv.runtime.devices, dv.layout,
                          dv.halo_bounds.periodic)

    def exchange_n(self, iters: int) -> None:
        """``iters`` back-to-back exchanges (a measurement aid: each
        round re-reads the same owned edges)."""
        for _ in range(max(iters, 0)):
            self.exchange()

    def exchange_begin(self) -> None:
        # queued on the devices' streams; finalize waits
        self.exchange()

    def exchange_finalize(self) -> None:
        self._dv.runtime.fence()

    def reduce(self, op: str = halo_ops.plus) -> None:
        if self._active():
            dv = self._dv
            reduce_rows(dv._rows, dv.runtime.devices, dv.layout,
                        dv.halo_bounds.periodic, op)

    def reduce_begin(self, op: str = halo_ops.plus) -> None:
        self.reduce(op)

    def reduce_finalize(self) -> None:
        self._dv.runtime.fence()

    def reduce_plus(self):
        self.reduce(halo_ops.plus)

    def reduce_max(self):
        self.reduce(halo_ops.max)

    def reduce_min(self):
        self.reduce(halo_ops.min)

    def reduce_multiplies(self):
        self.reduce(halo_ops.multiplies)
