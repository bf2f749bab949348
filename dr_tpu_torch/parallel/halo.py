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
the results are bit-identical to the JAX package's.  In a multi-process
runtime a process sends and writes only its own ranks' rows (the None
entries are another process's), and the ring shift carries the edge
slices across the process boundary.

``span_halo``'s exchange and reduce fire the ``halo.exchange`` /
``halo.reduce`` fault sites and then look up ``_program_cache`` (the
dispatch tap) before any row is touched, as the JAX package does; the
stencils' fused exchanges call :func:`exchange_rows` directly, like the
JAX stencil programs, and fire neither (the plain step's kernel route
calls :func:`ghost_slices`, the same exchange returning the received
slices and writing nothing).  Inside ``dt.deferred()`` the
exchange, ``exchange_n`` and reduce record into the plan
(``Plan.record_halo``: the same row functions at the flush, no fault
site of their own), and the ``*_finalize`` calls flush it.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

from . import collectives
from .. import obs as _obs
from ..core.pinning import pinned_id
from ..utils import faults as _faults
from ..utils.spmd_guard import TappedCache

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
        return collectives.ordered_maximum(owned, incoming)
    if op == halo_ops.min:
        return collectives.ordered_minimum(owned, incoming)
    if op == halo_ops.multiplies:
        return owned * incoming
    raise ValueError(f"unknown halo reduction op: {op}")


def _valid(nshards, seg, n, r) -> int:
    """Rank r's valid owned width (the last rank may be short)."""
    return n - (nshards - 1) * seg if r == nshards - 1 else seg


def _shift_both(rows, devices, ring, a, b):
    """The ring shifts of the ``a`` and ``b`` edge slices (each
    ``(slice_of_rank, step, width)``, or falsy to skip) in one exchange
    across processes; returns each one's receives (None where skipped).
    Every rank's slice is ``(1, width)`` of the rows' dtype, so no
    header travels."""
    specs = [x for x in (a, b) if x]
    if not specs:
        return None, None
    dtype = collectives.present(rows).dtype
    widths = {w for _, _, w in specs}
    got = collectives.ring_shifts(
        [([None if rows[r] is None else fn(r) for r in range(len(rows))],
          step) for fn, step, _ in specs], devices, ring,
        like=((1, widths.pop()), dtype) if len(widths) == 1 else None)
    got = iter(got)
    return (next(got) if a else None), (next(got) if b else None)


def _received(rows, devices, layout, periodic):
    """The ghosts one exchange delivers: per rank, the ``(1, prev)``
    slice for its ghost_prev and the ``(1, nxt)`` slice for its
    ghost_next, None where that ghost keeps its old values (a
    non-periodic edge, a zero width, another process's rank)."""
    nshards, seg, prev, nxt, n = layout
    # a one-rank ring exchanges with itself only when periodic
    ring = periodic or nshards == 1
    use = periodic or not ring
    valid = [_valid(nshards, seg, n, r) for r in range(nshards)]
    # last `prev` valid owned cells -> next rank's ghost_prev; first
    # `nxt` owned cells -> prev rank's ghost_next
    got_p, got_n = _shift_both(
        rows, devices, ring,
        prev and (lambda r: rows[r][:, prev + valid[r] - prev:
                                    prev + valid[r]], +1, prev),
        nxt and (lambda r: rows[r][:, prev: prev + nxt], -1, nxt))
    none = [None] * nshards
    return ((got_p if prev and use else none),
            (got_n if nxt and use else none))


def ghost_slices(rows, devices, layout, periodic):
    """One ghost exchange that writes nothing: returns the per-rank
    ghost_prev and ghost_next slices :func:`exchange_rows` would write
    (None where it writes nothing).  A slice may be a view of a
    neighbour's row (one device), so the rows must not change while the
    slices are in use."""
    with _obs.span("halo.exchange", cat="halo"):
        return _received(rows, devices, layout, periodic)


def exchange_rows(rows, devices, layout, periodic):
    """One ghost exchange over the rank rows, in place.  ``layout`` is
    the uniform container layout (nshards, seg, prev, nxt, n)."""
    with _obs.span("halo.exchange", cat="halo"):
        nshards, seg, prev, nxt, n = layout
        got_p, got_n = _received(rows, devices, layout, periodic)
        # the sends are owned cells and the writes ghost cells, so views
        # taken above stay valid while the ghosts are written
        for r in range(nshards):
            if rows[r] is None:
                continue
            if got_p[r] is not None:
                rows[r][:, :prev] = got_p[r]
            if got_n[r] is not None:
                v = _valid(nshards, seg, n, r)
                rows[r][:, prev + v: prev + v + nxt] = got_n[r]


def reduce_rows(rows, devices, layout, periodic, op):
    """Ghost -> owner fold over the rank rows, in place."""
    nshards, seg, prev, nxt, n = layout
    ring = periodic or nshards == 1
    use = periodic or not ring
    valid = [_valid(nshards, seg, n, r) for r in range(nshards)]
    # my ghost_prev mirrors rank r-1's last `prev` valid cells, my
    # ghost_next rank r+1's first `nxt` owned cells
    got_p, got_n = _shift_both(
        rows, devices, ring,
        prev and (lambda r: rows[r][:, :prev].clone(), -1, prev),
        nxt and (lambda r: rows[r][:, prev + valid[r]:
                                   prev + valid[r] + nxt].clone(), +1, nxt))
    for r in range(nshards):
        if rows[r] is None:
            continue
        if prev and use and got_p[r] is not None:
            s = prev + valid[r] - prev
            owned = rows[r][:, s: s + prev]
            rows[r][:, s: s + prev] = _combine(op, owned, got_p[r])
        if nxt and use and got_n[r] is not None:
            owned = rows[r][:, prev: prev + nxt]
            rows[r][:, prev: prev + nxt] = _combine(op, owned, got_n[r])


def _plan_active():
    from ..plan import active
    return active()


#: the halo's dispatch cache (the JAX package's exchange / reduce programs)
_program_cache: dict = TappedCache()


def _tap(kind, dv, op=None, iters=1) -> None:
    hb = dv.halo_bounds
    _program_cache.tap((kind, pinned_id(dv.runtime), dv.nshards,
                        dv.segment_size, hb.prev, hb.next, hb.periodic,
                        len(dv), op, iters))


class span_halo:
    """Halo controller bound to one distributed_vector: ``exchange()``,
    ``exchange_n()``, ``exchange_begin()/exchange_finalize()``,
    ``reduce(op)`` and the per-op helpers (reference halo.hpp:55-110).
    The min-size checks are the JAX package's.

    The halo refers to its vector weakly (the vector holds its halo), so
    a dropped vector frees its rows at once, without the cycle
    collector; a halo whose vector is gone raises."""

    def __init__(self, dv):
        self._ref = weakref.ref(dv)
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
    def _dv(self):
        dv = self._ref()
        if dv is None:
            raise ReferenceError("span_halo: its distributed_vector has "
                                 "been freed")
        return dv

    @property
    def bounds(self) -> halo_bounds:
        return self._dv.halo_bounds

    def _active(self) -> bool:
        return self._dv.halo_bounds.width > 0 and self._dv.nshards > 0

    def exchange(self) -> None:
        if self._active():
            dv = self._dv
            p = _plan_active()
            if p is not None:
                p.record_halo(dv, "exchange")
                return
            _faults.fire("halo.exchange")
            _tap("exchange", dv)
            exchange_rows(dv._rows, dv.runtime.devices, dv.layout,
                          dv.halo_bounds.periodic)

    def exchange_n(self, iters: int) -> None:
        """``iters`` back-to-back exchanges as one dispatch (a
        measurement aid: each round re-reads the same owned edges)."""
        if not self._active() or iters <= 0:
            return
        dv = self._dv
        p = _plan_active()
        if p is not None:
            p.record_halo(dv, "exchange_n", iters=iters)
            return
        _faults.fire("halo.exchange")
        _tap("exchange_n", dv, iters=iters)
        for _ in range(iters):
            exchange_rows(dv._rows, dv.runtime.devices, dv.layout,
                          dv.halo_bounds.periodic)

    def exchange_begin(self) -> None:
        # queued on the devices' streams; finalize waits
        self.exchange()

    def exchange_finalize(self) -> None:
        from ..plan import flush_reads
        flush_reads("exchange_finalize")
        self._dv.runtime.fence()

    def reduce(self, op: str = halo_ops.plus) -> None:
        if self._active():
            dv = self._dv
            p = _plan_active()
            if p is not None:
                p.record_halo(dv, "reduce", op)
                return
            _faults.fire("halo.reduce")
            _tap("reduce", dv, op)
            reduce_rows(dv._rows, dv.runtime.devices, dv.layout,
                        dv.halo_bounds.periodic, op)

    def reduce_begin(self, op: str = halo_ops.plus) -> None:
        self.reduce(op)

    def reduce_finalize(self) -> None:
        from ..plan import flush_reads
        flush_reads("reduce_finalize")
        self._dv.runtime.fence()

    def reduce_plus(self):
        self.reduce(halo_ops.plus)

    def reduce_max(self):
        self.reduce(halo_ops.max)

    def reduce_min(self):
        self.reduce(halo_ops.min)

    def reduce_multiplies(self):
        self.reduce(halo_ops.multiplies)
