"""Interference graph over recorded plan items: the one place that
interprets declared footprints (counterpart of
``dr_tpu/plan/interference.py``).

Every recorded item carries a declared read/write footprint
(:class:`_FusedOp.reads`/``writes`` in run-local SLOTS,
:class:`_Opaque.reads`/``writes`` in CONTAINERS, ``None`` = unknown
barrier).  Everything that REORDERS, DROPS, or SKIPS work based on
those declarations routes through this module:

* the optimizer passes (merge disjointness, dce coverage, pushdown's
  linearized event stream),
* the ``flush_reads`` footprint-gated flush skip,
* the plansan runtime verifier and serializability oracle.

Outside this file, no code under ``dr_tpu_torch/plan/`` reads a
``.reads`` / ``.writes`` attribute.
"""

from __future__ import annotations

from typing import Optional

from . import PlanScalar, _Opaque, _Run

__all__ = [
    "op_reads", "op_writes", "op_read_slots", "op_write_slots",
    "op_footprint_key", "op_removable", "opaque_reads", "opaque_writes",
    "opaque_is_barrier", "remap", "item_touch", "queue_touches",
    "events", "scalar_producers", "op_scalar_producers",
    "view_containers", "Coverage",
]


# ---------------------------------------------------------------------------
# declared-footprint accessors
# ---------------------------------------------------------------------------

def op_reads(op) -> tuple:
    """Declared read SLOTS of a fused op (run-local numbering)."""
    return op.reads


def op_writes(op) -> tuple:
    """Declared write windows of a fused op: ``(slot, off, n, full)``
    tuples (``full`` = whole padded row rebuilt, a coverage killer)."""
    return op.writes


def op_read_slots(op) -> frozenset:
    """The read footprint as a slot set."""
    return frozenset(op.reads)


def op_write_slots(op) -> frozenset:
    """The written slots (window extents dropped)."""
    return frozenset(s for (s, _off, _n, _full) in op.writes)


def op_footprint_key(op) -> tuple:
    """Hashable identity of the op's declared footprint: part of the
    plansan verify-cache key, so a re-declared footprint re-verifies."""
    return (tuple(op.reads), tuple(op.writes))


def op_removable(op) -> bool:
    """May the dead-op pass even consider this op?  Pure, writes
    something, and has no dispatch-time ``pre`` side effects."""
    return op.pure and bool(op.writes) and op.pre is None


def opaque_reads(item) -> Optional[tuple]:
    """Declared read CONTAINERS of an opaque item (None = unknown)."""
    return item.reads


def opaque_writes(item) -> Optional[tuple]:
    """Declared ``(container, full)`` writes of an opaque item
    (None = unknown)."""
    return item.writes


def opaque_is_barrier(item) -> bool:
    """An opaque item with any unknown footprint is a barrier nothing
    reorders across or eliminates through."""
    return item.reads is None or item.writes is None


def remap(op, smap) -> tuple:
    """The op's declared footprint re-slotted through ``smap`` (source
    run slot -> merged run slot) — the merge pass's wrapper footprint
    comes from here, never hand-rolled."""
    return (tuple(smap[s] for s in op.reads),
            tuple((smap[s], off, n, full)
                  for (s, off, n, full) in op.writes))


# ---------------------------------------------------------------------------
# item-level aliasing queries
# ---------------------------------------------------------------------------

def item_touch(item) -> Optional[set]:
    """Every container id the item may read OR write; None = unknown
    (a barrier nothing reorders across)."""
    if isinstance(item, _Run):
        return {id(c) for c in item.conts}
    if opaque_is_barrier(item):
        return None
    ids = {id(c) for c in item.reads}
    ids.update(id(c) for c, _full in item.writes)
    return ids


def queue_touches(queue, cont) -> bool:
    """Could any queued item read or write ``cont``?  The footprint
    check ``flush_reads`` keys its skip on.  A run answers
    by slot membership; an opaque item with UNKNOWN footprints answers
    True — the conservative barrier."""
    cid = id(cont)
    for item in queue:
        if isinstance(item, _Run):
            if cid in item._cont_ids:
                return True
        else:
            touch = item_touch(item)
            if touch is None or cid in touch:
                return True
    return False


def view_containers(operand, _depth: int = 0) -> Optional[tuple]:
    """The distributed containers a VIEW operand ultimately reads,
    resolved through ``components``/``base`` chains (zip_view,
    subrange, transform, …).  ``None`` = some leaf is not a
    recognizable container, so the caller must keep the conservative
    barrier footprint.  Opaque record sites over view operands (gemv
    over a subrange/zip) declare real footprints through this helper
    instead of ``reads=None``, so the ``flush_reads`` skip does not
    flush on every host touch."""
    if _depth > 8:
        return None
    comps = getattr(operand, "components", None)
    if comps is not None:
        out = []
        for c in comps:
            sub = view_containers(c, _depth + 1)
            if sub is None:
                return None
            out.extend(sub)
        return tuple(out)
    base = getattr(operand, "base", None)
    if base is not None:
        return view_containers(base, _depth + 1)
    if hasattr(operand, "__dr_segments__") and hasattr(operand, "__len__"):
        # a container leaf (or a self-generating range like iota,
        # whose id simply never aliases a queued container)
        return (operand,)
    return None


def op_scalar_producers(op) -> set:
    """Ids of the runs producing still-pending scalar operands THIS op
    fetches at dispatch — the plansan oracle's scalar dependency
    edges."""
    return {id(v._run) for v in op.vals
            if isinstance(v, PlanScalar) and v._val is None
            and v._run is not None}


def scalar_producers(run) -> set:
    """Ids of the runs producing still-pending scalar operands this
    run fetches at dispatch — it must execute AFTER every one of them,
    so no pass may move it past one."""
    out = set()
    for o in run.ops:
        out |= op_scalar_producers(o)
    return out


def events(q) -> list:
    """Linearized touch events, execution order: ``(kind, cont_id,
    item_index, op_or_None, full)`` with ``kind`` in {"r", "w",
    "barrier"} (barriers carry cont_id None)."""
    ev = []
    for qi, item in enumerate(q):
        if isinstance(item, _Opaque):
            if opaque_is_barrier(item):
                ev.append(("barrier", None, qi, None, False))
                continue
            for c in item.reads:
                ev.append(("r", id(c), qi, None, False))
            for c, full in item.writes:
                ev.append(("w", id(c), qi, None, full))
            continue
        for o in item.ops:
            for s in op_reads(o):
                ev.append(("r", id(item.conts[s]), qi, o, False))
            for (s, off, n, full) in op_writes(o):
                ev.append(("w", id(item.conts[s]), qi, o, full))
    return ev


# ---------------------------------------------------------------------------
# backward interval coverage (the dce pass's walk)
# ---------------------------------------------------------------------------

class Coverage:
    """Backward interval-coverage state over container cells: a pure
    op whose written windows are all overwritten before any read is
    dead; reads reset coverage; a kept op's write window extends
    coverage only when the op does not read that container (the
    mask-preserve argument: cells outside the window pass through).  A full-row victim (ghost-zeroing
    relational outputs) retires only under a full-row killer."""

    def __init__(self):
        self._cov: dict = {}

    def _cover(self, c, lo, hi, ghost) -> None:
        ent = self._cov.get(id(c))
        if ent is None:
            ent = self._cov[id(c)] = [[], False]
        if ghost:
            ent[1] = True
        if hi <= lo:
            return
        ivs = ent[0]
        ivs.append((lo, hi))
        ivs.sort()
        out = [ivs[0]]
        for a, b in ivs[1:]:
            la, lb = out[-1]
            if a <= lb:
                out[-1] = (la, max(lb, b))
            else:
                out.append((a, b))
        ent[0] = out

    def _is_covered(self, c, off, n, needs_ghost) -> bool:
        if n <= 0:
            return True  # an empty window writes nothing
        ent = self._cov.get(id(c))
        if ent is None:
            return False
        if needs_ghost and not ent[1]:
            return False
        for a, b in ent[0]:
            if a <= off and off + n <= b:
                return True
        return False

    def visit_opaque(self, item) -> None:
        """Fold an opaque item into the backward walk: a barrier
        clears everything; declared reads reset their containers;
        declared full writes of containers the item does not read
        extend ghost coverage."""
        if opaque_is_barrier(item):
            self._cov.clear()
            return
        for c in item.reads:
            self._cov.pop(id(c), None)
        rid = {id(c) for c in item.reads}
        for c, full in item.writes:
            if full and id(c) not in rid:
                self._cover(c, 0, len(c), True)

    def op_dead(self, run, op) -> bool:
        """Is this fused op's every written window already covered
        (overwritten before any read happens later in execution
        order)?  Only :func:`op_removable` ops qualify."""
        return op_removable(op) and all(
            self._is_covered(run.conts[s], off, n, full)
            for (s, off, n, full) in op_writes(op))

    def visit_op(self, run, op) -> None:
        """Fold a KEPT fused op into the walk: reads reset their
        containers; writes extend coverage only for containers the op
        does not read (the mask-preserve passthrough argument)."""
        rid = {id(run.conts[s]) for s in op_reads(op)}
        for s in op_reads(op):
            self._cov.pop(id(run.conts[s]), None)
        for (s, off, n, full) in op_writes(op):
            c = run.conts[s]
            if id(c) in rid:
                continue
            if full:
                self._cover(c, 0, len(c), True)
            else:
                self._cover(c, off, off + n, False)
