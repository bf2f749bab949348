"""Elementwise distributed algorithms: fill / iota / copy / copy_async /
for_each / transform / to_numpy (counterpart of
``dr_tpu/algorithms/elementwise.py``; reference
``mhp/algorithms/cpu_algorithms.hpp``).

Aligned fast path: when every operand shares the output's layout and
window offset, each rank computes the op on its own rows and writes the
window's column range of its output row — no communication.  Otherwise
the operands are evaluated as logical tensors and spliced into the
output window.

Inside ``dt.deferred()`` (``plan/``) the aligned forms record into the
active plan instead of running (``record_generator`` /
``record_transform`` / ``record_zip_foreach`` / ``record_splice``); the
recorded ops run the same row functions (``_fill_rows``, ``_iota_rows``,
``_transform_rows``, ``_zip_foreach_rows``, ``_write_window_rows``) at
flush, so a flushed run has the eager sequence's bits.  The unaligned
routes flush the plan first (``Plan.nonfusible``).

In a multi-process runtime every row function skips the rows another
process owns (None entries): each process writes its own ranks, and a
logical window read (:func:`_window_values`) gathers the others' cells.

A float written into an integer container by a transform, a copy
between containers or an ``iota`` converts as XLA's convert does
(``_common.saturating_cast``: NaN to 0, clamped to the dtype's range);
a ``fill`` value is checked as the JAX package's ``jnp.asarray`` checks
it (:func:`_fill_value`), and a copy from a host array keeps torch's
cast, which is NumPy's.

``_prog_cache`` is the algorithm layer's shared dispatch cache (the JAX
package's program cache, a ``utils/spmd_guard.TappedCache``): every
algorithm looks it up once per dispatch with the JAX package's key, so
its dispatches land on the ``spmd_guard`` trace.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ._common import layout_geometry, saturating_cast, window_cols
from ..containers.distributed_vector import (_as_tensor,
                                             distributed_vector)
from ..core.pinning import pinned_id
from ..parallel import collectives
from ..utils.spmd_guard import TappedCache, dtype_name
from ..views import views as _v

__all__ = ["fill", "iota", "copy", "copy_async", "for_each", "transform",
           "to_numpy"]


#: the algorithm layer's shared dispatch cache
_prog_cache: dict = TappedCache()

#: a user callable's key: its pinned identity
_op_key = pinned_id


def _plan_active():
    """The plan recording on this thread, or None (``plan/``).  Lazy
    import: the plan module builds on this one."""
    from ..plan import active
    return active()


def _traced_op_key(op):
    """A chain op's key: a ``BoundOp`` keys on its op and its scalar
    count, as in the JAX package's specialized programs."""
    if isinstance(op, _v.BoundOp):
        return ("bnd", pinned_id(op.op), len(op.scalars))
    return pinned_id(op)


class _Chain:
    """A container, a logical window ``[off, off + n)`` over it and the
    elementwise op stack a view pipeline applies on top."""

    __slots__ = ("cont", "off", "n", "ops")

    def __init__(self, cont, off, n, ops):
        self.cont = cont
        self.off = off
        self.n = n
        self.ops = tuple(ops)

    @property
    def key(self):
        return (pinned_id(self.cont.runtime), self.cont.layout,
                self.off, self.n, tuple(_traced_op_key(o) for o in self.ops))


def _resolve(r) -> Optional[Tuple[_Chain, ...]]:
    """Resolve ``r`` into per-leaf chains over containers, or None."""
    if isinstance(r, distributed_vector):
        return (_Chain(r, 0, len(r), ()),)
    if isinstance(r, _v.subrange):
        inner = _resolve(r.base)
        if inner is None:
            return None
        return tuple(_Chain(c.cont, c.off + r.start, len(r), c.ops)
                     for c in inner)
    if isinstance(r, _v.transform):
        inner = _resolve(r.base)
        if inner is None or len(inner) != 1:
            return None  # transform-over-zip: the caller fuses the op
        c = inner[0]
        return (_Chain(c.cont, c.off, c.n, c.ops + (r.op,)),)
    if isinstance(r, _v.zip_view):
        chains = []
        for comp in r.components:
            inner = _resolve(comp)
            if inner is None or len(inner) != 1:
                return None
            chains.append(inner[0])
        n = len(r)
        return tuple(_Chain(c.cont, c.off, n, c.ops) for c in chains)
    return None


def _apply_ops(v, ops):
    for o in ops:
        v = o(v)
    return v


def _chain_scalars(chains):
    """The ``BoundOp`` scalars of every chain op, chain by chain in op
    order: the order :func:`_apply_chain_ops` draws them in."""
    return [s for c in chains for o in c.ops if isinstance(o, _v.BoundOp)
            for s in o.scalars]


def _apply_chain_ops(v, ops, sc_iter):
    """Apply a chain's ops, each ``BoundOp`` taking its scalars from
    ``sc_iter`` (what :func:`_apply_ops` does with the bound ones)."""
    for o in ops:
        if isinstance(o, _v.BoundOp):
            v = o.op(v, *[next(sc_iter) for _ in o.scalars])
        else:
            v = o(v)
    return v


def _fast_aligned(ins, out: _Chain) -> bool:
    """Same runtime, layout and window offset: segment lists pairwise
    equal (the ``mhp::aligned`` condition)."""
    return all(c.cont.layout == out.cont.layout and c.off == out.off
               and c.cont.runtime is out.cont.runtime for c in ins)


def _out_chain(out) -> _Chain:
    res = _resolve(out)
    if res is None or len(res) != 1 or res[0].ops:
        raise TypeError(
            "output must be a distributed_vector or a subrange view over one")
    return res[0]


def _write_window(out_chain: _Chain, values, saturate=False) -> None:
    """Splice a logical tensor into the output window (``saturate``: a
    float into integer rows converts as XLA's convert does)."""
    _write_window_rows(out_chain.cont._rows, out_chain.cont.layout,
                       out_chain.off, out_chain.n, _as_tensor(values),
                       saturate)


def _write_window_rows(rows, layout, off, n, values, saturate=False) -> None:
    """:func:`_write_window` over rank rows of ``layout``."""
    _, _, prev, _, _, starts, _ = layout_geometry(layout)
    for r, row in enumerate(rows):
        c0, c1 = window_cols(layout, off, n, r)
        if c0 == c1 or row is None:
            continue
        lo = int(starts[r]) + c0 - prev - off
        vals = values[lo:lo + c1 - c0].to(row.device)
        row[0, c0:c1] = saturating_cast(vals, row.dtype) if saturate \
            else vals.to(row.dtype)


def _window_values(rows, layout, off, n, dtype) -> torch.Tensor:
    """The logical window ``[off, off + n)`` of rank rows as one tensor on
    the home device (what ``to_array`` of a window gives): the first
    present row's device, every process's cells gathered."""
    dev = collectives.present(rows).device
    parts, live = [], []
    for r, row in enumerate(rows):
        c0, c1 = window_cols(layout, off, n, r)
        if c0 < c1:
            live.append(r)
        parts.append(None if row is None else row[0, c0:c1])
    if not live:
        return torch.zeros((0,), dtype=dtype, device=dev)
    return torch.cat(collectives.gather_ranks(parts, dev, live))


def _fill_value(value, dtype):
    """A Python (or numpy) scalar ``fill`` value as the JAX package's
    ``jnp.asarray(value, dtype)`` takes it into an integer dtype: NaN
    raises ``ValueError``; a value whose truncation toward zero lies
    outside the dtype's range raises ``OverflowError``, even for an
    empty window; a float converts by truncation.  Other values pass
    unchanged."""
    if dtype.is_floating_point or dtype == torch.bool or \
            isinstance(value, (bool, np.bool_)) or \
            not isinstance(value, (int, float, np.integer, np.floating)):
        return value
    info = torch.iinfo(dtype)
    if isinstance(value, (float, np.floating)):
        if np.isnan(value):
            raise ValueError(f"cannot fill a {dtype} range with NaN")
        if np.isinf(value):
            raise OverflowError(f"cannot fill a {dtype} range with "
                                f"{value}")
    whole = int(value)  # a float truncates toward zero
    if not info.min <= whole <= info.max:
        raise OverflowError(f"fill value {value!r} is out of bounds for "
                            f"{dtype}")
    return whole


def _fill_rows(rows, layout, off, n, value) -> None:
    for rk, row in enumerate(rows):
        if row is None:
            continue
        c0, c1 = window_cols(layout, off, n, rk)
        row[0, c0:c1] = value


def _iota_rows(rows, layout, off, n, start) -> None:
    """Element i of the window gets ``start + i``.  Float64 rows, and
    integer rows with a non-int start, add in float64, so they hold
    every value up to 2^53 exactly (into integer rows the sum converts
    as XLA's convert does, saturating); other rows keep torch's
    promotion (a float start adds in float32, as the JAX package does
    without x64)."""
    _, _, prev, _, _, starts, _ = layout_geometry(layout)
    shift = start - off
    for rk, row in enumerate(rows):
        c0, c1 = window_cols(layout, off, n, rk)
        if c0 < c1 and row is not None:
            g0 = int(starts[rk]) + c0 - prev
            gid = torch.arange(g0, g0 + c1 - c0, device=row.device)
            if row.dtype == torch.float64 or (
                    not row.dtype.is_floating_point
                    and not isinstance(shift, int)):
                gid = gid.to(torch.float64)
            row[0, c0:c1] = saturating_cast(gid + shift, row.dtype)


def _transform_rows(out_rows, in_rows, in_ops, layout, off, n, op,
                    scalars, chain_sc=()) -> None:
    """The aligned transform over rank rows: each rank applies ``op`` to
    its window columns of every input (chain ops first, ``BoundOp``
    scalars from ``chain_sc``) and writes its output columns."""
    for rk, row in enumerate(out_rows):
        c0, c1 = window_cols(layout, off, n, rk)
        if c0 == c1 or row is None:
            continue
        sc = iter(chain_sc)
        vals = [_apply_chain_ops(rows[rk][:, c0:c1], ops, sc)
                for rows, ops in zip(in_rows, in_ops)]
        res = op(*vals, *scalars)
        row[:, c0:c1] = saturating_cast(torch.broadcast_to(
            torch.as_tensor(res, device=row.device), (1, c1 - c0)),
            row.dtype)


def _wins(chains) -> tuple:
    """The ``(layout, off, n, dtype)`` window of each chain."""
    return tuple((c.cont.layout, c.off, c.n, c.cont.dtype) for c in chains)


def _zip_foreach_rows(in_rows, in_wins, out_rows, out_wins, fn,
                      scalars) -> None:
    """for_each over a zip of windows (``(layout, off, n, dtype)`` each):
    ``fn`` over the logical windows, its results spliced back."""
    arrs = [_window_values(rows, *w) for rows, w in zip(in_rows, in_wins)]
    n = min(w[2] for w in in_wins)
    vals = fn(*[a[:n] for a in arrs], *scalars)
    if not isinstance(vals, tuple):
        raise TypeError("for_each over zip: fn must return a tuple")
    for rows, (layout, off, wn, _dt), v in zip(out_rows, out_wins, vals):
        _write_window_rows(rows, layout, off, wn, _as_tensor(v), True)


def _gen_tap(out: _Chain, kind: str) -> None:
    _prog_cache.tap(("gen", kind, out.cont.layout, out.off, out.n,
                     dtype_name(out.cont.dtype)))


def fill(r, value) -> None:
    """Collective fill (cpu_algorithms.hpp:14-28)."""
    out = _out_chain(r)
    value = _fill_value(value, out.cont.dtype)
    p = _plan_active()
    if p is not None:
        p.record_generator(out, "fill", value)
        return
    _gen_tap(out, "fill")
    _fill_rows(out.cont._rows, out.cont.layout, out.off, out.n, value)


def iota(r, start=0) -> None:
    """Collective iota (cpu_algorithms.hpp:83-94): element i of the
    window holds ``start + i``."""
    out = _out_chain(r)
    p = _plan_active()
    if p is not None:
        p.record_generator(out, "iota", start)
        return
    _gen_tap(out, "iota")
    _iota_rows(out.cont._rows, out.cont.layout, out.off, out.n, start)


def transform(in_r, out, op: Callable, *scalars) -> None:
    """Collective transform (cpu_algorithms.hpp:148-167).  ``op`` works
    on tensors; over a zip input it receives one argument per component;
    trailing ``*scalars`` are appended to its arguments."""
    out_chain = _out_chain(out)
    ins = _resolve(in_r)
    n = len(in_r)
    assert out_chain.n >= n, "output window too small"
    if n < out_chain.n:
        out_chain = _Chain(out_chain.cont, out_chain.off, n, ())
    if ins is not None and _fast_aligned(ins, out_chain):
        p = _plan_active()
        if p is not None:
            p.record_transform(ins, out_chain, op, scalars)
            return
        cont = out_chain.cont
        nchain = sum(len(o.scalars) for c in ins for o in c.ops
                     if isinstance(o, _v.BoundOp))
        _prog_cache.tap((
            "ew", cont.layout, out_chain.off, out_chain.n,
            tuple(c.cont.layout for c in ins),
            tuple(tuple(_traced_op_key(o) for o in c.ops) for c in ins),
            _op_key(op), False, tuple(c.cont is cont for c in ins),
            nchain + len(scalars), dtype_name(cont.dtype)))
        _transform_rows(cont._rows, [c.cont._rows for c in ins],
                        [c.ops for c in ins], cont.layout, out_chain.off,
                        out_chain.n, op, scalars, _chain_scalars(ins))
        return
    p = _plan_active()
    if p is not None:
        p.nonfusible("transform (unaligned/materialize route)")
    arr = in_r.to_array() if hasattr(in_r, "to_array") else _as_tensor(in_r)
    vals = op(*arr, *scalars) if isinstance(arr, tuple) \
        else op(arr, *scalars)
    _write_window(out_chain, vals[:out_chain.n], saturate=True)


def _identity(x):
    return x


def copy(src, dst) -> None:
    """Collective copy (cpu_algorithms.hpp:36-54); host arrays on either
    side, like the shp host<->device overloads."""
    if isinstance(src, (np.ndarray, torch.Tensor, list, tuple)):
        out = _out_chain(dst)
        p = _plan_active()
        if p is not None:
            p.record_splice(out, _as_tensor(src))
            return
        _write_window(out, _as_tensor(src))
        return
    if isinstance(dst, np.ndarray):
        vals = to_numpy(src)
        dst[:len(vals)] = vals
        return
    transform(src, dst, _identity)


class _Event:
    """The handle :func:`copy_async` returns: ``wait()`` waits for the
    copy (the destination's ``block_until_ready``, a fence of its
    ranks' devices)."""

    def __init__(self, cont):
        self._cont = cont

    def wait(self) -> None:
        if hasattr(self._cont, "block_until_ready"):
            self._cont.block_until_ready()


def copy_async(src, dst) -> _Event:
    """:func:`copy` without waiting (``shp::copy_async``,
    shp/copy.hpp:116-138): the copies are queued on the devices' streams
    and the returned event's ``wait()`` joins them."""
    copy(src, dst)
    base = dst
    while base is not None and not hasattr(base, "block_until_ready"):
        base = getattr(base, "base", None)
    return _Event(base)


def for_each(r, fn: Callable, *scalars) -> None:
    """Collective in-place for_each: ``fn`` returns the new value(s) —
    a tuple, one per component, over a zip range."""
    if isinstance(r, _v.zip_view):
        outs = [_out_chain(c) for c in r.components]
        ins = _resolve(r)
        if ins is not None and all(_fast_aligned(ins, oc) for oc in outs):
            p = _plan_active()
            if p is not None:
                p.record_zip_foreach(ins, outs, fn, scalars)
                return
            conts = [oc.cont for oc in outs]
            alias = tuple(next((i for i, c in enumerate(conts)
                                if c is ch.cont), -1) for ch in ins)
            _prog_cache.tap(("zfe", tuple(c.key for c in ins),
                             tuple(o.key for o in outs), _op_key(fn),
                             alias, len(scalars)))
            _zip_foreach_rows([c.cont._rows for c in ins], _wins(ins),
                              [c._rows for c in conts], _wins(outs), fn,
                              scalars)
            return
        p = _plan_active()
        if p is not None:
            p.nonfusible("for_each (misaligned zip route)")
        arrs = r.to_array()
        vals = fn(*arrs, *scalars)
        if not isinstance(vals, tuple):
            raise TypeError("for_each over zip: fn must return a tuple")
        for oc, v in zip(outs, vals):
            _write_window(oc, v, saturate=True)
        return
    transform(r, r, fn, *scalars)


def to_numpy(r) -> np.ndarray:
    """Materialize a distributed range on the host (test-oracle path),
    on every process (``utils/host.to_host``)."""
    from ..utils.host import to_host
    return to_host(r)
