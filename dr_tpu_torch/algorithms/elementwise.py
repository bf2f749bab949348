"""Elementwise distributed algorithms: fill / iota / copy / for_each /
transform / to_numpy (counterpart of
``dr_tpu/algorithms/elementwise.py``; reference
``mhp/algorithms/cpu_algorithms.hpp``).

Aligned fast path: when every operand shares the output's layout and
window offset, each rank computes the op on its own rows and writes the
window's column range of its output row — no communication.  Otherwise
the operands are evaluated as logical tensors and spliced into the
output window.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ._common import layout_geometry, window_cols
from ..containers.distributed_vector import (_as_tensor, _host_numpy,
                                             distributed_vector)
from ..views import views as _v

__all__ = ["fill", "iota", "copy", "for_each", "transform", "to_numpy"]


class _Chain:
    """A container, a logical window ``[off, off + n)`` over it and the
    elementwise op stack a view pipeline applies on top."""

    __slots__ = ("cont", "off", "n", "ops")

    def __init__(self, cont, off, n, ops):
        self.cont = cont
        self.off = off
        self.n = n
        self.ops = tuple(ops)


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


def _rank_cols(chain: _Chain, r: int):
    return window_cols(chain.cont.layout, chain.off, chain.n, r)


def _write_window(out_chain: _Chain, values) -> None:
    """Splice a logical tensor into the output window."""
    cont = out_chain.cont
    values = _as_tensor(values)
    _, _, prev, _, _, starts, _ = layout_geometry(cont.layout)
    for r, row in enumerate(cont._rows):
        c0, c1 = _rank_cols(out_chain, r)
        if c0 == c1:
            continue
        lo = int(starts[r]) + c0 - prev - out_chain.off
        row[0, c0:c1] = values[lo:lo + c1 - c0].to(row.device, row.dtype)


def _gid(cont, r, c0, c1, device):
    """Global logical index of row columns [c0, c1) of rank r."""
    _, _, prev, _, _, starts, _ = layout_geometry(cont.layout)
    g0 = int(starts[r]) + c0 - prev
    return torch.arange(g0, g0 + c1 - c0, device=device)


def fill(r, value) -> None:
    """Collective fill (cpu_algorithms.hpp:14-28)."""
    out = _out_chain(r)
    for rk, row in enumerate(out.cont._rows):
        c0, c1 = _rank_cols(out, rk)
        row[0, c0:c1] = value


def iota(r, start=0) -> None:
    """Collective iota (cpu_algorithms.hpp:83-94): element i of the
    window holds ``start + i``."""
    out = _out_chain(r)
    for rk, row in enumerate(out.cont._rows):
        c0, c1 = _rank_cols(out, rk)
        if c0 < c1:
            gid = _gid(out.cont, rk, c0, c1, row.device)
            row[0, c0:c1] = (gid + (start - out.off)).to(row.dtype)


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
        rows_in = [[c.cont._rows[rk] for c in ins]
                   for rk in range(out_chain.cont.nshards)]
        for rk, row in enumerate(out_chain.cont._rows):
            c0, c1 = _rank_cols(out_chain, rk)
            if c0 == c1:
                continue
            vals = [_apply_ops(x[:, c0:c1], c.ops)
                    for x, c in zip(rows_in[rk], ins)]
            res = op(*vals, *scalars)
            row[:, c0:c1] = torch.broadcast_to(
                torch.as_tensor(res, device=row.device),
                (1, c1 - c0)).to(row.dtype)
        return
    arr = in_r.to_array() if hasattr(in_r, "to_array") else _as_tensor(in_r)
    vals = op(*arr, *scalars) if isinstance(arr, tuple) \
        else op(arr, *scalars)
    _write_window(out_chain, vals[:out_chain.n])


def _identity(x):
    return x


def copy(src, dst) -> None:
    """Collective copy (cpu_algorithms.hpp:36-54); host arrays on either
    side, like the shp host<->device overloads."""
    if isinstance(src, (np.ndarray, torch.Tensor, list, tuple)):
        _write_window(_out_chain(dst), _as_tensor(src))
        return
    if isinstance(dst, np.ndarray):
        vals = to_numpy(src)
        dst[:len(vals)] = vals
        return
    transform(src, dst, _identity)


def for_each(r, fn: Callable, *scalars) -> None:
    """Collective in-place for_each: ``fn`` returns the new value(s) —
    a tuple, one per component, over a zip range."""
    if isinstance(r, _v.zip_view):
        outs = [_out_chain(c) for c in r.components]
        arrs = r.to_array()
        vals = fn(*arrs, *scalars)
        if not isinstance(vals, tuple):
            raise TypeError("for_each over zip: fn must return a tuple")
        for oc, v in zip(outs, vals):
            _write_window(oc, v)
        return
    transform(r, r, fn, *scalars)


def to_numpy(r) -> np.ndarray:
    """Materialize a distributed range on the host (test-oracle path)."""
    if hasattr(r, "to_array"):
        arr = r.to_array()
        if isinstance(arr, tuple):
            return tuple(_host_numpy(a) for a in arr)
        return _host_numpy(arr)
    return np.asarray(r)
