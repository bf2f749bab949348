"""Distributed prefix scans: ``inclusive_scan`` / ``exclusive_scan`` /
``inclusive_scan_n`` (counterpart of ``dr_tpu/algorithms/scan.py``;
reference ``shp/algorithms/inclusive_scan.hpp:25-148``).

Per rank: the owned (identity-masked) cells are scanned locally, the
rank totals are gathered, and each rank folds the totals of the ranks
before it into its carry.  Every add-scan of f32/bf16/f16 input, of any
length and layout, goes through K4 (``ops/scan_pallas.chunked_cumsum``)
with the carry seeding the kernel, so the scan is the only pass over the
data; other monoids and dtypes scan with torch's cumulative ops and
fold the carry afterwards.

An op that is none of add/mul/min/max (an identityless custom fold,
associative as ``std::inclusive_scan`` requires) and a scan whose
output window sits elsewhere than its input window (another offset,
layout or runtime) run in window coordinates: each rank scans its slice
of the input window (:func:`_prefix_scan` for a custom op, K4 for an
f32/bf16/f16 add-scan), folds the totals of the ranks before it that own
cells, and the scanned slices are copied into the ranks that own the
output window (the realign of ``dr_tpu/algorithms/scan.py:425-540``).

In a multi-process runtime each process scans its own ranks (K4 on its
rows); the rank totals and the exclusive scan's last cells cross the
process boundary through the collectives, and every carry is folded in
rank order on the home device, as with one controller, so each rank's
cells keep the single controller's bits.  The realign moves each
scanned slice with ``collectives.route``.

Inside ``dt.deferred()`` both scans record OPAQUE (``Plan.record_opaque``
with :func:`_scan_footprint`): they run through this eager path at the
flush, in record order, so an f32 add-scan launches K4 there.
``inclusive_scan_n`` reads the rows directly and flushes first.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import obs as _obs
from ._common import (MONOID_COMBINE, f32_accumulable, identity_for,
                      uniform_layout, window_cols, window_geometry,
                      working_geometry)
from ..ops import scan_pallas
from .elementwise import _Chain, _apply_ops, _out_chain, _resolve, \
    _write_window
from .reduce import _classify_op
from .elementwise import (_op_key, _plan_active, _prog_cache,
                          _traced_op_key)
from ..core.pinning import pinned_id
from ..utils.spmd_guard import dtype_name
from ..containers.distributed_vector import _as_tensor
from ..parallel import collectives

__all__ = ["inclusive_scan", "exclusive_scan", "inclusive_scan_n"]


def _takes_k4(kind, dtype) -> bool:
    return kind == "add" and f32_accumulable(dtype)


def _local_scan(kind, x):
    if _takes_k4(kind, x.dtype):
        return scan_pallas.chunked_cumsum(x.contiguous())
    if kind == "add":
        return torch.cumsum(x, 0, dtype=x.dtype)
    if kind == "mul":
        return torch.cumprod(x, 0, dtype=x.dtype)
    return (torch.cummin(x, 0) if kind == "min" else torch.cummax(x, 0))[0]


def _prefix_scan(op: Callable, x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``x`` under an associative ``op`` over tensors:
    ``log2(len(x))`` rounds of ``y[i] = op(y[i - d], y[i])`` with the
    earlier operand on the left, so a non-commutative op keeps its
    order."""
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], op(x[:-d], x[d:])])
        d *= 2
    return x


def _combine_of(kind, op):
    return MONOID_COMBINE[kind] if kind is not None else op


def _fill(x, kind, dtype):
    return torch.full((1,), identity_for(kind, dtype), dtype=dtype,
                      device=x.device)


def _scan_rows(cont, rows, kind, exclusive, dtype, ops=(), window=None,
               keep_rows=None):
    """One distributed scan over ``rows`` (the input container's layout);
    returns the new output rows.  Add-scans of f32/bf16/f16 cells take
    K4 (its plain version on CPU tensors).  ``window=(off, wn)`` scans
    only that logical window and blends it into ``keep_rows``; without a
    window the output rows are rebuilt whole (ghost cells zero, as in the
    JAX program)."""
    layout = cont.layout
    nshards, S, cap, prev, nxt, n, starts, sizes = working_geometry(layout)
    devs = cont.runtime.devices
    home = cont.runtime.home
    exact = (bool((sizes == S).all()) and nshards * S == n
             and window is None)
    off, wn = window if window is not None else (0, n)
    ident = identity_for(kind, collectives.present(rows).dtype)
    xs = [None] * nshards  # None: a rank another process scans
    for r, row in enumerate(rows):
        if row is None:
            continue
        x = _apply_ops(row[0, prev:prev + S], ops)
        if not exact:
            a, b = window_cols(layout, off, wn, r)
            x = x.clone()
            x[:a - prev] = ident
            x[b - prev:] = ident
        xs[r] = x
    if _takes_k4(kind, collectives.present(xs).dtype):
        if nshards == 1:
            scanned = [scan_pallas.chunked_cumsum(xs[0])]
        else:
            # f32 totals whatever the input dtype: the kernel's carry
            # seed is f32, and a bf16-rounded carry would poison every
            # later rank's prefixes
            totals = collectives.all_gather(
                [None if x is None else x.sum(dtype=torch.float32)
                 for x in xs], home)
            scanned = [None if x is None else scan_pallas.chunked_cumsum(
                x, carry=totals[:r].sum().to(x.device))
                for r, x in enumerate(xs)]
        if exclusive:
            lasts = collectives.ring_shift(
                [None if s is None else s[-1:] for s in scanned], devs, +1,
                False, like=((1,), collectives.present(scanned).dtype))
            scanned = [None if s is None else
                       torch.cat([_fill(s, kind, s.dtype) if r == 0
                                  else lasts[r], s[:-1]])
                       for r, s in enumerate(scanned)]
    else:
        combine = MONOID_COMBINE[kind]
        local = [None if x is None else _local_scan(kind, x) for x in xs]
        totals = collectives.gather_ranks(
            [None if lc is None else lc[-1] for lc in local], home)
        scanned = []
        for r, lc in enumerate(local):
            if lc is None:
                scanned.append(None)
                continue
            carry = None
            for t in totals[:r]:
                t = t.to(lc.device)
                carry = t if carry is None else combine(carry, t)
            if exclusive:
                lc = torch.cat([_fill(lc, kind, lc.dtype), lc[:-1]])
            scanned.append(lc if carry is None else combine(carry, lc))
    out = []
    with _obs.span("rows.copy", cat="rows"):
        for r, s in enumerate(scanned):
            if s is None:
                out.append(None)
                continue
            s = s.to(dtype)
            if window is not None:
                a, b = window_cols(layout, off, wn, r)
                row = keep_rows[r].clone()
                row[0, a:b] = s[a - prev:b - prev]
            elif prev == 0 and nxt == 0 and cap == S:
                row = s[None]
            else:
                row = torch.zeros((1, prev + cap + nxt), dtype=dtype,
                                  device=s.device)
                row[0, prev:prev + S] = s
            out.append(row)
    return out


def _window_scan(c, kind, op, exclusive, dtype):
    """Scan one chain's window in window coordinates; returns each rank's
    scanned slice (empty where the rank owns no cell of the window), in
    ``dtype``.  Add-scans of f32/bf16/f16 cells take K4, seeded with the
    f32 sum of the earlier ranks' totals; other ops scan locally and fold
    the earlier nonempty ranks' totals into the slice."""
    cont = c.cont
    home = cont.runtime.home
    xs = [None] * cont.nshards  # None: a rank another process scans
    live = []
    for r in range(cont.nshards):
        a, b = window_cols(cont.layout, c.off, c.n, r)
        if a < b:
            live.append(r)
        row = cont._rows[r]
        if row is not None:
            xs[r] = _apply_ops(row[0, a:b], c.ops).contiguous()
    out = [None if x is None else x.to(dtype) for x in xs]
    if kind is not None and _takes_k4(kind, collectives.present(xs).dtype):
        totals = collectives.gather_ranks(
            [None if x is None else x.sum(dtype=torch.float32) for x in xs],
            home, live)
        carry = torch.zeros((), dtype=torch.float32, device=home)
        for r, total in zip(live, totals):
            x = xs[r]
            if x is not None:
                s = scan_pallas.chunked_cumsum(x, carry=carry.to(x.device))
                if exclusive:
                    s = torch.cat([carry.to(x.device, s.dtype)[None],
                                   s[:-1]])
                out[r] = s.to(dtype)
            carry = carry + total
        return out
    combine = _combine_of(kind, op)
    local = [None] * cont.nshards
    for r in live:
        if xs[r] is not None:
            local[r] = (_local_scan(kind, xs[r]) if kind is not None
                        else _prefix_scan(op, xs[r]))
    totals = collectives.gather_ranks(
        [None if lc is None else lc[-1] for lc in local], home, live)
    carry = None
    for r, t in zip(live, totals):
        x, lc = xs[r], local[r]
        if x is not None:
            s = lc if carry is None else combine(carry.to(x.device), lc)
            if exclusive:
                if carry is not None:
                    first = carry.to(x.device, s.dtype)[None]
                elif kind is not None:
                    first = _fill(x, kind, s.dtype)
                else:
                    # no identity: a zero that exclusive_scan's init
                    # replaces
                    first = torch.zeros((1,), dtype=s.dtype,
                                        device=x.device)
                s = torch.cat([first, s[:-1]])
            out[r] = s.to(dtype)
        carry = t if carry is None else combine(carry, t)
    return out


def _realign(c, out_chain, slices) -> None:
    """Copy scanned window slices (the input window's geometry) into the
    ranks that own the same window positions of the output window."""
    _, _, _, _, _, _, vin, win, _ = window_geometry(c.cont.layout, c.off,
                                                    c.n)
    oc = out_chain.cont
    _, _, _, _, _, _, vout, wout, _ = window_geometry(oc.layout,
                                                      out_chain.off, c.n)
    moves, dsts = [], []
    for q in range(oc.nshards):
        lo_q, hi_q = int(vout[q]), int(vout[q] + wout[q])
        for r in range(len(slices)):
            lo, hi = max(lo_q, int(vin[r])), min(hi_q, int(vin[r] + win[r]))
            if lo < hi:
                a, b = lo - int(vin[r]), hi - int(vin[r])
                moves.append((r, q, lambda r=r, a=a, b=b: slices[r][a:b]))
                dsts.append(q)
    pieces = collectives.route(moves, oc.runtime.devices)
    for q, row in enumerate(oc._rows):
        if row is None or not wout[q]:
            continue
        a, b = window_cols(oc.layout, out_chain.off, c.n, q)
        row[0, a:b] = torch.cat([pc for pc, d in zip(pieces, dsts)
                                 if d == q]).to(row.dtype)


def _scan(in_r, out, op, init, exclusive):
    kind = _classify_op(op)
    out_chain = _out_chain(out)
    ins = _resolve(in_r)
    if ins is not None and len(ins) == 1 and ins[0].n != out_chain.n:
        if out_chain.n < ins[0].n:
            raise ValueError(
                f"scan output window too small ({out_chain.n} < "
                f"{ins[0].n})")
        out_chain = _Chain(out_chain.cont, out_chain.off, ins[0].n, ())
    single = ins is not None and len(ins) == 1
    c = ins[0] if single else None
    if single and c.n == 0:
        return out
    same = (single and kind is not None
            and c.cont.runtime is out_chain.cont.runtime
            and c.cont.layout == out_chain.cont.layout
            and c.off == out_chain.off)
    if single:
        dtype = out_chain.cont.dtype
        _prog_cache.tap((
            "scan", pinned_id(c.cont.runtime), c.cont.layout, kind,
            _op_key(op) if kind is None else None, exclusive,
            dtype_name(dtype), _takes_k4(kind, dtype), (c.off, c.n),
            tuple(_traced_op_key(f) for f in c.ops),
            None if same else out_chain.cont.layout,
            None if same else (out_chain.off, out_chain.n)))
    if same:
        full = (c.off == 0 and c.n == len(c.cont)
                and out_chain.n == len(out_chain.cont))
        out_chain.cont._rows = _scan_rows(
            c.cont, c.cont._rows, kind, exclusive, out_chain.cont.dtype,
            c.ops, None if full else (c.off, c.n), out_chain.cont._rows)
    elif single:
        _realign(c, out_chain, _window_scan(c, kind, op, exclusive,
                                            out_chain.cont.dtype))
    else:
        arr = in_r.to_array() if hasattr(in_r, "to_array") \
            else _as_tensor(in_r)
        if kind is None:
            scanned = _prefix_scan(op, arr)
            first = torch.zeros((1,), dtype=arr.dtype, device=arr.device)
        else:
            scanned = _local_scan(kind, arr)
            first = _fill(arr, kind, arr.dtype)
        if exclusive:
            scanned = torch.cat([first, scanned[:-1]])
        _write_window(out_chain, scanned[:out_chain.n])
    if init is not None:
        _scan_apply_init(out, init, op, set_first=False)
    return out


def _scan_footprint(in_r, out):
    """The optimizer footprint of a recorded scan: the input chains'
    containers are read, the out container is read and window-written.
    A shape that does not resolve is a barrier (None, None)."""
    try:
        ins = _resolve(in_r)
        oc = _out_chain(out)
    except Exception:
        return None, None
    if ins is None:
        return None, None
    reads = {id(c.cont): c.cont for c in ins}
    reads[id(oc.cont)] = oc.cont
    return tuple(reads.values()), ((oc.cont, False),)


def inclusive_scan(in_r, out, op: Callable = None, init=None):
    """Distributed inclusive prefix scan; ``init`` folds into every
    prefix (std::inclusive_scan)."""
    p = _plan_active()
    if p is not None:
        reads, writes = _scan_footprint(in_r, out)
        p.record_opaque("inclusive_scan",
                        lambda: _scan(in_r, out, op, init, exclusive=False),
                        reads=reads, writes=writes)
        return out
    return _scan(in_r, out, op, init, exclusive=False)


def exclusive_scan(in_r, out, init=0, op: Callable = None):
    """Exclusive prefix scan; position 0 takes ``init``."""
    p = _plan_active()
    if p is not None:
        reads, writes = _scan_footprint(in_r, out)
        p.record_opaque("exclusive_scan",
                        lambda: _exclusive_scan(in_r, out, init, op),
                        reads=reads, writes=writes)
        return out
    return _exclusive_scan(in_r, out, init, op)


def _exclusive_scan(in_r, out, init, op):
    out = _scan(in_r, out, op, None, exclusive=True)
    kind = _classify_op(op)
    skip = init is None or (kind == "add" and isinstance(init, (int, float))
                            and init == 0)
    if not skip:
        _scan_apply_init(out, init, op)
    return out


def inclusive_scan_n(in_v, out, iters: int):
    """``iters`` chained add-scans (each round scans the previous
    round's output): a measurement aid, not cumsum(in).  It reads the
    rows directly, so a recording plan flushes first."""
    from ..plan import flush_reads
    flush_reads("inclusive_scan_n")
    ins = _resolve(in_v)
    out_chain = _out_chain(out)
    assert (ins is not None and len(ins) == 1 and not ins[0].ops
            and ins[0].off == 0 and out_chain.off == 0
            and ins[0].cont.layout == out_chain.cont.layout
            and uniform_layout(ins[0].cont.layout)
            and ins[0].n == len(ins[0].cont)
            and out_chain.n == len(out_chain.cont)), \
        "inclusive_scan_n takes two whole uniform-layout containers"
    cont = ins[0].cont
    dtype = out_chain.cont.dtype
    _prog_cache.tap(("scan_n", pinned_id(cont.runtime), cont.layout,
                     dtype_name(dtype), int(iters), _takes_k4("add", dtype)))
    rows = cont._rows
    for _ in range(iters):
        rows = _scan_rows(cont, rows, "add", False, out_chain.cont.dtype)
    out_chain.cont._rows = rows
    return out


def _scan_apply_init(out, init, op, set_first=True):
    """Fold ``init`` into a scan result: every covered cell takes
    ``op(init, prefix)``; with ``set_first`` (the exclusive form) the
    first covered cell is set to ``init`` exactly."""
    kind = _classify_op(op)
    combine = _combine_of(kind, op)
    chain = _out_chain(out)
    cont = chain.cont
    if chain.n == 0:
        return
    nshards, S, cap, prev, nxt, n, starts, sizes = \
        working_geometry(cont.layout)
    full = chain.off == 0 and chain.n == len(cont)
    _prog_cache.tap(("scan_init", pinned_id(cont.runtime), cont.layout, kind,
                     _op_key(op) if kind is None else None,
                     dtype_name(cont.dtype),
                     None if full else (chain.off, chain.n), set_first))
    off0 = chain.off
    owner = next((i for i in range(nshards)
                  if sizes[i] > 0 and starts[i] <= off0 < starts[i] + sizes[i]),
                 0)
    col0 = prev + (off0 - int(starts[owner]))
    rows = []
    for r, row in enumerate(cont._rows):
        if row is None:  # another process folds this rank
            rows.append(None)
            continue
        iv = torch.tensor(init, dtype=cont.dtype, device=row.device)
        if full:
            folded = combine(iv, row[0, prev:prev + S]).to(cont.dtype)
            if set_first and r == owner:
                folded[col0 - prev] = iv
            if prev == 0 and nxt == 0 and cap == S:
                new = folded[None]
            else:
                new = torch.zeros_like(row)
                new[0, prev:prev + S] = folded
        else:
            a, b = window_cols(cont.layout, chain.off, chain.n, r)
            new = row.clone()
            new[0, a:b] = combine(iv, row[0, a:b]).to(cont.dtype)
            if set_first and r == owner:
                new[0, col0] = iv
        rows.append(new)
    cont._rows = rows
