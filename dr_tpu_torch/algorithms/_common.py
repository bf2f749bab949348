"""Shared helpers for the algorithm layer: layout and window geometry,
owned-cell column ranges, monoid tables (counterpart of
``dr_tpu/algorithms/_common.py``).  Geometry is numpy over the layout's
Python ints; only :func:`owned_window_mask` builds tensors, on the device
it is given."""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import ordered_maximum, ordered_minimum

__all__ = ["layout_geometry", "working_geometry", "window_geometry",
           "effective_sizes", "window_cols", "owned_window_mask",
           "uniform_layout", "saturating_cast",
           "f32_accumulable", "MONOID_COMBINE", "identity_for"]


def f32_accumulable(dtype) -> bool:
    """Input dtypes the kernels may accumulate in f32 without changing
    semantics (integers and f64 keep the plain torch routes)."""
    return dtype in (torch.float32, torch.bfloat16, torch.float16)


def saturating_cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t.to(dtype)`` as XLA's convert does it for a float into an
    integer dtype: truncation toward zero, NaN to 0, and values beyond
    the dtype's range clamped to it (torch's own conversion wraps on the
    CPU).  Every other conversion is ``t.to(dtype)``."""
    if not t.is_floating_point() or dtype.is_floating_point \
            or dtype == torch.bool:
        return t.to(dtype)
    info = torch.iinfo(dtype)
    x = t.to(torch.float64)  # exact for every float dtype of a row
    hi = x >= info.max
    lo = x <= info.min
    safe = torch.where(hi | lo | torch.isnan(x), 0.0, x)
    out = safe.to(dtype)
    out = torch.where(hi, torch.full_like(out, info.max), out)
    return torch.where(lo, torch.full_like(out, info.min), out)


def uniform_layout(layout) -> bool:
    """True for the default ceil-division layout (``layout[1]`` an int)."""
    return isinstance(layout[1], int)


def layout_geometry(layout):
    """(nshards, capacity, prev, nxt, n, starts, sizes) for any layout."""
    nshards, seg, prev, nxt, n = layout
    if isinstance(seg, tuple):  # ("b", s0, s1, ...)
        sizes = np.asarray(seg[1:], dtype=np.int64)
        cap = max(int(sizes.max(initial=0)), prev, nxt, 1)
        starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    else:
        sizes = np.full(nshards, seg, dtype=np.int64)
        cap = seg
        starts = np.arange(nshards, dtype=np.int64) * seg
    return nshards, cap, prev, nxt, n, starts, sizes


def working_geometry(layout):
    """(p, S, cap, prev, nxt, n, starts, sizes) with S the widest owned
    span: slicing ``[prev, prev + S)`` of any row covers its cells."""
    p, cap, prev, nxt, n, starts, sizes = layout_geometry(layout)
    S = max(int(sizes.max(initial=0)), 1)
    return p, S, cap, prev, nxt, n, starts, sizes


def window_geometry(layout, off, wn):
    """The logical window [off, off+wn) intersected with each rank's
    owned span, as an uneven block distribution of length ``wn``:
    (p, S, cap, prev, nxt, wn, vstarts, wsize, wstart) with ``wstart``
    each rank's local offset of its window slice, ``wsize`` its width and
    ``vstarts`` the exclusive prefix of the widths."""
    p, _, cap, prev, nxt, n, starts, sizes = working_geometry(layout)
    wstart = np.clip(off - starts, 0, sizes)
    wsize = np.clip(off + wn - starts, 0, sizes) - wstart
    vstarts = np.concatenate(([0], np.cumsum(wsize)[:-1]))
    S = max(int(wsize.max(initial=0)), 1)
    return p, S, cap, prev, nxt, wn, vstarts, wsize, wstart


def effective_sizes(starts, sizes, n):
    """True per-rank valid counts: a rank whose window lies at or beyond
    ``n`` owns no cells, whatever its nominal width (``working_geometry``
    reports the nominal ``seg`` for every rank of a uniform layout).
    Window geometries are exact already; this leaves them unchanged."""
    return np.minimum(np.asarray(sizes),
                      np.clip(n - np.asarray(starts), 0, None))


def window_cols(layout, off, n, r):
    """Rank r's owned cells inside the logical window [off, off+n) as a
    column range ``(c0, c1)`` of its padded row (``c0 == c1`` when it
    owns none).  The owned-and-in-window cells of a row are always
    contiguous, so this range is the whole pad-and-mask rule: algorithms
    read and write ``row[:, c0:c1]`` and leave every other cell alone."""
    nshards, cap, prev, nxt, total_n, starts, sizes = layout_geometry(layout)
    s0 = int(starts[r])
    lo = max(s0, off)
    hi = min(s0 + int(sizes[r]), off + n, total_n)
    if hi <= lo:
        return prev, prev
    return prev + lo - s0, prev + hi - s0


def owned_window_mask(layout, off, n, r, device):
    """``(mask, gid)`` over rank r's padded row, on ``device``: ``gid`` is
    each cell's global logical index (int64), ``mask`` selects the owned
    cells inside the logical window [off, off+n) (the columns of
    :func:`window_cols`).  The per-rank form of the JAX package's
    ``(nshards, width)`` grids, for algorithms that work on whole rows."""
    _, cap, prev, nxt, _, starts, _ = layout_geometry(layout)
    c0, c1 = window_cols(layout, off, n, r)
    col = torch.arange(prev + cap + nxt, device=device)
    return (col >= c0) & (col < c1), col + (int(starts[r]) - prev)


MONOID_COMBINE = {
    "add": torch.add,
    "mul": torch.mul,
    "min": ordered_minimum,
    "max": ordered_maximum,
}


def identity_for(kind: str, dtype):
    """The monoid identity as a Python scalar of ``dtype``'s kind."""
    if kind == "add":
        return 0
    if kind == "mul":
        return 1
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    if dtype == torch.bool:
        return kind == "min"
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min
