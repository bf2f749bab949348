"""Shared helpers for the algorithm layer: layout and window geometry,
owned-cell column ranges, monoid tables (counterpart of
``dr_tpu/algorithms/_common.py``).  Geometry is numpy over the layout's
Python ints, so nothing here touches a device."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["layout_geometry", "working_geometry", "window_cols",
           "uniform_layout",
           "f32_accumulable", "MONOID_COMBINE", "identity_for"]


def f32_accumulable(dtype) -> bool:
    """Input dtypes the kernels may accumulate in f32 without changing
    semantics (integers and f64 keep the plain torch routes)."""
    return dtype in (torch.float32, torch.bfloat16, torch.float16)


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


MONOID_COMBINE = {
    "add": torch.add,
    "mul": torch.mul,
    "min": torch.minimum,
    "max": torch.maximum,
}


def identity_for(kind: str, dtype):
    """The monoid identity as a Python scalar of ``dtype``'s kind."""
    if kind == "add":
        return 0
    if kind == "mul":
        return 1
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min
