"""Debug printers: ``print_range`` / ``print_matrix`` / ``range_details``
(counterpart of ``dr_tpu/utils/debug.py``; reference
``shp/util.hpp:138-222``): readable dumps of a distributed range's values
and of each segment's placement (rank, origin, size, device)."""

from __future__ import annotations

import sys

import numpy as np

from ..core.vocabulary import local, rank, segments

__all__ = ["print_range", "print_matrix", "range_details"]


def range_details(r, name: str = "range", file=None) -> str:
    """Per-segment placement summary (shp/util.hpp:186-205)."""
    out = [f"{name}: n={len(r)}"]
    try:
        segs = segments(r)
    except TypeError:
        segs = []
    for i, s in enumerate(segs):
        origin = getattr(s, "begin", None)
        origin = "" if origin is None else f" origin={origin}"
        loc = local(s)
        if isinstance(loc, tuple):  # a zip segment: its first component
            loc = loc[0]
        device = getattr(loc, "device", None)
        dev = "" if device is None else f" device={device}"
        out.append(f"  segment {i}: rank={rank(s)} size={len(s)}"
                   f"{origin}{dev}")
    text = "\n".join(out)
    print(text, file=file or sys.stdout)
    return text


def print_range(r, name: str = "range", limit: int = 64, file=None) -> str:
    """Values and segmentation (shp/util.hpp:138-160)."""
    vals = np.asarray(r.materialize() if hasattr(r, "materialize")
                      else np.asarray(r))
    shown = np.array2string(vals[:limit], threshold=limit)
    suffix = " ..." if vals.size > limit else ""
    text = f"{name}: {shown}{suffix}"
    print(text, file=file or sys.stdout)
    range_details(r, name, file=file)
    return text


def print_matrix(m, name: str = "matrix", limit: int = 8, file=None) -> str:
    """A 2-D dump with the tile grid (shp/util.hpp:162-184)."""
    vals = np.asarray(m.materialize())
    shown = np.array2string(vals[:limit, :limit], threshold=limit * limit)
    text = (f"{name}: shape={m.shape} grid={getattr(m, 'grid_shape', '?')}"
            f"\n{shown}")
    print(text, file=file or sys.stdout)
    return text
