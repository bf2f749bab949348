"""Segment-preserving views over distributed ranges (counterpart of
``dr_tpu/views/views.py``; reference ``details/segments_tools.hpp``,
``shp/zip_view.hpp``, ``views/transform.hpp``, ``mhp/views.hpp``).

Views are lazy metadata: they recompute ``segments()`` and produce
their logical value as a tensor (``to_array``); the algorithm layer
resolves a view pipeline back to its containers and runs it rank by
rank on the rows.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ..core.segment import Segment, ZipSegment
from ..core.vocabulary import local, rank, segments

__all__ = ["take", "drop", "subrange", "transform", "zip_view", "zip",
           "iota_view", "take_segments", "drop_segments", "aligned",
           "local_segments", "BoundOp"]


class BoundOp:
    """``op`` with trailing scalar arguments bound: calling it behaves
    like ``lambda *a: op(*a, *scalars)``, with op and scalars kept
    inspectable."""

    __slots__ = ("op", "scalars")

    def __init__(self, op: Callable, scalars: Sequence):
        self.op = op
        self.scalars = tuple(scalars)

    def __call__(self, *args):
        return self.op(*args, *self.scalars)


def take_segments(segs: Sequence, n: int):
    """First ``n`` elements of a segment list, trimming the cut segment."""
    out, remaining = [], n
    for s in segs:
        if remaining <= 0:
            break
        k = min(len(s), remaining)
        out.append(s[:k] if k != len(s) else s)
        remaining -= k
    return out


def drop_segments(segs: Sequence, n: int):
    """Drop the first ``n`` elements of a segment list."""
    out, todrop = [], n
    for s in segs:
        if todrop >= len(s):
            todrop -= len(s)
            continue
        out.append(s[todrop:] if todrop else s)
        todrop = 0
    return out


def _to_host(a):
    a = a.detach().cpu()
    return (a.float() if a.dtype == torch.bfloat16 else a).numpy()


class _ViewBase:
    base: Any

    def __len__(self) -> int:
        raise NotImplementedError

    def to_array(self):
        raise NotImplementedError

    def materialize(self):
        arr = self.to_array()
        if isinstance(arr, tuple):
            return tuple(_to_host(a) for a in arr)
        return _to_host(arr)

    def __iter__(self):
        m = self.materialize()
        if isinstance(m, tuple):
            return iter(builtin_zip(*m))
        return iter(m)

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            assert step == 1
            return subrange(self, start, stop)
        m = self.to_array()
        if isinstance(m, tuple):
            return tuple(a[key].item() for a in m)
        return m[key].item()


builtin_zip = zip


class subrange(_ViewBase):
    """Window [start, stop) over a distributed range."""

    def __init__(self, base: Any, start: int, stop: int):
        n = len(base)
        start = max(0, min(start, n))
        stop = max(start, min(stop, n))
        if isinstance(base, subrange):  # keep ``base`` near the container
            start += base.start
            stop += base.start
            base = base.base
        self.base = base
        self.start = start
        self.stop = stop

    def __len__(self):
        return self.stop - self.start

    def __dr_segments__(self):
        segs = segments(self.base)
        return take_segments(drop_segments(segs, self.start), len(self))

    def to_array(self):
        arr = self.base.to_array()
        if isinstance(arr, tuple):
            return tuple(a[self.start:self.stop] for a in arr)
        return arr[self.start:self.stop]


def take(r, n):
    return subrange(r, 0, n)


def drop(r, n):
    return subrange(r, n, len(r))


class transform(_ViewBase):
    """Lazy elementwise transform that stays distributed.  ``op`` works
    on tensors; over a zip base it receives one argument per component.
    Trailing ``*scalars`` are bound as a :class:`BoundOp`."""

    def __init__(self, base: Any, op: Callable, *scalars):
        if not callable(op):
            raise TypeError("transform op must be callable")
        self.base = base
        self.op = BoundOp(op, scalars) if scalars else op

    def __len__(self):
        return len(self.base)

    def __dr_segments__(self):
        out = []
        for s in segments(self.base):
            if isinstance(s, Segment):
                out.append(s.with_op(self.op))
            else:
                out.append(_MappedZipSegment(s, self.op))
        return out

    def to_array(self):
        arr = self.base.to_array()
        if isinstance(arr, tuple):
            return self.op(*arr)
        return self.op(arr)


class _MappedZipSegment:
    """ZipSegment with an elementwise op over the component tuple."""

    __slots__ = ("inner", "op")

    def __init__(self, inner, op):
        self.inner = inner
        self.op = op

    def __dr_rank__(self):
        return rank(self.inner)

    def __dr_local__(self):
        vals = local(self.inner)
        return self.op(*vals) if isinstance(vals, tuple) else self.op(vals)

    def __len__(self):
        return len(self.inner)

    def materialize(self):
        return _to_host(self.__dr_local__())


class zip_view(_ViewBase):
    """Rank-aware zip.  Misaligned inputs yield empty ``segments()`` —
    the ``aligned()`` signal — while ``to_array`` still works."""

    def __init__(self, *ranges):
        assert ranges
        self.components = tuple(ranges)
        self.base = ranges[0]

    def __len__(self):
        return min(len(r) for r in self.components)

    def __dr_segments__(self):
        n = len(self)
        seg_lists = []
        for r in self.components:
            try:
                segs = segments(r)
            except TypeError:
                return []
            seg_lists.append(take_segments(segs, n))
        shape = [(rank(s), len(s)) for s in seg_lists[0]]
        for other in seg_lists[1:]:
            if [(rank(s), len(s)) for s in other] != shape:
                return []
        return [ZipSegment(*parts) for parts in builtin_zip(*seg_lists)]

    def to_array(self):
        n = len(self)
        arrs = []
        for r in self.components:
            a = r.to_array()
            assert not isinstance(a, tuple), "nested zip: flatten first"
            arrs.append(a[:n])
        return tuple(arrs)


zip = zip_view


class iota_view(_ViewBase):
    """Counting range whose segmentation mirrors ``like``."""

    def __init__(self, start: int, n: int, like: Any = None,
                 dtype=torch.int32):
        self.start = start
        self._n = n
        self.like = like
        self.dtype = dtype
        self.base = None

    def __len__(self):
        return self._n

    def __dr_segments__(self):
        if self.like is None:
            return [Segment(self, 0, 0, self._n)]
        return [Segment(self, rank(s), s.begin, s.end)
                for s in take_segments(segments(self.like), self._n)]

    def _local_values(self, rank_, begin, end):
        dev = (self.like.runtime.devices[rank_]
               if hasattr(self.like, "runtime") else "cpu")
        return torch.arange(self.start + begin, self.start + end,
                            dtype=self.dtype, device=dev)

    def to_array(self):
        return torch.arange(self.start, self.start + self._n,
                            dtype=self.dtype)


def aligned(*ranges) -> bool:
    """True iff all ranges have pairwise rank/size-equal segment lists
    (mhp/alignment.hpp:13-28); an empty segment list is not aligned."""
    shapes = []
    for r in ranges:
        if hasattr(r, "__iter__") and not hasattr(r, "__dr_segments__") \
                and not hasattr(r, "to_array"):
            continue  # plain local iterables are skipped
        try:
            segs = segments(r)
        except TypeError:
            return False
        if not segs:
            return False
        shapes.append([(rank(s), len(s)) for s in segs])
    return all(s == shapes[0] for s in shapes[1:]) if shapes else True


def local_segments(r):
    """Device-local values of each segment (mhp/views.hpp:9-21)."""
    return [local(s) for s in segments(r)]

