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

__all__ = ["take", "drop", "subrange", "slice_view", "transform",
           "zip_view", "zip", "enumerate_view", "enumerate", "iota_view",
           "counted", "take_segments", "drop_segments", "aligned",
           "local_segments", "ranked_view", "segment_id", "segment_range",
           "segment_ranges", "BoundOp"]


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
builtin_enumerate = enumerate


def _devices_of(r):
    """The rank -> device list of the container under ``r`` (a zip's
    first component), or None for a range with no runtime."""
    obj = r
    while obj is not None and not hasattr(obj, "runtime"):
        obj = getattr(obj, "base", None)
    return None if obj is None else obj.runtime.devices


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


def take(r, n=None):
    """``take(r, n)``, or the adaptor ``take(n)`` for ``r | take(n)``."""
    if n is None:
        return _Pipe(lambda rr: subrange(rr, 0, r))
    return subrange(r, 0, n)


def drop(r, n=None):
    """``drop(r, n)``, or the adaptor ``drop(n)`` for ``r | drop(n)``."""
    if n is None:
        return _Pipe(lambda rr: subrange(rr, r, len(rr)))
    return subrange(r, n, len(r))


def slice_view(r, bounds=None):
    """``views::slice(r, (a, b))``, or the adaptor ``slice_view((a, b))``
    (shp/views/standard_views.hpp:19-44)."""
    if bounds is None:
        a, b = r
        return _Pipe(lambda rr: subrange(rr, a, b))
    a, b = bounds
    return subrange(r, a, b)


def counted(it_range, n):
    """``rng::views::counted`` over a distributed range."""
    return subrange(it_range, 0, n)


class transform(_ViewBase):
    """Lazy elementwise transform that stays distributed.  ``op`` works
    on tensors; over a zip base it receives one argument per component.
    Trailing ``*scalars`` are bound as a :class:`BoundOp`.
    ``transform(op)`` alone is the adaptor for ``r | transform(op)``
    (it takes no scalars)."""

    def __new__(cls, base=None, op=None, *scalars):
        if op is None and callable(base) and \
                not hasattr(base, "__dr_segments__") and \
                not hasattr(base, "to_array"):
            return _Pipe(lambda rr: cls(rr, base))
        return super().__new__(cls)

    def __init__(self, base: Any, op: Callable = None, *scalars):
        if not callable(op):
            raise TypeError(
                "transform op must be callable; the adaptor form "
                "transform(op) takes no scalars: use "
                "transform(range, op, *scalars)")
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
        devs = _devices_of(self.like)
        return torch.arange(self.start + begin, self.start + end,
                            dtype=self.dtype,
                            device=devs[rank_] if devs else "cpu")

    def to_array(self):
        return torch.arange(self.start, self.start + self._n,
                            dtype=self.dtype)


class segment_id:
    """A position inside one segment: (segment, local_id, global id),
    ``shp::id<1>`` (shp/range.hpp:12-33).  Converts to the global index."""

    __slots__ = ("segment", "local_id", "global_id")

    def __init__(self, segment: int, local_id: int, global_id: int):
        self.segment = segment
        self.local_id = local_id
        self.global_id = global_id

    def __index__(self):
        return self.global_id

    def __int__(self):
        return self.global_id

    def __eq__(self, other):
        if isinstance(other, segment_id):
            return (self.segment, self.local_id, self.global_id) == \
                (other.segment, other.local_id, other.global_id)
        return self.global_id == other

    def __hash__(self):
        # consistent with the int-comparison branch of __eq__
        return hash(self.global_id)

    def __repr__(self):
        return (f"segment_id(segment={self.segment}, "
                f"local={self.local_id}, global={self.global_id})")


class segment_range:
    """The :class:`segment_id` values of one segment (shp/range.hpp:97-130):
    ``segment_range(seg_id, size, global_offset)`` yields ids
    (seg_id, 0..size-1, global_offset + local)."""

    def __init__(self, seg_id: int, segment_size: int, global_offset: int):
        self.segment_id = seg_id
        self.segment_size = segment_size
        self.global_offset = global_offset

    def __len__(self):
        return self.segment_size

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += self.segment_size
        if not 0 <= idx < self.segment_size:
            raise IndexError(idx)
        return segment_id(self.segment_id, idx, self.global_offset + idx)

    def __iter__(self):
        return (self[i] for i in range(self.segment_size))

    def rank(self):  # the reference's: always 0 (shp/range.hpp:124)
        return 0


def segment_ranges(r):
    """One :class:`segment_range` per segment of ``r``: segment-local ids
    with global offsets."""
    out, pos = [], 0
    for i, s in builtin_enumerate(segments(r)):
        out.append(segment_range(i, len(s), pos))
        pos += len(s)
    return out


class enumerate_view(zip_view):
    """zip(iota, r) (shp/views/enumerate.hpp:27-52)."""

    def __init__(self, r):
        super().__init__(iota_view(0, len(r), like=r), r)


def enumerate(r=None):
    """``enumerate(r)``, or the adaptor ``enumerate()`` for
    ``r | enumerate()``."""
    if r is None:
        return _Pipe(enumerate_view)
    return enumerate_view(r)


class ranked_view(zip_view):
    """(owning rank, value) pairs, for debugging (views/views.hpp:7-11)."""

    def __init__(self, r):
        super().__init__(_rank_of_view(r), r)


class _rank_of_view(_ViewBase):
    """Each element's owning rank in ``like``; positions follow segment
    order (cumulative lengths), so any segment type works, zips too."""

    def __init__(self, like):
        self.like = like
        self.base = None
        segs = segments(like)
        if not segs:
            raise ValueError("ranked_view: range has no segments "
                             "(misaligned zip?)")
        self._devices = _devices_of(like)
        self._bounds = []
        pos = 0
        for s in segs:
            self._bounds.append((pos, pos + len(s), rank(s)))
            pos += len(s)

    def __len__(self):
        return len(self.like)

    def __dr_segments__(self):
        return [Segment(self, r, lo, hi) for lo, hi, r in self._bounds]

    def _local_values(self, rank_, begin, end):
        dev = self._devices[rank_] if self._devices else "cpu"
        return torch.full((end - begin,), rank_, dtype=torch.int32,
                          device=dev)

    def to_array(self):
        vals = torch.empty(len(self), dtype=torch.int32)
        for lo, hi, r in self._bounds:
            vals[lo:hi] = r
        return vals


class _Pipe:
    """Pipeable view adaptor: ``dv | views.take(3) | views.transform(f)``."""

    def __init__(self, fn):
        self.fn = fn

    def __ror__(self, r):
        return self.fn(r)

    def __call__(self, r):
        return self.fn(r)


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

