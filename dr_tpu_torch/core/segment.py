"""Segment types returned by ``segments()`` (counterpart of
``dr_tpu/core/segment.py``): ``(base, rank, begin, end)`` metadata plus
a lazy elementwise op chain; ``local()`` reads the rank's row tensor."""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np

__all__ = ["Segment", "ZipSegment"]


class Segment:
    """Contiguous slice [begin, end) of ``base``'s logical space on ``rank``."""

    __slots__ = ("base", "_rank", "begin", "end", "ops")

    def __init__(self, base: Any, rank: int, begin: int, end: int,
                 ops: Tuple[Callable, ...] = ()):
        assert end >= begin
        self.base = base
        self._rank = rank
        self.begin = begin
        self.end = end
        self.ops = tuple(ops)

    def __dr_rank__(self) -> int:
        return self._rank

    def __dr_local__(self):
        vals = self.base._local_values(self._rank, self.begin, self.end)
        for op in self.ops:
            vals = op(vals)
        return vals

    def __len__(self) -> int:
        return self.end - self.begin

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            assert step == 1, "segments are contiguous"
            return Segment(self.base, self._rank, self.begin + start,
                           self.begin + stop, self.ops)
        return self.materialize()[key]

    def __iter__(self):
        return iter(self.materialize())

    def first(self, k: int) -> "Segment":
        return self[:k]

    def last(self, k: int) -> "Segment":
        return self[len(self) - k:]

    def subspan(self, offset: int, count: int) -> "Segment":
        return self[offset:offset + count]

    def with_op(self, op: Callable) -> "Segment":
        return Segment(self.base, self._rank, self.begin, self.end,
                       self.ops + (op,))

    def materialize(self) -> np.ndarray:
        """Host copy of this segment's values (the test-oracle path)."""
        vals = self.base._local_values(self._rank, self.begin, self.end)
        for op in self.ops:
            vals = op(vals)
        return vals.cpu().numpy()

    def __repr__(self):
        return (f"Segment(rank={self._rank}, [{self.begin},{self.end})"
                f"{', ops' if self.ops else ''})")


class ZipSegment:
    """A rank-aligned tuple of equally-sized segments."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        assert parts
        n = len(parts[0])
        assert all(len(p) == n for p in parts), "zip segments must align"
        self.parts = tuple(parts)

    def __dr_rank__(self) -> int:
        from .vocabulary import rank
        return rank(self.parts[0])

    def __dr_local__(self):
        from .vocabulary import local
        return tuple(local(p) for p in self.parts)

    def __len__(self) -> int:
        return len(self.parts[0])

    def __getitem__(self, key):
        if isinstance(key, slice):
            return ZipSegment(*(p[key] for p in self.parts))
        return tuple(p.materialize()[key] for p in self.parts)

    def __iter__(self):
        return iter(zip(*(p.materialize() for p in self.parts)))

    def materialize(self):
        return tuple(p.materialize() for p in self.parts)

    def __repr__(self):
        return f"ZipSegment(rank={self.__dr_rank__()}, n={len(self)})"
