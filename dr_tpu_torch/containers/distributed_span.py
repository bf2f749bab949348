"""``distributed_span``: a non-owning distributed range over a segment list
(counterpart of ``dr_tpu/containers/distributed_span.py``; reference
``shp::distributed_span``, ``shp/distributed_span.hpp:191-225``).

It wraps any list of segments and re-slices it across segment boundaries
with ``subspan`` / ``first`` / ``last``, keeping every segment's rank.
The segments keep referring to their containers; the span owns nothing.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.vocabulary import segments as _segments
from ..views.views import drop_segments, take_segments

__all__ = ["distributed_span"]


class distributed_span:
    def __init__(self, segs: Sequence):
        self._segs = list(segs)

    @classmethod
    def of(cls, r) -> "distributed_span":
        return cls(_segments(r))

    def __len__(self) -> int:
        return sum(len(s) for s in self._segs)

    def __dr_segments__(self):
        return list(self._segs)

    # -- rank-preserving re-slicing (distributed_span.hpp:191-225) ---------
    def subspan(self, offset: int, count: int) -> "distributed_span":
        return distributed_span(
            take_segments(drop_segments(self._segs, offset), count))

    def first(self, count: int) -> "distributed_span":
        return self.subspan(0, count)

    def last(self, count: int) -> "distributed_span":
        return self.subspan(len(self) - count, count)

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            assert step == 1
            return self.subspan(start, stop - start)
        return self.materialize()[key]

    def materialize(self) -> np.ndarray:
        if not self._segs:
            return np.array([])
        return np.concatenate([np.asarray(s.materialize())
                               for s in self._segs])

    def to_array(self) -> torch.Tensor:
        return torch.from_numpy(self.materialize())

    def __iter__(self):
        return iter(self.materialize())

    def __repr__(self):
        return (f"distributed_span(n={len(self)}, "
                f"segments={len(self._segs)})")
