"""Matrix views: submatrix / row / column slices of a dense_matrix.

Counterpart of ``dr_tpu/views/matrix_views.py`` (reference
``shp/views/dense_matrix_view.hpp``, ``dense_row_view.hpp``,
``dense_column_view.hpp``): lazy (rows x cols) windows that still expose
``segments()`` (clipped tiles, with ranks) and evaluate as tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..containers.distributed_vector import _host_numpy
from ..core.vocabulary import rank, segments

__all__ = ["dense_matrix_view", "matrix_row_view", "matrix_column_view"]


class dense_matrix_view:
    """Window rows [rb, re) x cols [cb, ce) over a dense_matrix
    (dense_matrix_view.hpp:108-163)."""

    def __init__(self, base, rb, re, cb, ce):
        m, n = base.shape
        self.base = base
        self.rb, self.re = max(0, rb), min(re, m)
        self.cb, self.ce = max(0, cb), min(ce, n)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.re - self.rb, self.ce - self.cb)

    def __len__(self):
        return self.shape[0] * self.shape[1]

    def __dr_segments__(self):
        from ..containers.dense_matrix import MatrixTileSegment
        out = []
        for t in segments(self.base):
            rb, re = max(t.rb, self.rb), min(t.re, self.re)
            cb, ce = max(t.cb, self.cb), min(t.ce, self.ce)
            if rb < re and cb < ce:
                out.append(MatrixTileSegment(self.base, rank(t),
                                             rb, re, cb, ce))
        return out

    def to_array(self):
        return self.base.to_array()[self.rb:self.re, self.cb:self.ce]

    def materialize(self) -> np.ndarray:
        return _host_numpy(self.to_array())

    def row(self, i: int) -> "matrix_row_view":
        return matrix_row_view(self.base, self.rb + i, self.cb, self.ce)

    def column(self, j: int) -> "matrix_column_view":
        return matrix_column_view(self.base, self.cb + j, self.rb, self.re)

    def __repr__(self):
        return (f"dense_matrix_view(rows=[{self.rb},{self.re}), "
                f"cols=[{self.cb},{self.ce}))")


class matrix_row_view:
    """One matrix row as a 1-D range (dense_row_view.hpp:76-102)."""

    def __init__(self, base, i, cb=0, ce=None):
        self.base = base
        self.i = i
        self.cb = cb
        self.ce = base.shape[1] if ce is None else ce

    def __len__(self):
        return self.ce - self.cb

    def to_array(self):
        return self.base.to_array()[self.i, self.cb:self.ce]

    def materialize(self):
        return _host_numpy(self.to_array())

    def __iter__(self):
        return iter(self.materialize())

    def __getitem__(self, j):
        return self.base[self.i, self.cb + j]


class matrix_column_view:
    """One matrix column as a 1-D range (dense_column_view.hpp:77-105)."""

    def __init__(self, base, j, rb=0, re=None):
        self.base = base
        self.j = j
        self.rb = rb
        self.re = base.shape[0] if re is None else re

    def __len__(self):
        return self.re - self.rb

    def to_array(self):
        return self.base.to_array()[self.rb:self.re, self.j]

    def materialize(self):
        return _host_numpy(self.to_array())

    def __iter__(self):
        return iter(self.materialize())

    def __getitem__(self, i):
        return self.base[self.rb + i, self.j]
