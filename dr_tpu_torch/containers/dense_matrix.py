"""``dense_matrix``: 2-D tiled dense matrix over a rank grid.

Counterpart of ``dr_tpu/containers/dense_matrix.py`` (reference
``shp::dense_matrix``, ``shp/containers/dense_matrix.hpp``).

Storage: rank ``r`` of the ``(gp, gq)`` grid holds one tensor of shape
``(si*th, sj*tw)`` on its device — exactly the shard the JAX array keeps
on mesh device ``r``.  Cyclic layouts store tile rows and columns in the
JAX package's folded order (device-major, slot-minor): tile ``(i, j)``
lives on rank ``tile_rank(i, j)`` at slot ``(i // gp, j // gq)``.  The
logical shape (m, n) is metadata; the pad cells past it are zero after
``assign_array`` and no algorithm writes them.  Ranks of the runtime
past ``gp*gq`` hold nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .distributed_vector import _as_tensor, _host_numpy, torch_dtype
from .partition import block_cyclic, matrix_partition
from ..parallel import runtime as _rt
from ..core.pinning import pinned_id
from ..utils.spmd_guard import TappedCache, dtype_name

#: the matrix's dispatch cache (the JAX package's ``z2`` / ``p2`` /
#: ``u2`` layout programs)
_cache: dict = TappedCache()

__all__ = ["dense_matrix", "matrix_entry", "Index2D", "MatrixTileSegment",
           "fold_ops"]


class Index2D(tuple):
    """2-D index with tuple protocol (shp/containers/index.hpp:38-112)."""

    def __new__(cls, i, j=None):
        if j is None:
            i, j = i
        return super().__new__(cls, (int(i), int(j)))

    @property
    def i(self):
        return self[0]

    @property
    def j(self):
        return self[1]


class matrix_entry:
    """(index, value) pair (shp/containers/matrix_entry.hpp:14-229)."""

    __slots__ = ("index", "value")

    def __init__(self, index, value):
        self.index = Index2D(index)
        self.value = value

    def __iter__(self):  # structured bindings: (index, value)
        return iter((self.index, self.value))

    def __repr__(self):
        return f"matrix_entry({self.index}, {self.value})"


class MatrixTileSegment:
    """One tile: rows [rb, re) x cols [cb, ce) owned by ``rank`` — the
    dense_matrix_view-as-segment of the reference
    (dense_matrix.hpp:198-242)."""

    __slots__ = ("base", "_rank", "rb", "re", "cb", "ce")

    def __init__(self, base, rank, rb, re, cb, ce):
        self.base = base
        self._rank = rank
        self.rb, self.re, self.cb, self.ce = rb, re, cb, ce

    def __dr_rank__(self):
        return self._rank

    def __dr_local__(self):
        return self.base._local_tile(self._rank, self.rb, self.re,
                                     self.cb, self.ce)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.re - self.rb, self.ce - self.cb)

    @property
    def origin(self) -> Index2D:
        return Index2D(self.rb, self.cb)

    def __len__(self):
        return (self.re - self.rb) * (self.ce - self.cb)

    def materialize(self) -> np.ndarray:
        return _host_numpy(self.__dr_local__())

    def __iter__(self):
        vals = self.materialize()
        for i in range(vals.shape[0]):
            for j in range(vals.shape[1]):
                yield matrix_entry((self.rb + i, self.cb + j), vals[i, j])

    def __repr__(self):
        return (f"MatrixTileSegment(rank={self._rank}, "
                f"rows=[{self.rb},{self.re}), cols=[{self.cb},{self.ce}))")


def fold_ops(grid, slots, tshape, m, n):
    """(unfold, fold) pure functions between the FOLDED stored layout and
    the logical (m, n) tensor (``dr_tpu/containers/dense_matrix.py:352``).

    Folding permutes tile rows/cols from logical (slot-major, rank-minor:
    tile i lives at (i // gp, i % gp)) to stored (rank-major, slot-minor)
    order, so each rank's tiles are one contiguous block of the stored
    array.  With slots == (1, 1) the permutation is the identity."""
    gp, gq = grid
    si, sj = slots
    th, tw = tshape
    mm, nn = gp * si * th, gq * sj * tw

    def unfold(data):
        lg = data
        if slots != (1, 1):
            lg = (lg.reshape(gp, si, th, gq, sj, tw)
                  .permute(1, 0, 2, 4, 3, 5).reshape(mm, nn))
        return lg[:m, :n]

    def fold(logical):
        out = logical.new_zeros((mm, nn))
        out[:m, :n] = logical
        if slots != (1, 1):
            out = (out.reshape(si, gp, th, sj, gq, tw)
                   .permute(1, 0, 2, 4, 3, 5).reshape(mm, nn))
        return out

    return unfold, fold


class dense_matrix:
    """Block-tiled dense matrix (one stored block per grid rank)."""

    def __init__(self, shape: Tuple[int, int], dtype=None,
                 partition: Optional[matrix_partition] = None, *,
                 runtime=None):
        self._rt = runtime or _rt.runtime()
        m, n = shape
        self._m, self._n = int(m), int(n)
        self._dtype = torch_dtype(dtype)
        part = partition or block_cyclic()
        if isinstance(part, block_cyclic) and part.grid is None:
            part = block_cyclic(part.tile, part.grid_for(self._rt.nprocs))
        assert isinstance(part, block_cyclic), \
            "dense_matrix distributions are block_cyclic instances"
        self._part = part
        gp, gq = part.grid_shape()
        if gp * gq > self._rt.nprocs:
            raise ValueError(f"grid {(gp, gq)} needs {gp * gq} ranks, the "
                             f"runtime has {self._rt.nprocs}")
        th, tw = part.tile_shape((self._m, self._n))
        self._grid = (gp, gq)
        self._tshape = (th, tw)
        nti = max(1, -(-self._m // th))
        ntj = max(1, -(-self._n // tw))
        self._ntiles = (nti, ntj)
        self._slots = (-(-nti // gp), -(-ntj // gq))
        si, sj = self._slots
        self._shape_local = (si * th, sj * tw)
        _cache.tap(("z2", pinned_id(self._rt), gp * si * th, gq * sj * tw,
                    dtype_name(self._dtype)))
        self._shards = [torch.zeros(self._shape_local, dtype=self._dtype,
                                    device=d)
                        for d in self._rt.devices[:gp * gq]]
        self._rt.register(self)

    # ------------------------------------------------------------------ meta
    @property
    def shape(self) -> Tuple[int, int]:
        return (self._m, self._n)

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def grid_shape(self) -> Tuple[int, int]:
        return self._grid

    @property
    def tile_shape(self) -> Tuple[int, int]:
        return self._tshape

    @property
    def partition(self) -> matrix_partition:
        return self._part

    @property
    def runtime(self):
        return self._rt

    def __len__(self):
        return self._m * self._n

    @property
    def is_block(self) -> bool:
        """One tile per rank (folded == logical layout)."""
        return self._slots == (1, 1)

    @property
    def grid_tiles(self) -> Tuple[int, int]:
        """Tile-grid dimensions (# tiles per axis)."""
        return self._ntiles

    @property
    def layout(self):
        return ("dense2d", self._grid, self._tshape, self._slots,
                self._m, self._n)

    @property
    def shards(self):
        """The per-rank stored blocks, rank order (grid row-major)."""
        return list(self._shards)

    # ----------------------------------------------------------- vocabulary
    def __dr_segments__(self):
        segs = []
        nti, ntj = self._ntiles
        th, tw = self._tshape
        for i in range(nti):
            rb, re = i * th, min((i + 1) * th, self._m)
            if rb >= re:
                continue
            for j in range(ntj):
                cb, ce = j * tw, min((j + 1) * tw, self._n)
                if cb >= ce:
                    continue
                segs.append(MatrixTileSegment(
                    self, self._part.tile_rank(i, j), rb, re, cb, ce))
        return segs

    def tiles(self):
        return self.__dr_segments__()

    def tile(self, ij) -> MatrixTileSegment:
        i, j = ij
        nti, ntj = self._ntiles
        th, tw = self._tshape
        assert 0 <= i < nti and 0 <= j < ntj
        return MatrixTileSegment(
            self, self._part.tile_rank(i, j),
            i * th, min((i + 1) * th, self._m),
            j * tw, min((j + 1) * tw, self._n))

    # ----------------------------------------------------------- value APIs
    def _stored(self) -> torch.Tensor:
        """The whole stored (folded) array on rank 0's device."""
        gp, gq = self._grid
        dev = self._rt.devices[0]
        return torch.cat([torch.cat([self._shards[i * gq + j].to(dev)
                                     for j in range(gq)], dim=1)
                          for i in range(gp)], dim=0)

    def _tap(self, tag: str) -> None:
        _cache.tap((tag, pinned_id(self._rt), self._grid, self._slots,
                    self._tshape, self._m, self._n, dtype_name(self._dtype)))

    def to_array(self) -> torch.Tensor:
        """The logical (m, n) value on rank 0's device."""
        self._tap("u2")
        if self._grid == (1, 1):
            return self._shards[0][:self._m, :self._n].clone()
        unfold, _ = fold_ops(self._grid, self._slots, self._tshape,
                             self._m, self._n)
        return unfold(self._stored())

    def _assign_stored(self, stored: torch.Tensor) -> None:
        gp, gq = self._grid
        hs, ws = self._shape_local
        self._shards = [
            stored[i * hs:(i + 1) * hs, j * ws:(j + 1) * ws]
            .to(self._rt.devices[i * gq + j], self._dtype).contiguous()
            for i in range(gp) for j in range(gq)]

    def assign_array(self, values) -> None:
        values = _as_tensor(values)
        assert tuple(values.shape) == (self._m, self._n)
        self._tap("p2")
        _, fold = fold_ops(self._grid, self._slots, self._tshape,
                           self._m, self._n)
        self._assign_stored(fold(values.to(dtype=self._dtype)))

    @classmethod
    def from_array(cls, values, partition=None, *, runtime=None):
        values = _as_tensor(values)
        mat = cls(tuple(values.shape), values.dtype, partition,
                  runtime=runtime)
        mat.assign_array(values)
        return mat

    @classmethod
    def from_reference_state(cls, layout, stored, *, runtime=None):
        """Build a port matrix holding exactly a JAX matrix's state:
        ``layout`` is its ``layout`` tuple and ``stored`` its stored,
        folded array as numpy (``np.asarray(mat._data)``), pad included."""
        kind, grid, tshape, slots, m, n = layout
        assert kind == "dense2d", f"not a dense matrix layout: {layout}"
        stored = _as_tensor(np.asarray(stored))
        probe = block_cyclic(grid=tuple(grid))
        part = (probe if probe.tile_shape((m, n)) == tuple(tshape)
                else block_cyclic(tile=tuple(tshape), grid=tuple(grid)))
        mat = cls((m, n), stored.dtype, part, runtime=runtime)
        if mat.layout != tuple(layout):
            raise ValueError(f"layout {layout} does not fit the runtime "
                             f"({mat.layout})")
        gp, gq = mat._grid
        hs, ws = mat._shape_local
        assert tuple(stored.shape) == (gp * hs, gq * ws), stored.shape
        mat._assign_stored(stored.clone())
        return mat

    def materialize(self) -> np.ndarray:
        return _host_numpy(self.to_array())

    def _stored_rc(self, r, c):
        """Logical (row, col) -> stored (folded) coordinates.  Works on
        ints and numpy arrays alike."""
        gp, gq = self._grid
        si, sj = self._slots
        th, tw = self._tshape
        i, wr = r // th, r % th
        j, wc = c // tw, c % tw
        return (((i % gp) * si + i // gp) * th + wr,
                ((j % gq) * sj + j // gq) * tw + wc)

    def _locate(self, r, c):
        """Logical (row, col) -> (rank, row, col) in that rank's block."""
        hs, ws = self._shape_local
        sr, sc = self._stored_rc(r, c)
        return (sr // hs) * self._grid[1] + sc // ws, sr % hs, sc % ws

    def _tile_block(self, i: int, j: int):
        """(rank, full (th, tw) view) of grid tile (i, j) in its rank's
        block, pad cells included."""
        th, tw = self._tshape
        rank = self._part.tile_rank(i, j)
        lr = (i // self._grid[0]) * th
        lc = (j // self._grid[1]) * tw
        return rank, self._shards[rank][lr:lr + th, lc:lc + tw]

    def _local_tile(self, rank, rb, re, cb, ce):
        th, tw = self._tshape
        _, view = self._tile_block(rb // th, cb // tw)
        return view[:re - rb, :ce - cb]

    # ------------------------------------------------ element/batched access
    def __getitem__(self, ij):
        i, j = ij
        if isinstance(i, slice) or isinstance(j, slice):
            from ..views.matrix_views import dense_matrix_view
            ri = range(*i.indices(self._m)) if isinstance(i, slice) \
                else range(i, i + 1)
            rj = range(*j.indices(self._n)) if isinstance(j, slice) \
                else range(j, j + 1)
            return dense_matrix_view(self, ri.start, ri.stop,
                                     rj.start, rj.stop)
        i, j = int(i), int(j)
        if i < 0:
            i += self._m
        if j < 0:
            j += self._n
        if not (0 <= i < self._m and 0 <= j < self._n):
            raise IndexError((i, j))
        rank, lr, lc = self._locate(i, j)
        return self._shards[rank][lr, lc].item()

    def __setitem__(self, ij, value) -> None:
        i, j = int(ij[0]), int(ij[1])
        if not (0 <= i < self._m and 0 <= j < self._n):
            raise IndexError((i, j))
        rank, lr, lc = self._locate(i, j)
        self._shards[rank][lr, lc] = value

    def _check_rc(self, rows, cols):
        """Numpy-convention negatives + strict bounds (same contract as
        distributed_vector.get/put: no silent wrapping — folded storage
        would alias out-of-range indices onto OTHER valid elements)."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        rows = np.where(rows < 0, rows + self._m, rows)
        cols = np.where(cols < 0, cols + self._n, cols)
        if ((rows < 0) | (rows >= self._m)).any() or \
                ((cols < 0) | (cols >= self._n)).any():
            raise IndexError(
                f"index out of range for shape {(self._m, self._n)}")
        return rows.reshape(-1).astype(np.int64), \
            cols.reshape(-1).astype(np.int64)

    def get(self, rows, cols) -> torch.Tensor:
        """Batched element gather onto rank 0's device."""
        rows, cols = self._check_rc(rows, cols)
        rank, lr, lc = self._locate(rows, cols)
        dev = self._rt.devices[0]
        out = torch.empty((len(rows),), dtype=self._dtype, device=dev)
        for rr in np.unique(rank):
            sel = np.nonzero(rank == rr)[0]
            sh = self._shards[rr]
            out[torch.as_tensor(sel, device=dev)] = sh[
                torch.as_tensor(lr[sel], device=sh.device),
                torch.as_tensor(lc[sel], device=sh.device)].to(dev)
        return out

    def put(self, rows, cols, values) -> None:
        """Batched element write."""
        rows, cols = self._check_rc(rows, cols)
        vals = _as_tensor(values).reshape(-1)
        if vals.numel() == 1 and len(rows) != 1:
            vals = vals.expand(len(rows))
        rank, lr, lc = self._locate(rows, cols)
        for rr in np.unique(rank):
            sel = np.nonzero(rank == rr)[0]
            sh = self._shards[rr]
            sh[torch.as_tensor(lr[sel], device=sh.device),
               torch.as_tensor(lc[sel], device=sh.device)] = vals[
                torch.as_tensor(sel, device=vals.device)].to(sh.device,
                                                              self._dtype)

    def block_until_ready(self):
        self._rt.fence()
        return self

    def __repr__(self):
        return (f"dense_matrix(shape={self.shape}, grid={self._grid}, "
                f"tile={self._tshape}, dtype={self._dtype})")
