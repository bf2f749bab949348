"""``sparse_matrix``: a distributed sparse matrix, one tile a rank.

Counterpart of ``dr_tpu/containers/sparse_matrix.py`` (reference
``shp/containers/sparse_matrix.hpp``).  The layout is the JAX package's
padded COO: every rank holds three tensors of length ``K`` (the largest
tile's nonzero count) on its device, ``values``, tile-local ``rows``
and tile-local ``cols`` (int32), with zero-valued padding at row 0,
column 0.  Row tiles by default; a ``block_cyclic`` grid with one tile a
rank gives a 2-D tiling whose tile columns are tile-local too.

At build time the SpMV layout is chosen from the row-length
distribution (:meth:`sparse_matrix._decide_format`: ``csr``, ``ell`` or
``bcsr``, the same gates and constants as the JAX package).  The grouped
layouts are built lazily, each behind the same viability gate:
:meth:`ensure_ell` (rows padded to the longest row), :meth:`ensure_bcsr`
(dense 8 x 128 blocks in block-ELL form) and :meth:`ensure_ring`
(per-ring-step ELL buckets against a block-sharded ``b``).

Every layout is built on the rank's device with torch ops: stable sorts,
``unique``, ``bincount`` and index writes that never collide, so a
layout built on the card equals the one built on the CPU bit for bit,
and both equal the JAX package's host build.  Duplicate entries that
fall in one BCSR cell add in entry order, as ``np.add.at`` does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..parallel import runtime as _rt
from .distributed_vector import _as_tensor, _host_numpy, torch_dtype

__all__ = ["sparse_matrix", "random_sparse_matrix", "CsrTileSegment"]


def _run_offsets(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Each entry's offset within its run of equal keys (``sorted_keys``
    ascending): its index minus the index of the run's first entry."""
    _, inv, cnt = torch.unique_consecutive(sorted_keys, return_inverse=True,
                                           return_counts=True)
    first = torch.cumsum(cnt, 0) - cnt
    return torch.arange(sorted_keys.numel(),
                        device=sorted_keys.device) - first[inv]


def _add_in_order(flat: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """``np.add.at(flat, idx, vals)``: entries that share an index add
    in entry order.  Each round writes the k-th entry of every index, so
    no write collides and the result is the same bits on any device."""
    order = torch.sort(idx, stable=True).indices
    idx, vals = idx[order], vals[order]
    level = _run_offsets(idx)
    for k in range(int(level.max()) + 1 if idx.numel() else 0):
        sel = level == k
        i = idx[sel]
        flat[i] = flat[i] + vals[sel]


class CsrTileSegment:
    """One tile's sparse triple and its rank, the ``csr_matrix_view``
    analog.  Row-tiled matrices have ``cb = 0``; 2-D grids carry the
    tile's column window too."""

    __slots__ = ("base", "_rank", "rb", "re", "cb", "ce")

    def __init__(self, base, rank, rb, re, cb=0, ce=None):
        self.base = base
        self._rank = rank
        self.rb, self.re = rb, re
        self.cb = cb
        self.ce = base.shape[1] if ce is None else ce

    def __dr_rank__(self):
        return self._rank

    @property
    def shape(self):
        return (self.re - self.rb, self.ce - self.cb)

    def __len__(self):
        return int(self.nnz)

    @property
    def nnz(self):
        return self.base._tile_nnz[self._rank]

    def triples(self):
        """(rows, cols, values) with GLOBAL ids, host numpy."""
        k = int(self.base._tile_nnz[self._rank])
        b = self.base
        rows = _host_numpy(b._rows[self._rank][:k]).astype(np.int64) + self.rb
        cols = _host_numpy(b._cols[self._rank][:k]).astype(np.int64) + self.cb
        vals = _host_numpy(b._vals[self._rank][:k])
        return rows, cols, vals

    def csr(self):
        """(rowptr, cols, values) tile-local CSR, host numpy."""
        rows, cols, vals = self.triples()
        rows = rows - self.rb
        m = self.re - self.rb
        rowptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(rowptr[1:], rows, 1)
        rowptr = np.cumsum(rowptr)
        order = np.argsort(rows, kind="stable")
        return rowptr, cols[order], vals[order]

    def __iter__(self):
        from .dense_matrix import matrix_entry
        rows, cols, vals = self.triples()
        for r, c, v in zip(rows, cols, vals):
            yield matrix_entry((int(r), int(c)), v)

    def __repr__(self):
        return (f"CsrTileSegment(rank={self._rank}, rows=[{self.rb},"
                f"{self.re}), cols=[{self.cb},{self.ce}), "
                f"nnz={int(self.nnz)})")


class sparse_matrix:
    """Distributed sparse matrix (CSR surface, padded-COO layout).

    Default partition is row tiles (grid (P, 1)); any ``block_cyclic``
    grid with ``gp*gq == nprocs`` and ``tile.div`` tiles gives a 2-D
    tiling whose SpMV combines partials over the grid's columns."""

    # padding blowup bound for the ELL layout: rows*kmax <= factor * K
    _ELL_FACTOR = 4
    # BCSR blocks (8 rows x 128 columns), the least fill that admits
    # them and the block-ELL allocation skew bound
    _BCSR_BH = 8
    _BCSR_BW = 128
    _BCSR_MIN_FILL = 1.0 / 16.0
    _BCSR_FACTOR = 2
    # ring-bucket blowup bound: P * th * kr <= factor * K
    _RING_FACTOR = 4

    def __init__(self, shape: Tuple[int, int], dtype=None, *,
                 partition=None, runtime=None):
        self._rt = runtime or _rt.runtime()
        self._m, self._n = int(shape[0]), int(shape[1])
        self._dtype = torch_dtype(dtype)
        P = self._rt.nprocs
        if partition is None:
            gp, gq = P, 1
        else:
            from .partition import block_cyclic, tile as _tile
            assert isinstance(partition, block_cyclic)
            gp, gq = partition.grid_for(P)
            assert gp * gq == P, \
                "sparse grids place one tile per rank (gp*gq == nprocs)"
            assert partition.tile == (_tile.div, _tile.div), \
                "sparse tiles are tile.div (one block per rank)"
        self._grid = (gp, gq)
        self._nshards = P
        self._th = -(-self._m // gp)  # rows per tile
        self._tw = -(-self._n // gq)  # cols per tile
        # padded COO: one (K,) tensor a rank, None until built
        self._vals = self._rows = self._cols = None
        self._K = 1
        self._ell_vals = self._ell_cols = None
        self._ell_width = 0
        self._bcsr_vals = self._bcsr_cols = None
        self._bcsr_kb = 0
        self._bcsr_nbr = 0
        self._bcsr_state = "maybe"
        self._ring_vals = self._ring_cols = None
        self._ring_kr = 0
        self._ring_bw = 0
        self._ring_state = "maybe"
        # the csr route's row order: per rank (permutation, row lengths)
        self._csr_order = None
        self._format = "csr"
        self._row_kmax = None
        self._bcsr_scan_cached = None
        self._tile_nnz = np.zeros(P, dtype=np.int64)
        self._nnz = 0

    # --------------------------------------------------------- constructors
    @classmethod
    def from_coo(cls, shape, rows, cols, values, *, partition=None,
                 runtime=None):
        """Build from global COO triples (any order; numpy or torch)."""
        values = _as_tensor(values)
        self = cls(shape, values.dtype, partition=partition,
                   runtime=runtime)
        dev = self._rt.devices[0]
        rows = torch.as_tensor(rows).to(dev, torch.int64)
        cols = torch.as_tensor(cols).to(dev, torch.int64)
        values = values.to(dev)
        if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= self._m
                             or int(cols.min()) < 0
                             or int(cols.max()) >= self._n):
            raise ValueError(f"COO indices outside the {shape} matrix")
        th, tw = self._th, self._tw
        gq = self._grid[1]
        tile_of = (rows // th) * gq + cols // tw
        if tile_of.numel() > 1 and not bool((tile_of[1:] >= tile_of[:-1])
                                            .all()):
            order = torch.sort(tile_of, stable=True).indices
            rows, cols, values, tile_of = (rows[order], cols[order],
                                           values[order], tile_of[order])
        counts = _host_numpy(torch.bincount(tile_of, minlength=self._nshards)
                             ).astype(np.int64)
        del tile_of
        self._set_coo(counts, [
            (values[s:s + c],
             rows[s:s + c] - (t // gq) * th,
             cols[s:s + c] - (t % gq) * tw)
            for t, (s, c) in enumerate(zip(np.cumsum(counts) - counts,
                                           counts))])
        return self

    def _set_coo(self, counts, tiles) -> None:
        """Pad each tile's (values, local rows, local cols) to the common
        ``K``, move it to its rank's device and decide the format."""
        K = max(int(counts.max()), 1) if counts.sum() else 1

        def padded(x, dtype, dev):
            if x.numel() == K:
                # a copy: the caller's arrays must not alias the matrix
                return x.to(dev, dtype, copy=True)
            out = torch.zeros(K, dtype=dtype, device=x.device)
            out[:x.numel()] = x
            return out.to(dev)

        devs = self._rt.devices
        self._vals = [padded(v, self._dtype, d)
                      for (v, _, _), d in zip(tiles, devs)]
        self._rows = [padded(r, torch.int32, d)
                      for (_, r, _), d in zip(tiles, devs)]
        self._cols = [padded(c, torch.int32, d)
                      for (_, _, c), d in zip(tiles, devs)]
        self._K = K
        self._tile_nnz = np.asarray(counts, dtype=np.int64)
        self._nnz = int(self._tile_nnz.sum())
        self._decide_format(self._tile_nnz)
        self._rt.register(self)

    @classmethod
    def from_reference_state(cls, shape, grid, tile_nnz, vals, rows, cols, *,
                             runtime=None):
        """Build a port matrix holding exactly a JAX matrix's state:
        its ``shape``, ``grid_shape``, ``_tile_nnz`` and its padded
        ``_vals`` / ``_rows`` / ``_cols`` as ``(P, K)`` numpy arrays.
        The layout and the format decision are the JAX matrix's."""
        from .partition import block_cyclic
        vals = _as_tensor(np.asarray(vals))
        self = cls(shape, vals.dtype, partition=block_cyclic(grid=tuple(grid)),
                   runtime=runtime)
        counts = np.asarray(tile_nnz, dtype=np.int64)
        if vals.shape[0] != self._nshards or len(counts) != self._nshards:
            raise ValueError(f"{vals.shape[0]} tiles for "
                             f"{self._nshards} ranks")
        rows = _as_tensor(np.asarray(rows))
        cols = _as_tensor(np.asarray(cols))
        self._set_coo(counts, [(vals[t], rows[t], cols[t])
                               for t in range(self._nshards)])
        return self

    def _decide_format(self, counts) -> None:
        """The build-time SpMV layout choice (the JAX package's
        ``_decide_format``): block-structured sparsity that passes the
        BCSR gates -> ``bcsr``; else an ELL padding blowup (``th * kmax >
        _ELL_FACTOR * K``) -> ``csr``; else ``ell``.  The ``ring`` layout
        is never chosen here."""
        P, th = self._nshards, self._th
        K = self._K if self._nnz else 1
        kmax = 1
        for t in range(P):
            c = int(counts[t])
            if c:
                kmax = max(kmax, int(torch.bincount(
                    self._rows[t][:c], minlength=th).max()))
        self._row_kmax = kmax
        if self._nnz == 0:
            self._format = "csr"
            return
        scan = self._bcsr_scan(counts)
        bcsr_ok = scan[-1]
        if bcsr_ok:
            # the first ensure_bcsr takes this pass-1 result over
            self._bcsr_scan_cached = scan
        else:
            self._bcsr_state = "no"
        if th * kmax > self._ELL_FACTOR * K:
            self._ell_width = -1
            self._ring_state = "no"
            self._format = "bcsr" if bcsr_ok else "csr"
            return
        self._format = "bcsr" if bcsr_ok else "ell"

    def _bcsr_scan(self, counts):
        """Pass 1 of the BCSR build and the gate both the autoselect and
        :meth:`ensure_bcsr` read: per-tile sorted block keys, the
        block-ELL width ``kb``, block-rows per tile ``nbr``, and whether
        the occupiable-cell fill reaches ``_BCSR_MIN_FILL`` with the
        block-row skew within ``_BCSR_FACTOR``."""
        P, th = self._nshards, self._th
        bh, bw = self._BCSR_BH, self._BCSR_BW
        nbr = -(-th // bh)
        gq = self._grid[1]
        per = []
        kb = 1
        total_tiles = 0
        total_cells = 0
        for t in range(P):
            c = int(counts[t])
            r = self._rows[t][:c].to(torch.int64)
            cc = self._cols[t][:c].to(torch.int64)
            keys = torch.unique((r // bh) * (1 << 32) | (cc // bw))
            per.append(keys)
            total_tiles += keys.numel()
            kbr = keys >> 32
            kcb = keys & 0xFFFFFFFF
            # occupiable cells only: remainder block-rows and the last
            # block-column hold fewer real rows and columns
            real_h = max(0, min(th, self._m - (t // gq) * th))
            real_w = max(0, min(self._tw, self._n - (t % gq) * self._tw))
            rows_in = torch.clamp(torch.clamp(real_h - kbr * bh, max=bh),
                                  min=0)
            cols_in = torch.clamp(torch.clamp(real_w - kcb * bw, max=bw),
                                  min=0)
            total_cells += int((rows_in * cols_in).sum())
            if c:
                kb = max(kb, int(torch.bincount(kbr, minlength=nbr).max()))
        fill = self._nnz / max(total_cells, 1)
        avg_kb = -(-total_tiles // max(P * nbr, 1))
        viable = (fill >= self._BCSR_MIN_FILL
                  and kb <= self._BCSR_FACTOR * max(avg_kb, 1))
        return per, kb, nbr, viable

    @property
    def format(self) -> str:
        """The autoselected SpMV layout (``csr`` / ``ell`` / ``bcsr``)."""
        return self._format

    def ensure_ell(self) -> bool:
        """Build the row-grouped (ELL) layout lazily: one ``(th, kmax)``
        values tensor and int32 column tensor a rank, each row's entries
        in entry order, padding value 0 at column 0.  Refused (and
        remembered) when a long row would pad beyond ``_ELL_FACTOR``
        times the COO footprint."""
        if self._ell_vals is not None:
            return True
        if self._ell_width < 0 or self._vals is None:
            return False
        th = self._th
        kmax = max(1, self._row_kmax)
        if th * kmax > self._ELL_FACTOR * max(self._K, 1):
            self._ell_width = -1
            return False
        self._ell_width = kmax
        ev, ec = [], []
        for t in range(self._nshards):
            c = int(self._tile_nnz[t])
            dev = self._vals[t].device
            vals = torch.zeros((th, kmax), dtype=self._dtype, device=dev)
            cols = torch.zeros((th, kmax), dtype=torch.int32, device=dev)
            if c:
                lr = self._rows[t][:c].to(torch.int64)
                order = torch.sort(lr, stable=True).indices
                lr_s = lr[order]
                pos = _run_offsets(lr_s)
                vals[lr_s, pos] = self._vals[t][:c][order]
                cols[lr_s, pos] = self._cols[t][:c][order]
            ev.append(vals)
            ec.append(cols)
        self._ell_vals, self._ell_cols = ev, ec
        return True

    def ensure_bcsr(self) -> bool:
        """Build the block-ELL (BCSR) layout lazily: the nonzeros in
        dense (8, 128) blocks, ``(nbr, kb, 8, 128)`` values and
        ``(nbr, kb)`` int32 block columns a rank.  Refused (and
        remembered) when the blocks would hold too few nonzeros or one
        block-row would balloon the width (:meth:`_bcsr_scan`)."""
        if self._bcsr_vals is not None:
            return True
        if self._bcsr_state == "no" or self._vals is None:
            return False
        bh, bw = self._BCSR_BH, self._BCSR_BW
        scan = self._bcsr_scan_cached
        self._bcsr_scan_cached = None
        if scan is None:
            scan = self._bcsr_scan(self._tile_nnz)
        per, kb, nbr, viable = scan
        if not viable:
            self._bcsr_state = "no"
            return False
        bv, bc = [], []
        for t in range(self._nshards):
            c = int(self._tile_nnz[t])
            dev = self._vals[t].device
            flat = torch.zeros(nbr * kb * bh * bw, dtype=self._dtype,
                               device=dev)
            cols = torch.zeros((nbr, kb), dtype=torch.int32, device=dev)
            if c:
                keys = per[t]
                br = keys >> 32
                cb = keys & 0xFFFFFFFF
                slot = _run_offsets(br)  # keys sort by (br, cb)
                cols[br, slot] = cb.to(torch.int32)
                r = self._rows[t][:c].to(torch.int64)
                cc = self._cols[t][:c].to(torch.int64)
                pos = torch.searchsorted(keys, (r // bh) * (1 << 32)
                                         | (cc // bw))
                cell = (((br[pos] * kb + slot[pos]) * bh + r % bh) * bw
                        + cc % bw)
                _add_in_order(flat, cell, self._vals[t][:c])
            bv.append(flat.view(nbr, kb, bh, bw))
            bc.append(cols)
        self._bcsr_vals, self._bcsr_cols = bv, bc
        self._bcsr_kb = kb
        self._bcsr_nbr = nbr
        self._bcsr_state = "yes"
        return True

    def ensure_ring(self) -> bool:
        """Build the ring-bucketed layout lazily: ``b`` is block-sharded
        into ``nshards`` windows of ``bw = ceil(n / nshards)``, and rank d
        holds window ``(d - t) % nshards`` at ring step t, so bucket
        ``[t]`` of rank d holds its entries whose column falls in that
        window (columns window-local), ELL-grouped per row:
        ``(P, th, kr)`` a rank.  Row tiles with more than one rank only;
        refused (and remembered) when the buckets would pad beyond
        ``_RING_FACTOR`` times the COO footprint."""
        if self._ring_vals is not None:
            return True
        if (self._ring_state == "no" or self._vals is None
                or self._nshards < 2 or self._grid[1] != 1):
            return False
        P, th = self._nshards, self._th
        bw = max(1, -(-self._n // P))
        kr = 1
        buckets = []
        for t in range(P):
            c = int(self._tile_nnz[t])
            if not c:
                buckets.append(None)
                continue
            src = self._cols[t][:c].to(torch.int64) // bw
            step = (t - src) % P
            combo = step * th + self._rows[t][:c].to(torch.int64)
            kr = max(kr, int(torch.bincount(combo, minlength=P * th).max()))
            buckets.append((src, step, combo))
        if P * th * kr > self._RING_FACTOR * max(self._K, 1):
            self._ring_state = "no"
            return False
        rv, rc = [], []
        for t in range(P):
            dev = self._vals[t].device
            vals = torch.zeros((P, th, kr), dtype=self._dtype, device=dev)
            cols = torch.zeros((P, th, kr), dtype=torch.int32, device=dev)
            if buckets[t] is not None:
                c = int(self._tile_nnz[t])
                src, step, combo = buckets[t]
                order = torch.sort(combo, stable=True).indices
                pos = _run_offsets(combo[order])
                at = (step[order], self._rows[t][:c].to(torch.int64)[order],
                      pos)
                vals[at] = self._vals[t][:c][order]
                cols[at] = (self._cols[t][:c].to(torch.int64)
                            - src * bw)[order].to(torch.int32)
            rv.append(vals)
            rc.append(cols)
        self._ring_vals, self._ring_cols = rv, rc
        self._ring_kr = kr
        self._ring_bw = bw
        self._ring_state = "yes"
        return True

    def _ensure_csr_order(self):
        """The csr route's fixed summation order, built once: per rank,
        the stable permutation that sorts the tile's entries by row
        (int32) and each row's length."""
        if self._csr_order is None:
            order = []
            for t in range(self._nshards):
                c = int(self._tile_nnz[t])
                r = self._rows[t][:c].to(torch.int64)
                order.append((torch.sort(r, stable=True).indices
                              .to(torch.int32),
                              torch.bincount(r, minlength=self._th)))
            self._csr_order = order
        return self._csr_order

    @classmethod
    def from_csr(cls, shape, rowptr, cols, values, *, partition=None,
                 runtime=None):
        """Build from a global CSR triple (sparse_matrix.hpp:286-336)."""
        rowptr = np.asarray(rowptr, np.int64)
        rows = np.repeat(np.arange(shape[0], dtype=np.int64),
                         np.diff(rowptr))
        return cls.from_coo(shape, rows, cols, values,
                            partition=partition, runtime=runtime)

    @classmethod
    def from_dense(cls, dense, *, partition=None, runtime=None):
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return cls.from_coo(dense.shape, rows, cols, dense[rows, cols],
                            partition=partition, runtime=runtime)

    # ------------------------------------------------------------------ meta
    @property
    def shape(self):
        return (self._m, self._n)

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def nnz(self) -> int:
        return self._nnz

    @property
    def nshards(self):
        return self._nshards

    @property
    def tile_rows(self) -> int:
        return self._th

    @property
    def tile_cols(self) -> int:
        return self._tw

    @property
    def grid_shape(self):
        return self._grid

    @property
    def runtime(self):
        return self._rt

    def __len__(self):
        return self._nnz

    # ----------------------------------------------------------- vocabulary
    def __dr_segments__(self):
        segs = []
        gq = self._grid[1]
        for t in range(self._nshards):
            i, j = t // gq, t % gq
            rb = i * self._th
            re = min(self._m, rb + self._th)
            cb = j * self._tw
            ce = min(self._n, cb + self._tw)
            if rb < re and cb < ce and self._tile_nnz[t] > 0:
                segs.append(CsrTileSegment(self, t, rb, re, cb, ce))
        return segs

    def tiles(self):
        return self.__dr_segments__()

    def tile(self, ij) -> CsrTileSegment:
        i, j = (ij if isinstance(ij, tuple) else (ij, 0))
        gp, gq = self._grid
        assert 0 <= i < gp and 0 <= j < gq
        rb, cb = i * self._th, j * self._tw
        return CsrTileSegment(self, i * gq + j,
                              rb, min(self._m, rb + self._th),
                              cb, min(self._n, cb + self._tw))

    # ----------------------------------------------------------- value APIs
    def to_dense(self) -> np.ndarray:
        out = np.zeros((self._m, self._n), dtype=_host_numpy(
            torch.zeros(0, dtype=self._dtype)).dtype)
        for seg in self.__dr_segments__():
            r, c, v = seg.triples()
            np.add.at(out, (r, c), v)
        return out

    def materialize(self):
        return self.to_dense()

    def block_until_ready(self):
        self._rt.fence()
        return self

    def __repr__(self):
        gp, gq = self._grid
        return (f"sparse_matrix(shape={self.shape}, nnz={self._nnz}, "
                f"tiles={gp}x{gq}, dtype={self._dtype})")


def random_sparse_matrix(shape, density=0.01, *, seed=0, partition=None,
                         runtime=None, dtype=np.float32):
    """Random sparse matrix (reference generate_random_csr,
    sparse_matrix.hpp:299-336), the JAX package's draw from the seed."""
    m, n = shape
    rng = np.random.default_rng(seed)
    nnz = max(1, int(m * n * density))
    flat = rng.choice(m * n, size=nnz, replace=False)
    rows, cols = flat // n, flat % n
    vals = rng.standard_normal(nnz).astype(dtype)
    return sparse_matrix.from_coo(shape, rows, cols, vals,
                                  partition=partition, runtime=runtime)
