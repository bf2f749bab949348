"""2-D stencil (heat equation) over a tiled dense_matrix.

Counterpart of ``dr_tpu/algorithms/stencil2d.py``, the BASELINE.json
config-4 workload ("2D mdspan heat-equation stencil, tiled segments on a
2D mesh").

* ``stencil2d_transform`` / ``stencil2d_iterate``: one weighted step per
  step on every tile, in plain PyTorch on the tile's rank.  The JAX
  package leaves the cross-tile halos to GSPMD; here each tile keeps an
  extended copy with a ghost ring as wide as the weights' radius, and
  before each step the ring is refilled from the neighbouring tiles
  through ``parallel/collectives.py`` copies: edge columns first, then
  edge rows of the extended width, which carries the four corner cells
  with them.  Nothing is gathered onto one rank.  Tiles are the logical
  tiles of the partition, so block and block-cyclic layouts take the
  same route (a cyclic rank simply holds several tiles).
* ``stencil2d_iterate_blocked`` / ``stencil2d_n``: ``time_block`` steps
  per pass of K5 (``ops/stencil2d_pallas.py``) on a single-tile matrix,
  padded once by ``time_block`` rows.

The frozen edge is the LOGICAL last row and column (m-1, n-1), which may
lie inside the last tile: only cells with a full neighbourhood inside
[0, m) x [0, n) are written, so pad cells never feed an owned cell.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch.nn.functional as F

from ..containers.dense_matrix import dense_matrix
from ..parallel import collectives

__all__ = ["stencil2d_transform", "stencil2d_iterate",
           "stencil2d_iterate_blocked", "stencil2d_n",
           "heat_step_weights"]


def heat_step_weights(alpha: float = 0.25):
    """Classic 5-point heat kernel: u += alpha * laplacian(u)."""
    return [[0.0, alpha, 0.0],
            [alpha, 1.0 - 4.0 * alpha, alpha],
            [0.0, alpha, 0.0]]


class _Tiles:
    """The logical tiles of a matrix with the geometry of one stencil:
    tile k = (i, j) in row-major order, its rank's device, and the
    interior rectangle of its own (th, tw) block."""

    def __init__(self, mat: dense_matrix, weights):
        w = np.asarray(weights, dtype=np.float64)
        kh, kw = w.shape
        assert kh % 2 == 1 and kw % 2 == 1
        self.rh, self.rw = kh // 2, kw // 2
        self.taps = [(di, dj, float(w[di, dj])) for di in range(kh)
                     for dj in range(kw) if w[di, dj] != 0.0]
        m, n = mat.shape
        self.th, self.tw = mat.tile_shape
        assert self.th >= self.rh and self.tw >= self.rw, \
            "tiles narrower than the stencil radius"
        self.nti, self.ntj = mat.grid_tiles
        self.ij = [(i, j) for i in range(self.nti) for j in range(self.ntj)]
        self.devices = [mat.runtime.devices[mat.partition.tile_rank(i, j)]
                        for i, j in self.ij]
        # interior cells (a full neighbourhood inside the logical matrix)
        # of each tile, in its own block's coordinates
        self.box = [(max(self.rh - i * self.th, 0),
                     min(m - self.rh - i * self.th, self.th),
                     max(self.rw - j * self.tw, 0),
                     min(n - self.rw - j * self.tw, self.tw))
                    for i, j in self.ij]

    def views(self, mat: dense_matrix):
        return [mat._tile_block(i, j)[1] for i, j in self.ij]

    def extended(self, mat: dense_matrix):
        """Per tile a (th + 2rh, tw + 2rw) copy with a zero ghost ring."""
        out = []
        for v in self.views(mat):
            e = v.new_zeros((self.th + 2 * self.rh, self.tw + 2 * self.rw))
            self.centre(e).copy_(v)
            out.append(e)
        return out

    def centre(self, e):
        return e[self.rh:self.rh + self.th, self.rw:self.rw + self.tw]

    def exchange(self, ext) -> None:
        """Refill every ghost ring from the neighbouring tiles: columns
        over the tile's own rows, then rows over the extended width (the
        corners ride along).  Rings on the matrix border stay as they
        are; no interior cell reads them."""
        th, tw, rh, rw, ntj = self.th, self.tw, self.rh, self.rw, self.ntj

        def k(i, j):
            return i * ntj + j

        def move(src, dst, pairs):
            recv = collectives.ppermute([src(e) for e in ext], pairs,
                                        self.devices)
            for e, r in zip(ext, recv):
                if r is not None:
                    dst(e).copy_(r)

        if rw:
            east = [(k(i, j), k(i, j + 1)) for i in range(self.nti)
                    for j in range(ntj - 1)]
            move(lambda e: e[rh:rh + th, tw:tw + rw],
                 lambda e: e[rh:rh + th, :rw], east)
            move(lambda e: e[rh:rh + th, rw:2 * rw],
                 lambda e: e[rh:rh + th, rw + tw:], [(b, a) for a, b in east])
        if rh:
            south = [(k(i, j), k(i + 1, j)) for i in range(self.nti - 1)
                     for j in range(ntj)]
            move(lambda e: e[th:th + rh, :], lambda e: e[:rh, :], south)
            move(lambda e: e[rh:2 * rh, :], lambda e: e[rh + th:, :],
                 [(b, a) for a, b in south])

    def step(self, ext, dst) -> None:
        """dst[t] interior = weighted sum over ext[t]; the rest of dst
        keeps its values.  ``acc = w*u`` then ``acc = acc + w*u`` in
        (di, dj) order, as the JAX step sums."""
        for e, d, (ra, rb, ca, cb) in zip(ext, dst, self.box):
            if ra >= rb or ca >= cb:
                continue
            acc = None
            for di, dj, wij in self.taps:
                term = e[ra + di:rb + di, ca + dj:cb + dj] * wij
                acc = term if acc is None else acc + term
            d[ra:rb, ca:cb] = acc if acc is not None else 0


def stencil2d_transform(in_mat: dense_matrix, out_mat: dense_matrix,
                        weights: Sequence[Sequence[float]]) -> None:
    """One interior stencil step: out[i,j] = sum w[di,dj]*in[i+di,j+dj].

    Edges (positions without a full neighbourhood) keep out_mat's values,
    matching the 1-D interior contract."""
    assert in_mat.shape == out_mat.shape and in_mat.layout == out_mat.layout
    tiles = _Tiles(in_mat, weights)
    ext = tiles.extended(in_mat)
    tiles.exchange(ext)
    tiles.step(ext, tiles.views(out_mat))


def stencil2d_iterate(a: dense_matrix, b: dense_matrix,
                      weights, steps: int) -> dense_matrix:
    """``steps`` stencil steps, double-buffered: each step writes the
    interior of the other buffer from this one.  Returns ``a`` holding
    the final state (``b`` holds the other buffer)."""
    assert a.shape == b.shape and a.layout == b.layout
    tiles = _Tiles(a, weights)
    x, y = tiles.extended(a), tiles.extended(b)
    for _ in range(steps):
        tiles.exchange(x)
        tiles.step(x, [tiles.centre(e) for e in y])
        x, y = y, x
    for mat, ext in ((a, x), (b, y)):
        for v, e in zip(tiles.views(mat), ext):
            v.copy_(tiles.centre(e))
    return a


def _single_tile(a: dense_matrix, weights):
    assert np.asarray(weights).shape == (3, 3), "blocked path is 3x3"
    assert a.grid_shape == (1, 1) and a.is_block, \
        "blocked 2-D stencil runs on a single-tile matrix"
    return a.shape[0]


def stencil2d_iterate_blocked(a: dense_matrix, weights, steps: int, *,
                              time_block: int = 16,
                              band: int = None) -> dense_matrix:
    """Temporally blocked 2-D stencil (K5, ops/stencil2d_pallas.py):
    ``time_block`` steps per pass over the data, then one pass of the
    remainder.

    Contract: 3x3 weights, frozen (Dirichlet) edges — equivalent to
    ``stencil2d_iterate`` when both its buffers share edge values (the
    usual both-from-src setup).  Requires a single-tile matrix; multi-tile
    grids use ``stencil2d_iterate``."""
    from ..ops import stencil2d_pallas
    m = _single_tile(a, weights)
    pad = time_block  # covers the remainder pass too (rest < time_block)
    # pad ONCE and keep the padded layout across passes: pad-row contents
    # are irrelevant (frozen edges stop the dependency cone)
    xp = F.pad(a._shards[0], (0, 0, pad, pad))
    nfull, rest = divmod(steps, time_block)
    for nst in [time_block] * nfull + ([rest] if rest else []):
        xp = stencil2d_pallas.blocked_stencil2d_padded(
            xp, m, weights, nst, pad, band=band)
    a._shards[0] = xp[pad:pad + m]
    return a


def stencil2d_n(a: dense_matrix, weights, iters: int, *,
                time_block: int = 16) -> dense_matrix:
    """``iters`` full time blocks of the blocked 2-D stencil: pad, one K5
    launch per block with no host sync in between, unpad.  Applies
    exactly ``iters * time_block`` steps with the frozen-edge contract of
    :func:`stencil2d_iterate_blocked`."""
    from ..ops import stencil2d_pallas
    m = _single_tile(a, weights)
    pad = time_block
    xp = F.pad(a._shards[0], (0, 0, pad, pad))
    for _ in range(iters):
        xp = stencil2d_pallas.blocked_stencil2d_padded(
            xp, m, weights, time_block, pad)
    a._shards[0] = xp[pad:pad + m]
    return a
