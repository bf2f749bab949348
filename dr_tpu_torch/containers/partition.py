"""Matrix partitions: how 2-D containers map onto the ranks.

Counterpart of ``dr_tpu/containers/partition.py`` (reference
``shp/containers/matrix_partition.hpp:23-86`` and ``detail::factor``,
``shp/containers/detail.hpp:15-24``):

* ``matrix_partition`` — abstract placement: grid shape, tile shape,
  tile -> rank;
* ``block_cyclic`` — tiles placed round-robin over a rank grid, with
  ``tile.div`` meaning "divide each dimension evenly by the grid" (the
  default, which makes block-cyclic collapse to plain 2-D block).

Where the JAX package views its devices as a 2-D mesh, a grid here is
the runtime's rank list read row-major: grid cell (i, j) is rank
``i * gq + j``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["tile", "matrix_partition", "block_cyclic", "row_tiles", "factor"]


def factor(n: int) -> Tuple[int, int]:
    """Near-square factorization n = p*q, p <= q (detail.hpp:15-24)."""
    p = int(math.isqrt(n))
    while n % p:
        p -= 1
    return (p, n // p)


class tile:
    """Tile-shape placeholder: ``tile.div`` = divide evenly by the grid
    (shp/containers/matrix_partition.hpp:34-45)."""
    div = -1


class matrix_partition:
    """Abstract partition (matrix_partition.hpp:23-32)."""

    def grid_shape(self) -> Tuple[int, int]:
        raise NotImplementedError

    def tile_shape(self, matrix_shape) -> Tuple[int, int]:
        raise NotImplementedError

    def tile_rank(self, i: int, j: int) -> int:
        """Rank owning grid tile (i, j)."""
        raise NotImplementedError

    def clone(self) -> "matrix_partition":
        return self


@dataclass(frozen=True)
class block_cyclic(matrix_partition):
    """Round-robin tile placement over a rank grid
    (matrix_partition.hpp:34-86).  With ``tile.div`` (default) each rank
    owns exactly one contiguous block — the reference's default."""

    tile: Tuple[int, int] = (tile.div, tile.div)
    grid: Optional[Tuple[int, int]] = None

    def grid_for(self, nprocs: int) -> Tuple[int, int]:
        return self.grid if self.grid is not None else factor(nprocs)

    def grid_shape(self) -> Tuple[int, int]:
        assert self.grid is not None
        return self.grid

    def tile_shape(self, matrix_shape) -> Tuple[int, int]:
        m, n = matrix_shape
        gp, gq = self.grid_shape()
        th = -(-m // gp) if self.tile[0] == tile.div else self.tile[0]
        tw = -(-n // gq) if self.tile[1] == tile.div else self.tile[1]
        return (th, tw)

    def tile_rank(self, i: int, j: int) -> int:
        gp, gq = self.grid_shape()
        return (i % gp) * gq + (j % gq)

    def is_block(self) -> bool:
        """True when tile.div: one tile per rank = plain 2-D block."""
        return self.tile == (tile.div, tile.div)


def row_tiles(nprocs: Optional[int] = None) -> block_cyclic:
    """Row-stripe partition (grid (p, 1)) — the shape the reference's gemv
    requires (shp/algorithms/gemv.hpp:21)."""
    if nprocs is None:
        from ..parallel import runtime as _rt
        nprocs = _rt.nprocs()
    return block_cyclic(grid=(nprocs, 1))
