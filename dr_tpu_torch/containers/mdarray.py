"""``distributed_mdarray`` / ``distributed_mdspan``: N-D distributed arrays.

Counterpart of ``dr_tpu/containers/mdarray.py`` (reference spec pages
``doc/spec/source/containers/distributed_mdarray.rst``,
``views/distributed_mdspan.rst``; the not-built example
``examples/mhp/transpose-cpu.cpp``):

* ``distributed_mdarray(shape)`` — an N-D array block-distributed over
  its leading one or two axes: a 1-D rank list for 1-D arrays, the
  ``factor(P)`` grid (row-major over the ranks) otherwise.  Rank ``r``
  holds one tensor of the padded block shape on its device; the logical
  shape is metadata and the pad is zero;
* ``distributed_mdspan`` — a non-owning N-D window (``submdspan``)
  that re-slices tiles and evaluates lazily.

``transpose(out, in)`` permutes axes.  Where the JAX package leaves it
to an all-to-all under jit, here every destination block is filled from
the source blocks it overlaps: a permute of each piece and a copy to the
destination rank's device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .distributed_vector import _as_tensor, _host_numpy, torch_dtype
from .partition import factor
from ..core.vocabulary import rank as _rank
from ..parallel import runtime as _rt
from ..core.pinning import pinned_id
from ..utils.spmd_guard import TappedCache, dtype_name

#: the mdarray's dispatch cache (the JAX package's ``mdz`` / ``mdp`` /
#: ``mdT`` programs)
_md_cache: dict = TappedCache()

__all__ = ["distributed_mdarray", "distributed_mdspan", "transpose",
           "MdTileSegment"]


def _clip(a, b):
    """Intersection of two boxes (per-dim (begin, end)), or None."""
    out = []
    for (ab, ae), (bb, be) in zip(a, b):
        lo, hi = max(ab, bb), min(ae, be)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


class MdTileSegment:
    """One tile: an N-D box owned by one rank."""

    __slots__ = ("base", "_rank", "box")

    def __init__(self, base, rank, box: Tuple[Tuple[int, int], ...]):
        self.base = base
        self._rank = rank
        self.box = box  # per-dim (begin, end)

    def __dr_rank__(self):
        return self._rank

    def __dr_local__(self):
        return self.base._local_box(self._rank, self.box)

    @property
    def shape(self):
        return tuple(e - b for b, e in self.box)

    def __len__(self):
        return math.prod(self.shape)

    def materialize(self) -> np.ndarray:
        return _host_numpy(self.__dr_local__())

    def __repr__(self):
        return f"MdTileSegment(rank={self._rank}, box={self.box})"


class distributed_mdarray:
    """N-D block-distributed array over the ranks' leading axes."""

    def __init__(self, shape: Sequence[int], dtype=None, *,
                 grid: Optional[Tuple[int, ...]] = None, runtime=None):
        self._rt = runtime or _rt.runtime()
        self._shape = tuple(int(s) for s in shape)
        assert len(self._shape) >= 1
        self._dtype = torch_dtype(dtype)
        P = self._rt.nprocs
        if len(self._shape) == 1:
            grid = (P,)
        elif grid is None:
            grid = factor(P)
        self._grid = tuple(grid)
        if math.prod(self._grid) > P:
            raise ValueError(f"grid {self._grid} needs more than the "
                             f"runtime's {P} ranks")
        # tile sizes along the distributed leading axes
        self._tsizes = tuple(-(-self._shape[d] // self._grid[d])
                             if self._shape[d] else 1
                             for d in range(len(self._grid)))
        self._block = self._tsizes + self._shape[len(self._grid):]
        _md_cache.tap(("mdz", pinned_id(self._rt), self._padded,
                       dtype_name(self._dtype)))
        self._blocks = [torch.zeros(self._block, dtype=self._dtype, device=d)
                        for d in self._rt.devices[:math.prod(self._grid)]]
        self._rt.register(self)

    # ------------------------------------------------------------------ meta
    @property
    def shape(self):
        return self._shape

    @property
    def _padded(self):
        """The padded global shape (the JAX array's)."""
        g = len(self._grid)
        return tuple(t * q for t, q in zip(self._tsizes, self._grid)) + \
            self._shape[g:]

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def grid(self):
        return self._grid

    @property
    def runtime(self):
        return self._rt

    @property
    def blocks(self):
        """The per-rank padded blocks, rank order (grid row-major)."""
        return list(self._blocks)

    def __len__(self):
        return math.prod(self._shape)

    def _origin(self, rank: int):
        """First logical index of rank's block along every axis."""
        cell = np.unravel_index(rank, self._grid)
        return tuple(int(c) * t for c, t in zip(cell, self._tsizes)) + \
            (0,) * (len(self._shape) - len(self._grid))

    # ----------------------------------------------------------- vocabulary
    def __dr_segments__(self):
        segs = []
        for r in range(len(self._blocks)):
            box = tuple((o, min(o + b, s)) for o, b, s in
                        zip(self._origin(r), self._block, self._shape))
            if all(b < e for b, e in box[:len(self._grid)]):
                segs.append(MdTileSegment(self, r, box))
        return segs

    def _local_box(self, rank, box):
        org = self._origin(rank)
        return self._blocks[rank][tuple(slice(b - o, e - o)
                                        for (b, e), o in zip(box, org))]

    # ----------------------------------------------------------- value APIs
    def to_array(self) -> torch.Tensor:
        """The logical value on rank 0's device."""
        dev = self._rt.devices[0]
        blocks = [b.to(dev) for b in self._blocks]
        if len(self._grid) == 1:
            padded = torch.cat(blocks, dim=0)
        else:
            gq = self._grid[1]
            padded = torch.cat([torch.cat(blocks[i * gq:(i + 1) * gq], dim=1)
                                for i in range(self._grid[0])], dim=0)
        return padded[tuple(slice(0, s) for s in self._shape)]

    def assign_array(self, values) -> None:
        values = _as_tensor(values)
        assert tuple(values.shape) == self._shape
        _md_cache.tap(("mdp", pinned_id(self._rt), self._padded,
                       self._shape, dtype_name(self._dtype)))
        blocks = []
        for r, d in enumerate(self._rt.devices[:len(self._blocks)]):
            blk = torch.zeros(self._block, dtype=self._dtype, device=d)
            box = tuple((o, min(o + b, s)) for o, b, s in
                        zip(self._origin(r), self._block, self._shape))
            if all(b < e for b, e in box):
                blk[tuple(slice(0, e - b) for b, e in box)] = values[
                    tuple(slice(b, e) for b, e in box)].to(d, self._dtype)
            blocks.append(blk)
        self._blocks = blocks

    @classmethod
    def from_array(cls, values, *, grid=None, runtime=None):
        values = _as_tensor(values)
        md = cls(tuple(values.shape), values.dtype, grid=grid,
                 runtime=runtime)
        md.assign_array(values)
        return md

    def materialize(self) -> np.ndarray:
        return _host_numpy(self.to_array())

    def mdspan(self) -> "distributed_mdspan":
        return distributed_mdspan(
            self, tuple((0, s) for s in self._shape))

    def submdspan(self, *slices) -> "distributed_mdspan":
        return self.mdspan().submdspan(*slices)

    def _locate(self, idx):
        """Logical element index -> (rank, index in its block)."""
        cell = tuple(i // t for i, t in zip(idx, self._tsizes))
        rank = int(np.ravel_multi_index(cell, self._grid))
        return rank, tuple(i - o for i, o in zip(idx, self._origin(rank)))

    def _element(self, key):
        idx = tuple(int(k) for k in (key if isinstance(key, tuple)
                                     else (key,)))
        if len(idx) != len(self._shape):
            raise IndexError(idx)
        for d, i in enumerate(idx):
            if not 0 <= i < self._shape[d]:
                raise IndexError(idx)
        return self._locate(idx)

    def __getitem__(self, key):
        if isinstance(key, tuple) and any(isinstance(k, slice) for k in key):
            return self.submdspan(*key)
        rank, loc = self._element(key)
        return self._blocks[rank][loc].item()

    def __setitem__(self, key, value) -> None:
        rank, loc = self._element(key)
        self._blocks[rank][loc] = value

    def block_until_ready(self):
        self._rt.fence()
        return self

    def __repr__(self):
        return (f"distributed_mdarray(shape={self._shape}, "
                f"grid={self._grid}, dtype={self._dtype})")


class distributed_mdspan:
    """Non-owning N-D window over a distributed_mdarray
    (spec: views/distributed_mdspan.rst)."""

    def __init__(self, base: distributed_mdarray,
                 box: Tuple[Tuple[int, int], ...]):
        self.base = base
        self.box = box

    @property
    def shape(self):
        return tuple(e - b for b, e in self.box)

    def __len__(self):
        return math.prod(self.shape)

    def submdspan(self, *slices) -> "distributed_mdspan":
        box = list(self.box)
        for d, sl in enumerate(slices):
            b, e = self.box[d]
            if isinstance(sl, slice):
                s0, s1, step = sl.indices(e - b)
                assert step == 1
                box[d] = (b + s0, b + s1)
            else:
                box[d] = (b + int(sl), b + int(sl) + 1)
        return distributed_mdspan(self.base, tuple(box))

    def __dr_segments__(self):
        out = []
        for t in self.base.__dr_segments__():
            clipped = _clip(t.box, self.box)
            if clipped is not None:
                out.append(MdTileSegment(self.base, _rank(t), clipped))
        return out

    def to_array(self):
        sl = tuple(slice(b, e) for b, e in self.box)
        return self.base.to_array()[sl]

    def materialize(self) -> np.ndarray:
        return _host_numpy(self.to_array())

    def __repr__(self):
        return f"distributed_mdspan(box={self.box})"


def transpose(out: distributed_mdarray, inp: distributed_mdarray,
              axes=None) -> None:
    """out = inp permuted by ``axes`` (default: reversed — ``inp.T``) —
    the reference's planned-but-unbuilt transpose example generalized
    to N-D (examples/mhp/transpose-cpu.cpp:27-54 is the 2-D case).

    Each destination block is rebuilt from the source blocks its box
    overlaps: every overlapping piece is permuted and copied to the
    destination rank's device.  Nothing is gathered onto one rank."""
    nd = len(inp.shape)
    if axes is None:
        axes = tuple(range(nd - 1, -1, -1))
    else:
        # normalize negatives only; out-of-range axes are an error like
        # numpy's AxisError, not a silent wrap into another permutation
        assert all(-nd <= int(a) < nd for a in axes), \
            f"axes out of range for a {nd}-D array: {tuple(axes)}"
        axes = tuple(int(a) % nd for a in axes)
    assert sorted(axes) == list(range(nd)), \
        f"axes must permute all {nd} dimensions"
    assert out.shape == tuple(inp.shape[a] for a in axes), \
        "output shape must be the permuted input shape"
    _md_cache.tap(("mdT", pinned_id(inp._rt), inp.shape, axes,
                   dtype_name(inp.dtype)))
    src = inp.__dr_segments__()
    blocks = []
    for r, blk in enumerate(out._blocks):
        blk = torch.zeros_like(blk)
        org = out._origin(r)
        obox = tuple((o, min(o + b, s)) for o, b, s in
                     zip(org, out._block, out.shape))
        # the same box in the input's axis order: out dim k is in dim axes[k]
        ibox = [None] * nd
        for k in range(nd):
            ibox[axes[k]] = obox[k]
        for seg in src:
            inter = _clip(seg.box, ibox)
            if inter is None:
                continue
            piece = inp._local_box(_rank(seg), inter).permute(axes)
            blk[tuple(slice(inter[axes[k]][0] - org[k],
                            inter[axes[k]][1] - org[k])
                      for k in range(nd))] = piece.to(blk.device)
        blocks.append(blk)
    out._blocks = blocks
