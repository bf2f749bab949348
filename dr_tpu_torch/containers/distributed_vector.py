"""``distributed_vector``: 1-D block-distributed vector over rank rows.

Counterpart of ``dr_tpu/containers/distributed_vector.py`` (reference
``mhp::distributed_vector``, dv.hpp:176-238).  The vector owns one
padded row tensor per rank, shape ``(1, prev + seg + next)``, on that
rank's device: ``[ghost_prev | owned | ghost_next]``, with
``seg = max(ceil(n/p), prev, next)`` (dv.hpp:190-193).  The last row
is padded; logical size ``n`` is metadata.  The layout tuple
``(nshards, seg, prev, next, n)`` and the ghost placement are the JAX
package's, so the two packages' rows can be compared rank by rank, and
``from_reference_state`` builds a port container from a JAX
container's rows.

Unlike the JAX arrays, the rows are mutable: algorithms update them in
place where that saves a copy.

Host reads and writes of a vector (``to_array``, ``get``, ``put``,
indexing, ``materialize``, ``assign_array``) flush a recording deferred
plan first when its queue touches the vector (``plan.flush_reads``).
``_rows`` is a property so that the plan verifier's container watcher
(``utils/sanitize.watch_containers``) sees every read and rebind; with
no watcher armed it costs one module-global check.

Allocating the rows, :meth:`~distributed_vector.to_array` and
:meth:`~distributed_vector.assign_array` look up ``_jit_cache`` (the
dispatch tap of ``utils/spmd_guard``) with the JAX package's keys for
its layout programs (``zeros``, ``extract``, ``pack`` and their uneven
forms).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.pinning import pinned_id
from ..core.segment import Segment
from ..utils import sanitize as _sanitize
from ..utils.spmd_guard import TappedCache, dtype_name
from ..parallel import runtime as _rt
from ..parallel.halo import halo_bounds, span_halo
from .distribution import block_distribution

__all__ = ["distributed_vector", "halo", "from_reference_state",
           "torch_dtype"]

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """Normalize a dtype spec (None/float/int, numpy, torch, or a name
    such as ``"bfloat16"``) to a ``torch.dtype``."""
    if dtype is None or dtype is float:
        return torch.float32
    if dtype is int:
        return torch.int32
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return _NP_TO_TORCH[np.dtype(dtype)]


def _as_tensor(values) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values
    arr = np.asarray(values)
    if str(arr.dtype) == "bfloat16":  # ml_dtypes arrays
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    if not arr.flags.writeable:  # e.g. np.asarray of a jax.Array
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr))


def _plan_flush(reason: str, cont=None) -> None:
    """Pending recorded ops land before a host read or write; with
    ``cont``, only when the plan's queue touches it.  Lazy import: the
    plan module builds on the algorithm layer above this one."""
    from ..plan import flush_reads
    flush_reads(reason, cont)


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class distributed_vector:
    """1-D block-distributed vector with optional halo regions."""

    def __init__(self, size: int, dtype=None,
                 halo: Optional[halo_bounds] = None, *, distribution=None,
                 runtime=None):
        self._n = int(size)
        self._dtype = torch_dtype(dtype)
        self._hb = halo or halo_bounds()
        self._rebind(runtime or _rt.runtime(), distribution)

    def _rebind(self, runtime, distribution, *, _rows=None) -> None:
        """(Re)plan the block layout onto ``runtime``'s ranks and
        (re)allocate the rows, or adopt ``_rows``.  ``__init__`` is one
        caller; ``redistribute`` is the other, which re-plans a live
        vector in place: size, dtype and halo bounds stay, the layout is
        rebuilt, and the caller moves the value.

        Validation runs on locals first, and a late failure (the halo's
        size checks, an allocation) rolls every attribute back: a
        rejected re-layout leaves the vector exactly as it was."""
        P = runtime.nprocs
        if distribution is not None and not isinstance(distribution,
                                                       block_distribution):
            distribution = block_distribution(distribution)
        if distribution is not None:
            if len(distribution.sizes) != P:
                raise ValueError(
                    f"distribution has {len(distribution.sizes)} blocks "
                    f"for a {P}-shard mesh")
            if distribution.n != self._n:
                raise ValueError(
                    f"distribution sizes sum to {distribution.n}, "
                    f"vector size is {self._n}")
        dist_entry = (distribution.layout_entry()
                      if distribution is not None else None)
        if isinstance(dist_entry, int):
            dist_entry = None  # even sizes == default layout
        if dist_entry is not None and self._hb.width:
            raise ValueError("halo_bounds require the uniform block "
                             "distribution (the halo exchange ring assumes "
                             "equal shards)")
        if dist_entry is not None:
            sizes = np.asarray(dist_entry[1:], dtype=np.int64)
            seg = max(int(sizes.max(initial=0)), self._hb.prev,
                      self._hb.next, 1)
            starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
        else:
            seg = max(-(-self._n // P) if self._n else 1,
                      self._hb.prev, self._hb.next, 1)
            starts = sizes = None
        prior = {k: self.__dict__.get(k)
                 for k in ("_rt", "_nshards", "_dist_entry", "_seg",
                           "_starts", "_sizes", "_rows_arr", "_halo")}
        try:
            self._rt = runtime
            self._nshards = P
            self._dist_entry = dist_entry
            self._seg = seg
            self._starts = starts
            self._sizes = sizes
            if _rows is None:
                _jit_cache.tap(("zeros", pinned_id(runtime), P,
                                self.block_width, dtype_name(self._dtype)))
                _rows = [torch.zeros((1, self.block_width),
                                     dtype=self._dtype, device=d)
                         for d in runtime.devices]
            self._rows = _rows
            self._halo = span_halo(self) if self._hb.width else None
        except BaseException:
            if prior["_rt"] is not None:  # a live re-layout, not __init__
                self.__dict__.update(prior)
            raise
        if prior["_rt"] is None and _sanitize._born_hook is not None:
            _sanitize._born_hook(self)
        runtime.register(self)

    @property
    def _rows(self):
        """The per-rank rows (watched: see the module docstring)."""
        h = _sanitize._access_hook
        if h is not None:
            h("r", self)
        return self._rows_arr

    @_rows.setter
    def _rows(self, value):
        h = _sanitize._access_hook
        if h is not None:
            h("w", self)
        self._rows_arr = value

    # ------------------------------------------------------------------ meta
    @property
    def runtime(self):
        return self._rt

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def halo_bounds(self) -> halo_bounds:
        return self._hb

    @property
    def segment_size(self) -> int:
        return self._seg

    @property
    def nshards(self) -> int:
        return self._nshards

    @property
    def block_width(self) -> int:
        """Per-rank row width: prev + seg + next."""
        return self._hb.prev + self._seg + self._hb.next

    @property
    def layout(self):
        """Alignment key ``(nshards, seg or size tuple, prev, next, n)``:
        equal layouts => pairwise equal segment lists."""
        return (self._nshards, self._dist_entry or self._seg,
                self._hb.prev, self._hb.next, self._n)

    @property
    def distribution(self):
        if self._dist_entry is None:
            return None
        return block_distribution(self._dist_entry[1:])

    @property
    def rows(self):
        """The per-rank padded row tensors (ghosts included)."""
        return list(self._rows)

    def _rank_window(self, r: int):
        """Rank r's logical [begin, end) window."""
        if self._starts is not None:
            b = int(self._starts[r])
            return b, b + int(self._sizes[r])
        b = r * self._seg
        return min(b, self._n), min(self._n, b + self._seg)

    def __len__(self) -> int:
        return self._n

    @property
    def size(self) -> int:
        return self._n

    # ----------------------------------------------------------- vocabulary
    def __dr_segments__(self):
        segs = []
        for r in range(self._nshards):
            begin, end = self._rank_window(r)
            if begin < end:
                segs.append(Segment(self, r, begin, end))
        return segs

    def halo(self) -> span_halo:
        if self._halo is None:
            raise ValueError("distributed_vector built without halo_bounds")
        return self._halo

    # ----------------------------------------------------------- value APIs
    def _tap(self, kind: str) -> None:
        """The dispatch tap of a layout program (``extract`` / ``pack``;
        ``extract_u`` / ``pack_u`` for an uneven distribution)."""
        dt = dtype_name(self._dtype)
        if self._dist_entry is not None:
            _jit_cache.tap((kind + "_u", pinned_id(self._rt), self.layout,
                            dt))
        else:
            _jit_cache.tap((kind, pinned_id(self._rt), self._nshards,
                            self._seg, self._hb.prev, self._hb.next,
                            self._n, dt))

    def to_array(self) -> torch.Tensor:
        """Current logical value as a 1-D tensor on rank 0's device."""
        _plan_flush("to_array", self)
        self._tap("extract")
        prev = self._hb.prev
        dev = self._rt.devices[0]
        parts = []
        for r, row in enumerate(self._rows):
            b, e = self._rank_window(r)
            if b < e:
                parts.append(row[0, prev:prev + e - b].to(dev))
        if not parts:
            return torch.zeros((0,), dtype=self._dtype, device=dev)
        return torch.cat(parts)

    def assign_array(self, values) -> None:
        """Rebind the whole logical value (ghost and pad cells reset to
        zero)."""
        values = _as_tensor(values)
        assert values.shape == (self._n,)
        _plan_flush("assign_array", self)
        self._tap("pack")
        prev = self._hb.prev
        rows = []
        for r, d in enumerate(self._rt.devices):
            b, e = self._rank_window(r)
            row = torch.zeros((1, self.block_width), dtype=self._dtype,
                              device=d)
            if b < e:
                row[0, prev:prev + e - b] = values[b:e].to(d, self._dtype)
            rows.append(row)
        self._rows = rows

    @classmethod
    def from_array(cls, values, halo: Optional[halo_bounds] = None, *,
                   distribution=None, runtime=None) -> "distributed_vector":
        values = _as_tensor(values)
        dv = cls(values.shape[0], values.dtype, halo,
                 distribution=distribution, runtime=runtime)
        dv.assign_array(values)
        return dv

    def _local_values(self, rank: int, begin: int, end: int):
        _plan_flush("local segment read", self)
        lo = self._rank_window(rank)[0]
        prev = self._hb.prev
        return self._rows[rank][0, prev + (begin - lo): prev + (end - lo)]

    # ------------------------------------------------ element/batched access
    def _locate(self, idx: np.ndarray):
        if self._starts is not None:
            r = np.searchsorted(self._starts, idx, side="right") - 1
            return r, self._hb.prev + idx - self._starts[r]
        return idx // self._seg, self._hb.prev + idx % self._seg

    def _check_indices(self, indices) -> np.ndarray:
        """Bounds-check a host-side index batch (numpy negative-index
        convention; out of range raises IndexError)."""
        orig = np.asarray(indices).reshape(-1)
        idx = np.where(orig < 0, orig + self._n, orig)
        bad = (idx < 0) | (idx >= self._n)
        if bad.any():
            raise IndexError(
                f"index {int(orig[bad][0])} out of range "
                f"for distributed_vector of size {self._n}")
        return idx.astype(np.int64)

    def get(self, indices) -> torch.Tensor:
        """Batched read, gathered onto rank 0's device."""
        _plan_flush("get", self)
        idx = self._check_indices(indices)
        r, c = self._locate(idx)
        dev = self._rt.devices[0]
        out = torch.empty((len(idx),), dtype=self._dtype, device=dev)
        for rr in np.unique(r):
            sel = np.nonzero(r == rr)[0]
            cols = torch.as_tensor(c[sel], device=self._rows[rr].device)
            out[torch.as_tensor(sel, device=dev)] = \
                self._rows[rr][0, cols].to(dev)
        return out

    def put(self, indices, values) -> None:
        """Batched write."""
        _plan_flush("put", self)
        idx = self._check_indices(indices)
        vals = _as_tensor(values).reshape(-1)
        if vals.numel() == 1 and len(idx) != 1:
            vals = vals.expand(len(idx))
        r, c = self._locate(idx)
        for rr in np.unique(r):
            sel = np.nonzero(r == rr)[0]
            row = self._rows[rr]
            row[0, torch.as_tensor(c[sel], device=row.device)] = \
                vals[torch.as_tensor(sel, device=vals.device)].to(
                    row.device, self._dtype)

    def __getitem__(self, key):
        if isinstance(key, slice):
            from ..views.views import subrange
            start, stop, step = key.indices(self._n)
            assert step == 1, "stride-1 subranges only"
            return subrange(self, start, stop)
        _plan_flush("__getitem__", self)
        i = int(key)
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self.get([i])[0].item()

    def __setitem__(self, key, value) -> None:
        _plan_flush("__setitem__", self)
        if isinstance(key, slice):
            start, stop, step = key.indices(self._n)
            assert step == 1
            self.put(np.arange(start, stop), value)
            return
        i = int(key)
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        self.put([i], [value])

    def __iter__(self):
        return iter(self.materialize())

    def materialize(self) -> np.ndarray:
        _plan_flush("materialize", self)
        return _host_numpy(self.to_array())

    def block_until_ready(self) -> "distributed_vector":
        _plan_flush("block_until_ready")
        self._rt.fence()
        return self

    def __repr__(self):
        return (f"distributed_vector(n={self._n}, dtype={self._dtype}, "
                f"shards={self._nshards}x{self.block_width}, hb={self._hb})")


#: the vector's dispatch cache (the JAX package's layout programs)
_jit_cache: dict = TappedCache()


def from_reference_state(layout, hb: halo_bounds, rows: np.ndarray, *,
                         runtime=None) -> distributed_vector:
    """Build a port container holding exactly the state of a JAX
    container: ``layout`` is its ``layout`` tuple, ``hb`` its halo
    bounds (the port's or the JAX package's dataclass), ``rows`` its
    padded per-rank rows as numpy, ghosts included
    (``np.asarray(dv._data)``).  Both packages then step the same bits."""
    nshards, seg, prev, nxt, n = layout
    hb = halo_bounds(hb.prev, hb.next, hb.periodic)
    assert (prev, nxt) == (hb.prev, hb.next), "layout/halo mismatch"
    dist = None if isinstance(seg, int) else block_distribution(seg[1:])
    rows = np.asarray(rows)
    dv = distributed_vector(n, rows.dtype, hb, distribution=dist,
                            runtime=runtime)
    if dv.layout != tuple(layout):
        raise ValueError(f"layout {layout} does not fit the runtime "
                         f"({dv.layout})")
    assert rows.shape == (nshards, dv.block_width), rows.shape
    t = _as_tensor(rows)
    dv._rows = [t[r:r + 1].to(d, dv.dtype).clone()
                for r, d in enumerate(dv.runtime.devices)]
    return dv


def halo(dr) -> span_halo:
    """The halo of the distributed_vector underlying any view over it."""
    obj = dr
    seen = set()
    while obj is not None and id(obj) not in seen:
        seen.add(id(obj))
        if isinstance(obj, distributed_vector):
            return obj.halo()
        obj = getattr(obj, "base", None)
    raise TypeError("halo(): no underlying distributed_vector")
