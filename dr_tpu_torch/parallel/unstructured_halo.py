"""Unstructured (index-list) halo: gather/scatter ghost exchange by index
(counterpart of ``dr_tpu/parallel/unstructured_halo.py``; reference
``index_group`` / ``unstructured_halo``,
``include/dr/details/halo.hpp:148-271``).

``ghost_indices[r]`` lists the global indices rank r mirrors.  The index
plumbing is built once, at construction (the reference's buffer carving,
halo.hpp:27-51): the indices are checked and located as
``(owner rank, column)`` once, each owner gets the columns it serves on
its device, and each ghost rank keeps its buffer on its own device.

* ``exchange()`` refreshes the ghosts from their owners: one gather an
  owner, then per ghost rank the pieces of every owner, concatenated and
  put back in index order by one more gather.
* ``reduce(op)`` folds the ghosts into their owners.  The JAX package
  runs one XLA scatter (``.at[].add/max/min/multiply/set``), whose order
  for duplicate indices is unspecified; the port folds the entries of an
  owner in rounds instead, round d taking the d-th occurrence of every
  column in entry order (the ghost ranks in rank order, each rank's
  indices in the order given).  So ``plus`` and ``multiplies`` fold as
  ``np.add.at`` / ``np.multiply.at`` do, ``second`` is
  last-in-entry-order-wins as numpy's fancy assignment is, ``max`` and
  ``min`` as ``np.maximum.at`` / ``np.minimum.at``; every op gives the
  same bits on every call, and no sum uses atomics.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["unstructured_halo"]

_FOLDS = {
    "plus": torch.add,
    "multiplies": torch.mul,
    "max": torch.maximum,
    "min": torch.minimum,
    "second": lambda old, new: new,
}


def _rounds(cols: torch.Tensor):
    """``[(entries, columns)]`` for each round: round d holds the d-th
    occurrence, in entry order, of every column (so the columns of a
    round are distinct)."""
    n = cols.numel()
    if n == 0:
        return []
    srt = torch.sort(cols, stable=True)
    keys, order = srt.values, srt.indices
    pos = torch.arange(n, device=cols.device)
    new_run = torch.ones(n, dtype=torch.bool, device=cols.device)
    new_run[1:] = keys[1:] != keys[:-1]
    run_start = torch.cummax(torch.where(new_run, pos, 0), 0).values
    occ = pos - run_start
    out = []
    for d in range(int(occ.max()) + 1):
        entries = order[occ == d]
        out.append((entries, cols[entries]))
    return out


class unstructured_halo:
    """Index-list halo over a distributed_vector.

    ``ghost_indices``: per rank r, the global indices of the elements
    (owned by any rank) that rank r mirrors.  After ``exchange()``,
    ``ghost_values(r)`` holds their values on rank r's device; after
    local contributions are written into the ghosts
    (``set_ghost_values``), ``reduce(op)`` folds them into the owners.
    """

    def __init__(self, dv, ghost_indices: Dict[int, Sequence[int]]):
        self._dv = dv
        devs = dv.runtime.devices
        by_rank = {int(r): np.asarray(ix, np.int64)
                   for r, ix in ghost_indices.items() if len(ix)}
        # one flat index list, carved per ghost rank (halo.hpp:27-51)
        self._offsets = {}
        flat = []
        pos = 0
        for r, ix in sorted(by_rank.items()):
            self._offsets[r] = (pos, pos + len(ix))
            flat.append(ix)
            pos += len(ix)
        flat = np.concatenate(flat) if flat else np.zeros(0, np.int64)
        own, col = dv._locate(dv._check_indices(flat)) if len(flat) \
            else (np.zeros(0, np.int64), np.zeros(0, np.int64))
        # per owner o: its entries (flat positions, ascending) and their
        # columns on o's device, and the fold rounds over those columns
        sels = {}
        self._cols = {}
        self._rounds = {}
        for o in np.unique(own):
            o = int(o)
            sels[o] = sel = np.nonzero(own == o)[0]
            self._cols[o] = torch.as_tensor(col[sel], device=devs[o])
            self._rounds[o] = _rounds(self._cols[o])
        # per (ghost rank g, owner o): the slice of o's entries in g's
        # range and their positions in g's buffer, on g's device; per g
        # the gather that puts the owners' pieces back in index order
        self._pieces = {}
        self._order = {}
        for g, (a, b) in self._offsets.items():
            pieces, local = [], []
            for o, sel in sels.items():
                lo, hi = np.searchsorted(sel, (a, b))
                if lo < hi:
                    at = sel[lo:hi] - a
                    pieces.append((o, int(lo), int(hi),
                                   torch.as_tensor(at, device=devs[g])))
                    local.append(at)
            self._pieces[g] = pieces
            self._order[g] = torch.as_tensor(
                np.argsort(np.concatenate(local), kind="stable"),
                device=devs[g])
        self._ghost = {g: torch.zeros(b - a, dtype=dv.dtype, device=devs[g])
                       for g, (a, b) in self._offsets.items()}

    # -- owner -> ghost (exchange, halo.hpp:55-70) -------------------------
    def exchange(self) -> None:
        """Refresh every ghost from its owner."""
        dv = self._dv
        devs = dv.runtime.devices
        served = {o: dv._rows[o][0].index_select(0, cols)
                  for o, cols in self._cols.items()}
        for g, pieces in self._pieces.items():
            parts = [served[o][lo:hi].to(devs[g], non_blocking=True)
                     for o, lo, hi, _ in pieces]
            self._ghost[g] = torch.cat(parts).index_select(0, self._order[g])

    exchange_begin = exchange

    def exchange_finalize(self) -> None:
        self._dv.runtime.fence()

    def ghost_values(self, rank: int) -> torch.Tensor:
        """Rank ``rank``'s ghost buffer, on its device (empty when it
        mirrors nothing)."""
        rank = int(rank)
        if rank not in self._ghost:
            return torch.zeros(0, dtype=self._dv.dtype,
                               device=self._dv.runtime.devices[rank])
        return self._ghost[rank]

    def set_ghost_values(self, rank: int, values) -> None:
        """Write rank ``rank``'s local contributions into its ghosts
        (before a reduce)."""
        from ..containers.distributed_vector import _as_tensor
        rank = int(rank)
        a, b = self._offsets[rank]
        vals = _as_tensor(values).reshape(-1)
        if vals.numel() != b - a:
            raise ValueError(f"rank {rank} mirrors {b - a} indices, got "
                             f"{vals.numel()} values")
        self._ghost[rank] = vals.to(self._dv.runtime.devices[rank],
                                    self._dv.dtype, copy=True)

    # -- ghost -> owner (reduce, halo.hpp:73-110) --------------------------
    def reduce(self, op: str = "plus") -> None:
        """Fold the ghosts into their owners with ``op`` (``plus``,
        ``max``, ``min``, ``multiplies`` or ``second``), duplicate
        indices in entry order."""
        fold = _FOLDS.get(op)
        if fold is None:
            raise ValueError(f"unknown reduction op: {op}")
        dv = self._dv
        devs = dv.runtime.devices
        # every owner's contributions, in entry order, on its device
        contrib = {o: [] for o in self._cols}
        for g, pieces in self._pieces.items():
            for o, _, _, at in pieces:
                contrib[o].append(self._ghost[g].index_select(0, at)
                                  .to(devs[o], non_blocking=True))
        for o, rounds in self._rounds.items():
            vals = torch.cat(contrib[o])
            row = dv._rows[o][0]
            for entries, cols in rounds:
                row.index_copy_(0, cols, fold(row.index_select(0, cols),
                                              vals.index_select(0, entries)))

    reduce_begin = reduce

    def reduce_finalize(self) -> None:
        self._dv.runtime.fence()
