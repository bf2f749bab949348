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

In a multi-process runtime every process is given the same
``ghost_indices`` and builds the same plan of pieces (one a ghost rank
and owner pair), keeping the columns and fold rounds of its own owners
and the buffers of its own ghost ranks.  ``exchange()`` and ``reduce()``
move every piece in one ``collectives.route``, in the same order on
every process and with no header (both ends know a piece's length from
the index lists); a piece within a process stays a device copy.
``ghost_values`` and ``set_ghost_values`` of another process's rank
raise.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from . import collectives

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
        rt = dv.runtime
        devs = rt.devices
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
        # per owner o: its entries (flat positions, ascending) and, for
        # this process's owners, their columns on o's device and the
        # fold rounds over those columns
        sels = {}
        self._cols = {}
        self._rounds = {}
        for o in np.unique(own):
            o = int(o)
            sels[o] = sel = np.nonzero(own == o)[0]
            if rt.is_local(o):
                self._cols[o] = torch.as_tensor(col[sel], device=devs[o])
                self._rounds[o] = _rounds(self._cols[o])
        # the pieces, (ghost rank g, owner o, lo, hi): the slice [lo, hi)
        # of o's entries in g's range, g-major (so an owner's pieces are
        # in entry order), the same list on every process; for this
        # process's ghost ranks, each piece's positions in g's buffer and
        # the gather that puts the owners' pieces back in index order
        self._plan = []
        self._at = {}
        self._order = {}
        for g, (a, b) in self._offsets.items():
            local = []
            for o, sel in sels.items():
                lo, hi = np.searchsorted(sel, (a, b))
                if lo < hi:
                    self._plan.append((g, o, int(lo), int(hi)))
                    local.append(sel[lo:hi] - a)
                    if rt.is_local(g):
                        self._at[len(self._plan) - 1] = torch.as_tensor(
                            local[-1], device=devs[g])
            if rt.is_local(g):
                self._order[g] = torch.as_tensor(
                    np.argsort(np.concatenate(local), kind="stable"),
                    device=devs[g])
        self._ghost = {g: torch.zeros(b - a, dtype=dv.dtype, device=devs[g])
                       for g, (a, b) in self._offsets.items()
                       if rt.is_local(g)}
        # each piece's (shape, dtype): both ends know it, so no header
        self._likes = [((hi - lo,), dv.dtype) for _, _, lo, hi in self._plan]

    # -- owner -> ghost (exchange, halo.hpp:55-70) -------------------------
    def exchange(self) -> None:
        """Refresh every ghost from its owner: every piece in one
        ``collectives.route``, the same moves in the same order on every
        process."""
        dv = self._dv
        served = {o: dv._rows[o][0].index_select(0, cols)
                  for o, cols in self._cols.items()}
        got = collectives.route(
            [(o, g, lambda o=o, lo=lo, hi=hi: served[o][lo:hi])
             for g, o, lo, hi in self._plan], dv.runtime.devices,
            self._likes)
        parts = {g: [] for g in self._ghost}
        for (g, *_), piece in zip(self._plan, got):
            if g in parts:
                parts[g].append(piece)
        for g, pieces in parts.items():
            self._ghost[g] = torch.cat(pieces).index_select(0,
                                                            self._order[g])

    exchange_begin = exchange

    def exchange_finalize(self) -> None:
        self._dv.runtime.fence()

    def _check_local(self, rank: int) -> None:
        rt = self._dv.runtime
        if not rt.is_local(rank):
            raise ValueError(f"rank {rank}'s ghosts live in process "
                             f"{rt.owners[rank]}, not this one")

    def ghost_values(self, rank: int) -> torch.Tensor:
        """Rank ``rank``'s ghost buffer, on its device (empty when it
        mirrors nothing); a rank another process owns raises."""
        rank = int(rank)
        self._check_local(rank)
        if rank not in self._ghost:
            return torch.zeros(0, dtype=self._dv.dtype,
                               device=self._dv.runtime.devices[rank])
        return self._ghost[rank]

    def set_ghost_values(self, rank: int, values) -> None:
        """Write rank ``rank``'s local contributions into its ghosts
        (before a reduce); a rank another process owns raises."""
        from ..containers.distributed_vector import _as_tensor
        rank = int(rank)
        self._check_local(rank)
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
        # every owner's contributions, in entry order, on its device
        got = collectives.route(
            [(g, o, lambda g=g, i=i: self._ghost[g].index_select(
                0, self._at[i]))
             for i, (g, o, _, _) in enumerate(self._plan)],
            dv.runtime.devices, self._likes)
        contrib = {o: [] for o in self._cols}
        for (_, o, _, _), piece in zip(self._plan, got):
            if o in contrib:
                contrib[o].append(piece)
        for o, rounds in self._rounds.items():
            vals = torch.cat(contrib[o])
            row = dv._rows[o][0]
            for entries, cols in rounds:
                row.index_copy_(0, cols, fold(row.index_select(0, cols),
                                              vals.index_select(0, entries)))

    reduce_begin = reduce

    def reduce_finalize(self) -> None:
        self._dv.runtime.fence()
