"""Collectives over rank rows: the single-process counterparts of
``lax.ppermute`` / ``lax.all_gather`` / ``lax.all_to_all`` /
``lax.psum``.

Every rank's value is a tensor on that rank's device; a collective is a
set of tensor copies (``Tensor.to``) and sums between them.  Ranks that
share a device exchange by plain reference, ranks on different devices
by a device-to-device copy.  :func:`ordered_minimum` /
:func:`ordered_maximum` are the min/max combines of partials (the
reduce fold, the halo's ghost-to-owner fold) with XLA's ordering.

Above them, the typed surface of ``lib::communicator`` /
``lib::rma_window`` (reference ``details/communicator.hpp``): where the
JAX package's "sharded array" is a ``jax.Array`` over the mesh, here it
is a list of per-rank tensors, rank r's shard on ``devices[r]``, the
form :func:`ppermute` and :func:`all_to_all` take.  ``init_distributed``
is not ported: one process drives every rank.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import runtime as _rt

__all__ = ["ring_shift", "ppermute", "all_gather", "all_to_all", "psum",
           "ordered_minimum", "ordered_maximum", "communicator",
           "default_comm", "rma_window"]


def ring_shift(sends: Sequence[torch.Tensor], devices, step: int,
               periodic: bool) -> List[Optional[torch.Tensor]]:
    """``recv[r] = sends[r - step]`` (``step`` is +1 for the forward
    ring, -1 for the backward one), moved to rank r's device.  Without
    ``periodic`` the ranks whose source falls off the end receive None
    (the ``ppermute`` pairs of ``dr_tpu.parallel.halo._ring_perms``)."""
    p = len(sends)
    out: List[Optional[torch.Tensor]] = []
    for r in range(p):
        src = r - step
        if not periodic and not 0 <= src < p:
            out.append(None)
            continue
        out.append(sends[src % p].to(devices[r], non_blocking=True))
    return out


def ppermute(sends: Sequence[Optional[torch.Tensor]],
             pairs: Sequence[Tuple[int, int]],
             devices) -> List[Optional[torch.Tensor]]:
    """``recv[dst] = sends[src]`` moved to ``devices[dst]`` for every
    ``(src, dst)`` pair (``lax.ppermute``); an entry no pair reaches is
    None."""
    out: List[Optional[torch.Tensor]] = [None] * len(devices)
    for src, dst in pairs:
        out[dst] = sends[src].to(devices[dst], non_blocking=True)
    return out


def all_gather(values: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Stack one scalar (or equal-shape tensor) per rank on ``device``."""
    return torch.stack([v.to(device, non_blocking=True) for v in values])


def all_to_all(sends: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    """``lax.all_to_all`` over the leading axis: every rank sends a
    ``(p, ...)`` tensor, and rank d receives row d of every sender,
    stacked in sender order, on ``devices[d]``."""
    return [torch.stack([s[d].to(dev, non_blocking=True) for s in sends])
            for d, dev in enumerate(devices)]


def psum(values: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Sum of the per-rank values, in rank order, on ``device``."""
    acc = values[0].to(device, non_blocking=True)
    for v in values[1:]:
        acc = acc + v.to(device, non_blocking=True)
    return acc


def ordered_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise min as XLA's: -0.0 below +0.0, NaN propagates
    (``torch.minimum`` returns either zero)."""
    if not a.is_floating_point():
        return torch.minimum(a, b)
    take_b = torch.isnan(b) | (b < a) | ((b == a) & torch.signbit(b))
    return torch.where(take_b, b, a)


def ordered_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max as XLA's: +0.0 above -0.0, NaN propagates."""
    if not a.is_floating_point():
        return torch.maximum(a, b)
    take_b = torch.isnan(b) | (b > a) | ((b == a) & ~torch.signbit(b))
    return torch.where(take_b, b, a)


class communicator:
    """Typed communicator over the runtime's ranks
    (communicator.hpp:7-95)."""

    def __init__(self, runtime=None):
        self._rt = runtime or _rt.runtime()

    # -- topology (communicator.hpp:21-26) ---------------------------------
    @property
    def size(self) -> int:
        return self._rt.nprocs

    def first(self) -> int:
        return 0

    def last(self) -> int:
        return self.size - 1

    def prev(self, rank: int) -> int:
        return (rank - 1) % self.size

    def next(self, rank: int) -> int:
        return (rank + 1) % self.size

    # -- collectives -------------------------------------------------------
    def barrier(self) -> None:
        self._rt.barrier()

    def bcast(self, values) -> List[torch.Tensor]:
        """One replica of ``values`` per rank, each on its rank's device
        (communicator.hpp:32)."""
        from ..containers.distributed_vector import _as_tensor
        t = _as_tensor(values)
        return [t.to(d, copy=True) for d in self._rt.devices]

    def scatter(self, values) -> List[torch.Tensor]:
        """Split axis 0 of ``values`` into one equal shard per rank
        (communicator.hpp:36-45).  The length must divide the rank
        count; uneven sizes are a container's job."""
        from ..containers.distributed_vector import _as_tensor
        t = _as_tensor(values)
        assert t.shape[0] % self.size == 0, \
            "scatter: first dim must divide the mesh (use a container for " \
            "uneven sizes)"
        k = t.shape[0] // self.size
        return [t[r * k:(r + 1) * k].to(d, copy=True)
                for r, d in enumerate(self._rt.devices)]

    def gather(self, arr) -> np.ndarray:
        """The shards, concatenated along axis 0, on the host
        (communicator.hpp:47-62); valid on every rank."""
        from ..containers.distributed_vector import _host_numpy
        if isinstance(arr, torch.Tensor):
            return _host_numpy(arr)
        return _host_numpy(torch.cat([a.cpu() for a in arr]))

    def allgather(self, arr) -> np.ndarray:
        return self.gather(arr)

    # -- ring p2p: the halo tags' data plane (communicator.hpp:64-85) ------
    def shift_forward(self, arr, periodic: bool = False
                      ) -> List[torch.Tensor]:
        """Every rank's shard moves to the next rank (r -> r+1); without
        ``periodic`` rank 0 receives zeros."""
        return self._shift(arr, +1, periodic)

    def shift_backward(self, arr, periodic: bool = False
                       ) -> List[torch.Tensor]:
        """Every rank's shard moves to the previous rank (r -> r-1);
        without ``periodic`` the last rank receives zeros."""
        return self._shift(arr, -1, periodic)

    def _shift(self, arr, step: int, periodic: bool):
        out = ring_shift(arr, self._rt.devices, step, periodic)
        return [torch.zeros_like(a) if o is None else o
                for a, o in zip(arr, out)]

    def alltoall(self, arr) -> List[torch.Tensor]:
        """``lax.all_to_all`` of shards ``(k, nshards, ...)``: block
        ``[:, j]`` of rank i moves to rank j, which stacks the blocks in
        sender order into a ``(nshards, k, ...)`` shard."""
        return all_to_all([a.transpose(0, 1) for a in arr],
                          self._rt.devices)


def default_comm() -> communicator:
    """``mhp::default_comm()`` (mhp/global.hpp:35)."""
    return communicator()


class rma_window:
    """One-sided access to a distributed_vector (communicator.hpp:97-149):
    ``get`` / ``put`` are the vector's batched reads and writes, and
    ``fence`` / ``flush`` wait for its ranks' devices."""

    def __init__(self, dv):
        self._dv = dv

    def get(self, indices) -> torch.Tensor:
        return self._dv.get(indices)

    def put(self, indices, values) -> None:
        self._dv.put(indices, values)

    def fence(self) -> None:
        self._dv.block_until_ready()

    def flush(self, rank: Optional[int] = None) -> None:
        self._dv.block_until_ready()
