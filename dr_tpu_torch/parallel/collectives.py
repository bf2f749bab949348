"""Collectives over rank rows: the counterparts of ``lax.ppermute`` /
``lax.all_gather`` / ``lax.all_to_all`` / ``lax.psum``.

Every rank's value is a tensor on that rank's device.  With one
controller a collective is a set of tensor copies (``Tensor.to``) and
sums between them: ranks that share a device exchange by plain
reference, ranks on different devices by a device-to-device copy.

In a multi-process runtime (:func:`init_distributed`, the counterpart
of the JAX package's ``jax.distributed`` runtime) a list of per-rank
values holds None for the ranks another process owns.  A value whose
source and destination ranks live in different processes moves with
``torch.distributed`` point-to-point messages (:func:`_transfer`: a
small header with its dtype and shape, then its bytes); under gloo a
CUDA value is staged through host memory.  Every process lists the
same moves in the same order (the SPMD discipline), so the k-th message
between two processes is the same value on both sides.  Within one
process the moves stay the plain copies above.  :func:`psum` gathers
the partials and adds them in rank order, never with the backend's
``all_reduce``, so a multi-process result has the single controller's
bits.  :func:`ordered_minimum` / :func:`ordered_maximum` are the
min/max combines of partials (the reduce fold, the halo's ghost-to-owner
fold) with XLA's ordering.

Above them, the typed surface of ``lib::communicator`` /
``lib::rma_window`` (reference ``details/communicator.hpp``): where the
JAX package's "sharded array" is a ``jax.Array`` over the mesh, here it
is a list of per-rank tensors, rank r's shard on ``devices[r]``, the
form :func:`ppermute` and :func:`all_to_all` take.  Its gathers are
valid on every process.

The communicator's ring shift and all-to-all fire the
``collectives.shift`` / ``collectives.alltoall`` fault sites and then
look up ``_shift_cache`` (``utils/spmd_guard.TappedCache``) with the JAX
package's keys, before any tensor moves.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import runtime as _rt
from ..core.pinning import pinned_id
from ..utils import faults as _faults
from ..utils.spmd_guard import TappedCache, dtype_name

__all__ = ["ring_shift", "ring_shifts", "ppermute", "all_gather",
           "all_gather_each", "all_to_all", "psum", "gather_ranks", "route",
           "present", "ordered_minimum", "ordered_maximum", "communicator",
           "default_comm", "rma_window", "init_distributed"]


def present(values):
    """The first value of a per-rank list that this process holds."""
    return next(v for v in values if v is not None)


#: the dtypes a transfer header names (their index is the code)
_WIRE_DTYPES = (torch.float32, torch.float64, torch.float16,
                torch.bfloat16, torch.int64, torch.int32, torch.int16,
                torch.int8, torch.uint8, torch.bool)
_HEADER = 10  # dtype code, ndim, up to 8 dims


def _wire_device(rt):
    """Where a message's buffer lives: host memory for gloo, the
    process's own device for nccl."""
    import torch.distributed as dist
    return torch.device("cpu") if dist.get_backend() == "gloo" \
        else rt.home


def _transfer(moves, rt, like=None) -> list:
    """Carry out ``moves``, a list of ``(src_rank, dst_process, value,
    device)``, the same list on every process: ``value()`` gives the
    tensor (called only where ``src_rank`` is local), and the process
    ``dst_process`` receives it on ``device``.  Returns, for each move,
    the received tensor where this process is the destination, else
    None.  A local-to-local move is a ``Tensor.to``; every other pair of
    processes exchanges a header (dtype and shape) and the value's bytes
    (the k-th move between two processes uses tags 2k and 2k+1).  With
    ``like = (shape, dtype)``, which every moved value must have (the
    sends of a symmetric exchange), or a list of such pairs, one a move
    (values whose shapes both sides compute from static geometry), no
    header is sent, and each value is one message whose receive is
    posted at once."""
    import torch.distributed as dist
    me = rt.process_index
    wire = _wire_device(rt)
    out: list = [None] * len(moves)
    works = []  # (work, tensor): a send keeps its buffer alive
    pending = []
    nsent: dict = {}
    nrecv: dict = {}
    likes = like if isinstance(like, list) else [like] * len(moves)
    for i, (src, dst, value, device) in enumerate(moves):
        sp = rt.owners[src]
        like = likes[i]
        if sp == me and dst == me:
            out[i] = _to(value(), device)
        elif sp == me:
            k = nsent.get(dst, 0)
            nsent[dst] = k + 1
            t = value().detach().to(wire).contiguous()
            if like is None:
                hdr = torch.zeros(_HEADER, dtype=torch.int64)
                hdr[0] = _WIRE_DTYPES.index(t.dtype)
                hdr[1] = t.dim()
                hdr[2:2 + t.dim()] = torch.tensor(t.shape,
                                                  dtype=torch.int64)
                hdr = hdr.to(wire)
                works.append((dist.isend(hdr, dst, tag=2 * k), hdr))
            elif (tuple(t.shape), t.dtype) != (tuple(like[0]), like[1]):
                raise ValueError(f"rank {src} sends {tuple(t.shape)} "
                                 f"{t.dtype} into a transfer of {like}")
            if t.numel():
                flat = t.reshape(-1).view(torch.uint8)
                works.append((dist.isend(flat, dst, tag=2 * k + 1), flat))
        elif dst == me:
            k = nrecv.get(sp, 0)
            nrecv[sp] = k + 1
            if like is None:
                hdr = torch.empty(_HEADER, dtype=torch.int64, device=wire)
                pending.append((i, sp, k, device, hdr,
                                dist.irecv(hdr, sp, tag=2 * k)))
            else:
                buf = torch.empty(like[0], dtype=like[1], device=wire)
                work = dist.irecv(buf.reshape(-1).view(torch.uint8), sp,
                                  tag=2 * k + 1) if buf.numel() else None
                pending.append((i, sp, k, device, buf, work))
    for i, sp, k, device, buf, work in pending:
        if work is not None:
            work.wait()
        if likes[i] is None:
            h = buf.cpu().tolist()
            buf = torch.empty(tuple(h[2:2 + h[1]]),
                              dtype=_WIRE_DTYPES[h[0]], device=wire)
            if buf.numel():
                dist.recv(buf.reshape(-1).view(torch.uint8), sp,
                          tag=2 * k + 1)
        out[i] = buf.to(device)
    for w, _ in works:
        w.wait()
    return out


def _to(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``; a copy into host memory waits for the device
    (an asynchronous one could be read before it lands)."""
    return t.to(device, non_blocking=torch.device(device).type != "cpu")


def gather_ranks(values: Sequence[Optional[torch.Tensor]], device,
                 ranks: Optional[Sequence[int]] = None, like=None
                 ) -> List[torch.Tensor]:
    """The value of each rank of ``ranks`` (default: every rank), in
    that order, on ``device`` of every process: the building block of
    the gathers (:func:`all_gather`, :func:`psum`, ``utils/host``).
    ``values`` is indexed by rank; ``like`` as in :func:`_transfer`, a
    list of it one entry per rank of ``ranks``."""
    ranks = range(len(values)) if ranks is None else ranks
    rt = _rt.mp_runtime()
    if rt is None:
        return [_to(values[r], device) for r in ranks]
    me = rt.process_index
    moves, likes = [], []
    for i, r in enumerate(ranks):
        for q in range(rt.process_count):
            if q == me or rt.owners[r] == me:
                moves.append((r, q, lambda r=r: values[r], device))
                likes.append(like[i] if isinstance(like, list) else like)
    return [g for g, (_, q, _, _) in zip(_transfer(moves, rt, likes), moves)
            if q == me]


def all_gather_each(values: Sequence[Optional[torch.Tensor]], devices
                    ) -> List[Optional[torch.Tensor]]:
    """:func:`all_gather` of equal-shape per-rank values onto every
    rank's device: one gather onto the home device, copied to this
    process's ranks' devices (None for the others; ranks that share the
    home device share the result, which the callers only read), so every
    process issues the same single collective."""
    rt = _rt.runtime()
    g = all_gather(values, rt.home)
    return [g.to(d) if rt.is_local(r) else None
            for r, d in enumerate(devices)]


def ring_shifts(shifts, devices, periodic: bool, like=None
                ) -> List[List[Optional[torch.Tensor]]]:
    """Several :func:`ring_shift` s at once: ``shifts`` is a list of
    ``(sends, step)``; across processes every message of every shift is
    in flight together (one round trip, not one a shift).  ``like``: the
    ``(shape, dtype)`` every send has, when the caller knows it (no
    header then)."""
    p = len(devices)
    moves, slots = [], []
    for j, (sends, step) in enumerate(shifts):
        for r in range(p):
            if periodic or 0 <= r - step < p:
                moves.append(((r - step) % p, r,
                              lambda src=(r - step) % p, sends=sends:
                              sends[src]))
                slots.append((j, r))
    out: List[List[Optional[torch.Tensor]]] = [[None] * p for _ in shifts]
    for (j, r), g in zip(slots, route(moves, devices, like)):
        out[j][r] = g
    return out


def ring_shift(sends: Sequence[Optional[torch.Tensor]], devices, step: int,
               periodic: bool, like=None) -> List[Optional[torch.Tensor]]:
    """``recv[r] = sends[r - step]`` (``step`` is +1 for the forward
    ring, -1 for the backward one), moved to rank r's device.  Without
    ``periodic`` the ranks whose source falls off the end receive None
    (the ``ppermute`` pairs of ``dr_tpu.parallel.halo._ring_perms``), as
    does every rank another process owns."""
    return ring_shifts([(sends, step)], devices, periodic, like)[0]


def route(moves, devices, like=None) -> List[Optional[torch.Tensor]]:
    """Point-to-point moves between ranks: for each ``(src, dst,
    value)`` of ``moves`` (the same list on every process) the tensor
    ``value()`` of rank ``src`` lands on ``devices[dst]``.  Returns, per
    move, the received tensor, or None where another process owns
    ``dst``.  ``value`` is called only where this process owns ``src``;
    ``like`` as in :func:`_transfer`."""
    rt = _rt.mp_runtime()
    if rt is None:
        return [value().to(devices[dst], non_blocking=True)
                for _, dst, value in moves]
    return _transfer([(src, rt.owners[dst], value, devices[dst])
                      for src, dst, value in moves], rt, like)


def ppermute(sends: Sequence[Optional[torch.Tensor]],
             pairs: Sequence[Tuple[int, int]],
             devices, like=None) -> List[Optional[torch.Tensor]]:
    """``recv[dst] = sends[src]`` moved to ``devices[dst]`` for every
    ``(src, dst)`` pair (``lax.ppermute``); an entry no pair reaches is
    None, and so is every rank another process owns.  ``like``: the
    ``(shape, dtype)`` every send has, when the caller knows it."""
    out: List[Optional[torch.Tensor]] = [None] * len(devices)
    got = route([(src, dst, lambda src=src: sends[src])
                 for src, dst in pairs], devices, like)
    for (_, dst), g in zip(pairs, got):
        if g is not None:
            out[dst] = g
    return out


def all_gather(values: Sequence[Optional[torch.Tensor]],
               device) -> torch.Tensor:
    """Stack one scalar (or equal-shape tensor) per rank on ``device``."""
    v = present(values)
    return torch.stack(gather_ranks(values, device,
                                    like=(tuple(v.shape), v.dtype)))


def all_to_all(sends: Sequence[Optional[torch.Tensor]],
               devices, like=None) -> List[Optional[torch.Tensor]]:
    """``lax.all_to_all`` over the leading axis: every rank sends a
    ``(p, ...)`` tensor, and rank d receives row d of every sender,
    stacked in sender order, on ``devices[d]`` (None for a rank another
    process owns).  ``like``: the ``(shape, dtype)`` of one row, when
    the caller knows it (no header then)."""
    p = len(devices)
    got = route([(s, d, lambda s=s, d=d: sends[s][d])
                 for d in range(p) for s in range(p)], devices, like)
    return [None if got[d * p] is None else torch.stack(got[d * p:d * p + p])
            for d in range(p)]


def psum(values: Sequence[Optional[torch.Tensor]], device) -> torch.Tensor:
    """Sum of the per-rank values (of one shape and dtype), in rank
    order, on ``device`` (on every process: the partials are gathered,
    then added in rank order)."""
    one = present(values)
    parts = gather_ranks(values, device, like=(tuple(one.shape), one.dtype))
    acc = parts[0]
    for v in parts[1:]:
        acc = acc + v
    return acc


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, *, backend: Optional[str] = None,
                     device=None, timeout_s: float = 300.0):
    """Multi-process execution: the counterpart of the JAX package's
    ``init_distributed`` (``jax.distributed.initialize``), the
    reference's MPI ranks in separate processes.

    Joins ``torch.distributed``'s process group at
    ``tcp://<coordinator_address>`` as process ``process_id`` of
    ``num_processes``, then initialises a runtime of ``num_processes``
    ranks, rank r owned by process r.  ``device`` is this process's
    rank's device: the CPU only when named, else
    ``cuda:<process_id % device_count>`` (raising without a card).
    ``backend`` defaults to torch's mapping, gloo for a CPU rank and
    nccl for a CUDA rank; processes that share one card must pass
    ``backend="gloo"`` (nccl refuses two ranks on one device).  A
    failed join raises; nothing retries it on another backend.  Every
    process must then run the same program in the same order (the SPMD
    discipline; ``utils/spmd_guard.verify`` checks it)."""
    import torch.distributed as dist
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "init_distributed(): no CUDA device is visible; pass "
                "device='cpu' to run the processes on the CPU")
        device = torch.device("cuda",
                              process_id % torch.cuda.device_count())
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if _rt.left_group() is not None:
            from ..utils import resilience as _res
            raise _res.ProgramError(
                "init_distributed(): this process still holds the "
                f"process group it shrank out of ({_rt.left_group()}); "
                "a survivor does not re-join its group. "
                "torch.distributed.destroy_process_group() releases it "
                "(under gloo it returns at once, dead peers or not), "
                "and a new group can then be joined",
                site="runtime.multi_process")
        raise RuntimeError("init_distributed(): torch.distributed is "
                           "initialised already")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return _rt._init_processes(device, process_id, num_processes)


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

    def _root_value(self, values) -> torch.Tensor:
        """``values`` as a tensor; in a multi-process runtime, the value
        of the process that owns rank 0 (the reference's root),
        received by every other process."""
        from ..containers.distributed_vector import _as_tensor
        t = _as_tensor(values)
        rt = self._rt
        if not rt.multi_process:
            return t
        moves = [(0, q, lambda: t, t.device)
                 for q in range(rt.process_count) if q != rt.owners[0]]
        got = [g for g in _transfer(moves, rt) if g is not None]
        return got[0] if got else t

    def bcast(self, values) -> List[Optional[torch.Tensor]]:
        """One replica of ``values`` (rank 0's, in a multi-process
        runtime) per rank, each on its rank's device; None for the ranks
        another process owns (communicator.hpp:32)."""
        t = self._root_value(values)
        return [t.to(d, copy=True) if self._rt.is_local(r) else None
                for r, d in enumerate(self._rt.devices)]

    def scatter(self, values) -> List[Optional[torch.Tensor]]:
        """Split axis 0 of ``values`` (rank 0's, in a multi-process
        runtime) into one equal shard per rank (communicator.hpp:36-45);
        None for the ranks another process owns.  The length must
        divide the rank count; uneven sizes are a container's job."""
        t = self._root_value(values)
        assert t.shape[0] % self.size == 0, \
            "scatter: first dim must divide the mesh (use a container for " \
            "uneven sizes)"
        k = t.shape[0] // self.size
        return [t[r * k:(r + 1) * k].to(d, copy=True)
                if self._rt.is_local(r) else None
                for r, d in enumerate(self._rt.devices)]

    def gather(self, arr) -> np.ndarray:
        """The shards, concatenated along axis 0, on the host
        (communicator.hpp:47-62); valid on every process (a per-rank
        list goes through ``utils/host.to_host``)."""
        from ..utils.host import to_host
        return to_host(arr)

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
        _faults.fire("collectives.shift")
        a0 = present(arr)
        _shift_cache.tap(("shift", pinned_id(self._rt), step, periodic,
                          tuple(a0.shape[1:]), dtype_name(a0.dtype)))
        out = ring_shift(arr, self._rt.devices, step, periodic)
        return [None if a is None else torch.zeros_like(a) if o is None
                else o for a, o in zip(arr, out)]

    def alltoall(self, arr) -> List[Optional[torch.Tensor]]:
        """``lax.all_to_all`` of shards ``(k, nshards, ...)``: block
        ``[:, j]`` of rank i moves to rank j, which stacks the blocks in
        sender order into a ``(nshards, k, ...)`` shard."""
        _faults.fire("collectives.alltoall")
        a0 = present(arr)
        _shift_cache.tap(("a2a", pinned_id(self._rt),
                          tuple(a0.shape[1:]), dtype_name(a0.dtype)))
        return all_to_all([None if a is None else a.transpose(0, 1)
                           for a in arr], self._rt.devices)


#: the communicator's dispatch cache (the JAX package's shift programs)
_shift_cache: dict = TappedCache()


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
