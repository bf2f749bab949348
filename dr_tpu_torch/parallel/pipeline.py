"""Ring schedules over rank lists: one home for the ring loop.

Counterpart of ``dr_tpu/parallel/pipeline.py``.  Every ring program
(ring attention's K/V rotation now; the sparse gemv family's b-block
rotation and the ring combine of 2-D tile partials later) is the same
shape: ``nshards`` steps where each rank computes against the blocks it
currently holds and the blocks rotate one hop around the ring between
steps.  The port is eager and single-controller, as ``halo.py`` and
``algorithms/sort.py`` are: ``carry`` and ``blocks`` are per-rank lists,
``compute(t, r, carry_r, blocks_r)`` runs for each rank ``r``, and a
rotation is one ``collectives.ppermute`` over the runtime's devices.

Two issue orders, as in the JAX package:

* ``serial``: compute step t on every rank, THEN issue the copies that
  rotate the blocks for step t+1;
* ``pipelined`` (default): issue the copies for step t+1 FIRST
  (non-blocking ``Tensor.to``), then compute step t against the blocks
  still held: the copies are queued ahead of the step's kernels, the
  order that lets a transfer between cards overlap the compute.

Both run the same dataflow: every value is computed from the same
operands in the same order, so the results are bit-identical; only what
the device may overlap differs.  The default schedule is read from
``DR_GPU_RING_SCHEDULE`` (``pipelined`` or ``serial``; a malformed value
falls back to ``pipelined``, as ``DR_TPU_RING_SCHEDULE`` does).

A block is a tensor or a tuple/list of tensors (one level of nesting, the
pytrees the ring programs use).  Ranks that share a device exchange by
reference: a rotation on one card copies nothing.

Not carried over: ``fire_ppermute``, the ``collectives.ppermute`` fault
site, which comes with the faults layer.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from . import collectives

__all__ = ["ring_perm", "shift_perm", "schedule_mode", "ring_pipeline",
           "ring_allgather", "ring_combine", "ring_exchange"]

SCHEDULES = ("pipelined", "serial")


def ring_perm(nshards: int) -> List[Tuple[int, int]]:
    """The forward ring permutation (rank i's block moves to i+1)."""
    return [(i, (i + 1) % nshards) for i in range(nshards)]


def shift_perm(nshards: int, t: int) -> List[Tuple[int, int]]:
    """The offset-``t`` permutation (rank i's bucket moves DIRECTLY to
    rank i+t): one hop distance of :func:`ring_exchange`."""
    return [(i, (i + t) % nshards) for i in range(nshards)]


def schedule_mode() -> str:
    """The default issue order: ``DR_GPU_RING_SCHEDULE`` in
    {``pipelined``, ``serial``}; malformed values fall back to
    ``pipelined``."""
    mode = os.environ.get("DR_GPU_RING_SCHEDULE", "").strip().lower()
    return mode if mode in SCHEDULES else "pipelined"


def _resolve(schedule: Optional[str]) -> str:
    sched = schedule or schedule_mode()
    if sched not in SCHEDULES:
        raise ValueError(f"unknown ring schedule {sched!r}; expected one "
                         f"of {SCHEDULES}")
    return sched


def _permute(blocks: Sequence[Any], pairs, devices) -> List[Any]:
    """``blocks[src]`` to ``devices[dst]`` for every pair, leaf by leaf."""
    first = blocks[0]
    if isinstance(first, (tuple, list)):
        leaves = [collectives.ppermute([b[i] for b in blocks], pairs, devices)
                  for i in range(len(first))]
        return [type(first)(leaf[r] for leaf in leaves)
                for r in range(len(devices))]
    return collectives.ppermute(blocks, pairs, devices)


def ring_pipeline(devices, carry: Sequence[Any], blocks: Sequence[Any],
                  compute: Callable[[int, int, Any, Any], Any], *,
                  perm: Optional[List[Tuple[int, int]]] = None,
                  schedule: Optional[str] = None,
                  restore_blocks: bool = False):
    """The ring loop over ``len(devices)`` ranks.

    ``carry[r] = compute(t, r, carry[r], blocks[r])`` runs for every
    rank at every step t; at step t rank d holds the blocks of rank
    ``(d - t) % nshards``.  Between steps the blocks rotate one hop
    (``perm``, default :func:`ring_perm`); the issue order follows
    ``schedule`` (:func:`schedule_mode` when None).

    Returns the per-rank carries; with ``restore_blocks=True`` one more
    rotation brings the blocks back to their origin rank and
    ``(carry, blocks)`` is returned (the form a chained ``*_n`` loop
    needs so every iteration starts from the same placement)."""
    sched = _resolve(schedule)
    nshards = len(devices)
    p = ring_perm(nshards) if perm is None else perm
    carry, blocks = list(carry), list(blocks)
    for t in range(nshards):
        rotate_after = (t + 1 < nshards) or restore_blocks
        if sched == "pipelined" and rotate_after:
            nxt = _permute(blocks, p, devices)      # in flight during t
            carry = [compute(t, r, carry[r], blocks[r])
                     for r in range(nshards)]
            blocks = nxt
        else:
            carry = [compute(t, r, carry[r], blocks[r])
                     for r in range(nshards)]
            if rotate_after:
                blocks = _permute(blocks, p, devices)
    return (carry, blocks) if restore_blocks else carry


def ring_exchange(devices, carry: Sequence[Any],
                  make_bucket: Callable[[int, int], Any],
                  consume: Callable[[int, int, Any, Any], Any], *,
                  steps: Optional[Sequence[int]] = None,
                  schedule: Optional[str] = None):
    """Offset-permute exchange (the collective decomposition of
    arXiv:2112.01075 on the ring): for each hop distance ``t`` in
    ``steps`` (default ``1..nshards-1``) every rank r sends ONE bucket,
    ``make_bucket(t, r)``, DIRECTLY to rank r+t (:func:`shift_perm`) and
    folds the bucket arriving from rank r-t into its carry:
    ``carry[r] = consume(t, r, carry[r], bucket)``.  Nothing is relayed,
    so at most one hop's buckets are in flight; callers drop hops that
    move nothing from ``steps``.

    ``pipelined`` issues hop t+1's copies before consuming hop t's
    arrivals, ``serial`` after; each consume reads only its own arrival
    and the threaded carry, so the two are bit-identical."""
    sched = _resolve(schedule)
    nshards = len(devices)
    hops = list(range(1, nshards)) if steps is None else list(steps)
    carry = list(carry)

    def send(t):
        return _permute([make_bucket(t, r) for r in range(nshards)],
                        shift_perm(nshards, t), devices)

    def fold(t, arrived):
        return [consume(t, r, carry[r], arrived[r]) for r in range(nshards)]

    if sched == "pipelined" and hops:
        inflight = send(hops[0])
        for i, t in enumerate(hops):
            nxt = send(hops[i + 1]) if i + 1 < len(hops) else None
            carry = fold(t, inflight)
            inflight = nxt
        return carry
    for t in hops:
        carry = fold(t, send(t))
    return carry


def ring_allgather(devices, blocks: Sequence[torch.Tensor], *,
                   schedule: Optional[str] = None) -> List[torch.Tensor]:
    """Every rank's block stacked source-rank-first: rank r gets a
    ``(nshards,) + block.shape`` tensor on ``devices[r]``, built from
    nshards-1 ring rotations.  Slot s holds rank s's block on EVERY
    rank, so a fold over axis 0 runs in the same canonical order
    everywhere (what :func:`ring_combine` needs)."""
    nshards = len(devices)
    bufs = [blocks[r].new_zeros((nshards,) + tuple(blocks[r].shape))
            for r in range(nshards)]

    def place(t, r, buf, blk):
        buf[(r - t) % nshards] = blk
        return buf

    return ring_pipeline(devices, bufs, blocks, place, schedule=schedule)


def ring_combine(devices, xs: Sequence[torch.Tensor], *,
                 schedule: Optional[str] = None) -> List[torch.Tensor]:
    """Ring all-reduce (sum) of the per-rank ``xs``: all-gather around
    the ring, then ONE canonical-order sum over the stacked sources,
    ranks 0..nshards-1 left to right on every rank, so the result is
    bitwise identical across ranks and schedules."""
    if len(devices) == 1:
        return list(xs)
    out = []
    for g in ring_allgather(devices, xs, schedule=schedule):
        acc = g[0]
        for s in range(1, g.shape[0]):
            acc = acc + g[s]
        out.append(acc)
    return out
