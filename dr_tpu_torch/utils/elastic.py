"""Elastic sessions: re-layout, shrink on a lost rank, grow back
(counterpart of ``dr_tpu/utils/elastic.py``).

* :func:`redistribute` re-lays a container out in place (the collective
  or the host-staged route for a vector, a snapshot and rebuild for a
  matrix or an mdarray).
* **Shrink.**  A classified :class:`~.resilience.DeviceLostError` (the
  ``device.lost`` site rides every dispatch tap; :func:`attribute` pins a
  collective failure on a rank) names a lost rank.
  :func:`rescue_session` rebuilds the global runtime on the surviving
  ranks and walks the old runtime's live containers:

  ========  =====================================================
  fate      when / how
  ========  =====================================================
  rescued   no segment lived on a lost rank: the value moves
            through the host onto the survivors, bit for bit
  restored  segments died but the container has a checkpoint
            (``checkpoint.save`` registers every successful write
            here): a vector merges its survivors' live segments
            with the checkpoint's values of the dead ones, a dense
            or sparse matrix does the same tile by tile, other
            kinds reload the whole checkpoint
  lost      segments died and no checkpoint exists: the container
            is poisoned, and any further use raises a classified
            ``DeviceLostError`` naming the loss
  ========  =====================================================

  The ``mesh.shrink`` site fires before the runtime flips, inside the
  ``mesh.shrink`` obs span with the ``device.lost`` event.
  ``DR_GPU_ELASTIC_MIN_DEVICES`` floors the shrink: below it the rescue
  refuses classified.  A loss during a rescue (or a grow) is refused
  classified, never a nested re-layout.
* **Grow.**  :func:`grow_session` re-admits recovered rank slots
  (``runtime.probe_recovered``, the ``device.recover`` site): it fires
  ``mesh.grow`` before the rebuild (a fault there leaves the session
  untouched on the small runtime), re-inits the runtime on the larger
  list and moves every live container onto it.  Fates: ``moved``;
  ``kept`` (the move failed: the container stays, value intact, on the
  old runtime, which is still live); a container the shrink poisoned
  stays poisoned.  :class:`GrowSupervisor` paces the probes of
  :func:`maybe_grow` (seeded backoff, bounded).
* **Automatic hooks**, armed by ``DR_GPU_ELASTIC=1``:
  ``resilience.retry`` turns a ``DeviceLostError`` into shrink and
  retry, and a deferred flush re-records its unexecuted queue on the
  shrunken runtime and flushes it again (``plan/__init__.py``).
  ``DR_GPU_ELASTIC_GROW=1`` arms the grow poll at the outermost deferred
  region's exit.  :func:`rescue_session` and :func:`grow_session` work
  when called, armed or not.

Ranks of the port may share a device, so a lost rank is a rank slot
(``parallel/runtime.py``), and only an injected loss (or
:func:`attribute`) leaves survivors on one card: a real loss of the
card takes every rank with it.  A shrink and a grow drop every dispatch
cache entry keyed on the replaced runtime (``core.pinning.release``),
plan graphs and their memory pools included.

Every shrink publishes the ``_DR_GPU_ELASTIC_*`` environment markers and
every grow the ``_DR_GPU_ELASTIC_GROW_*`` ones (never the JAX package's
``_DR_TPU_*`` names); ``resilience.session_story`` folds them into its
``shrink`` and ``grow`` chapters.  Each shrink and grow is announced
once as an :class:`ElasticWarning`.  Grow pacing:
``DR_GPU_ELASTIC_GROW_PROBE_S`` (first delay, default 1 s),
``DR_GPU_ELASTIC_GROW_PROBE_CAP_S`` (delay cap, 60 s),
``DR_GPU_ELASTIC_GROW_PROBES`` (probe budget, 64).

The serving daemon (``serve/daemon.py``) rides these hooks: a batch's
retry shrinks on a lost rank, and it counts shrinks and grows through
:func:`shrink_count` / :func:`grow_count` and polls :func:`maybe_grow`
between batches.

Across processes (``init_distributed``), as the JAX package's
killed-worker leg (``tests/elastic_worker.py``): a survivor attributes
the failed collective itself (:func:`attribute`; nothing attributes
automatically), bounds it with ``resilience.with_deadline``, and calls
:func:`rescue_session`, which shrinks onto the survivors when every one
of them is a rank of this process (``Runtime.local_ranks``).  The new
runtime is a single-process one on those ranks' devices.  The fates
come from this process's rows and the checkpoint file alone, never
from a gather (a peer may be dead): every rank another process owns
counts as lost, so a container whose segments all lie on this
process's surviving ranks is rescued, one with a segment elsewhere is
restored from its checkpoint (this process's live segments over the
file's values) or lost.  The process group stays as it was: no barrier
and no ``destroy_process_group`` (``runtime.left_group`` says why; a
later ``init_distributed`` refuses, classified, until the caller
destroys the group).  A loss that leaves survivors in several processes
is refused classified at ``mesh.shrink``: passing ``lost_ranks`` that
cover every rank of the other processes downgrades this process to its
own ranks.  A grow re-admits no process (the JAX package's cannot
either): :func:`grow_session` refuses in a multi-process runtime, and
:func:`maybe_grow` there is a no-op while the grow poll is disarmed;
the single-process runtime a shrink leaves grows as any other.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
import weakref
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import pinning as _pinning
from . import faults as _faults
from . import resilience as _resilience
from .env import env_flag, env_float, env_int
from ..parallel import runtime as _rt_mod

__all__ = ["enabled", "redistribute", "rescue_session", "try_rescue",
           "attribute", "ShrinkReport", "note_checkpoint",
           "checkpoint_path", "shrink_count", "last_report", "is_lost",
           "reset", "MARKERS", "grow_enabled", "grow_session",
           "maybe_grow", "grow_count", "last_grow_report", "GrowReport",
           "GrowSupervisor", "GROW_MARKERS", "ElasticWarning"]

#: the environment markers a shrink publishes
MARKERS = ("_DR_GPU_ELASTIC_REASON", "_DR_GPU_ELASTIC_SHRINKS",
           "_DR_GPU_ELASTIC_LOST_RANKS", "_DR_GPU_ELASTIC_RESCUED",
           "_DR_GPU_ELASTIC_RESTORED", "_DR_GPU_ELASTIC_LOST",
           "_DR_GPU_ELASTIC_NPROCS", "_DR_GPU_ELASTIC_WALL_S")

#: the environment markers a grow publishes
GROW_MARKERS = ("_DR_GPU_ELASTIC_GROW_REASON", "_DR_GPU_ELASTIC_GROWS",
                "_DR_GPU_ELASTIC_GROW_NPROCS", "_DR_GPU_ELASTIC_GROW_MOVED",
                "_DR_GPU_ELASTIC_GROW_KEPT", "_DR_GPU_ELASTIC_GROW_WALL_S")


class ElasticWarning(UserWarning):
    """A shrink or a grow changed the session's runtime."""


#: id(container) -> (weakref, checkpoint path); the weakref is the
#: liveness check (ids are recycled)
_ckpts: dict = {}

_shrinks = 0
_rescued = 0
_restored = 0
_lost = 0
_wall_s = 0.0
_last_report: Optional["ShrinkReport"] = None
#: re-entrancy latch shared by the shrink and the grow
_rescuing = False

_grows = 0
_moved = 0
_kept = 0
_grow_wall_s = 0.0
_last_grow: Optional["GrowReport"] = None
#: the supervisor of the automatic polls, re-armed per shrink
_grow_sup: Optional["GrowSupervisor"] = None
_grow_sup_epoch = -1
#: two polling threads must not race one grow: the loser skips its poll
_grow_lock = threading.Lock()


def _announce(msg: str) -> None:
    warnings.warn(msg, ElasticWarning, stacklevel=3)


def enabled() -> bool:
    """True when ``DR_GPU_ELASTIC=1`` arms the automatic recovery hooks
    (retry, plan flush)."""
    return env_flag("DR_GPU_ELASTIC")


def grow_enabled() -> bool:
    """True when ``DR_GPU_ELASTIC_GROW=1`` arms the automatic grow poll
    (the outermost deferred region's exit)."""
    return env_flag("DR_GPU_ELASTIC_GROW")


def shrink_count() -> int:
    """Completed shrinks in this process."""
    return _shrinks


def grow_count() -> int:
    """Completed grows in this process."""
    return _grows


def last_report() -> Optional["ShrinkReport"]:
    return _last_report


def last_grow_report() -> Optional["GrowReport"]:
    return _last_grow


@dataclass
class ShrinkReport:
    """One completed shrink: what died, what survived, what it cost."""

    reason: str
    lost_ranks: List[int]
    nprocs_before: int
    nprocs_after: int
    rescued: int = 0
    restored: int = 0
    lost: int = 0
    wall_s: float = 0.0
    #: (fate, kind, detail) of each container
    fates: list = field(default_factory=list)
    #: host seconds each container took (its read on the old runtime and
    #: its write on the new one), in the order of ``fates``
    seconds: list = field(default_factory=list)


@dataclass
class GrowReport:
    """One completed grow: what was re-admitted, what moved."""

    reason: str
    nprocs_before: int
    nprocs_after: int
    moved: int = 0
    kept: int = 0
    poisoned: int = 0
    wall_s: float = 0.0
    #: (fate, kind, detail) of each container
    fates: list = field(default_factory=list)
    #: host seconds each container's move took, in the order of ``fates``
    seconds: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# the checkpoint registry (the restore source)
# ---------------------------------------------------------------------------

def note_checkpoint(container, path: str) -> None:
    """Record ``path`` as ``container``'s restore source
    (``checkpoint.save`` calls this after every successful write).  The
    row goes when the container is collected."""
    key = id(container)

    def _drop(ref, _key=key):
        row = _ckpts.get(_key)
        if row is not None and row[0] is ref:
            _ckpts.pop(_key, None)

    _ckpts[key] = (weakref.ref(container, _drop), str(path))


def checkpoint_path(container) -> Optional[str]:
    """The last checkpoint registered for ``container`` that is still on
    disk, or None."""
    row = _ckpts.get(id(container))
    if row is None:
        return None
    ref, path = row
    if ref() is not container:
        _ckpts.pop(id(container), None)  # a recycled id
        return None
    return path if os.path.exists(path) else None


# ---------------------------------------------------------------------------
# rank attribution
# ---------------------------------------------------------------------------

def attribute(err, rank: int) -> _resilience.DeviceLostError:
    """Pin a collective or backend failure on ``rank``: the classified
    ``DeviceLostError`` the rescue acts on (the failure itself names no
    rank)."""
    de = _resilience.DeviceLostError(
        f"rank {rank} presumed lost: {type(err).__name__}: {err}",
        site=getattr(err, "site", "") or "device.lost", rank=int(rank))
    if isinstance(err, BaseException):
        de.__cause__ = err
    return de


# ---------------------------------------------------------------------------
# redistribute: the public re-layout
# ---------------------------------------------------------------------------

def redistribute(container, new_dist=None, *, runtime=None):
    """Re-lay ``container`` out in place under ``new_dist`` on ``runtime``
    (default: the global runtime) and return it.

    A ``distributed_vector`` goes through ``parallel/redistribute``: one
    collective exchange when source and target share the device list,
    the host-staged route otherwise; the two leave the same rows.
    ``new_dist`` (a ``block_distribution``, a sizes sequence, or None for
    the even layout) is a vector contract: matrices and mdarrays re-block
    with their default partition on the target runtime, through a
    checkpoint snapshot and rebuild.  In place on purpose: every
    reference to the container (views, halos) stays valid.

    In a multi-process runtime every process makes the same call: a
    vector moves as ``parallel/redistribute`` says, and a matrix's
    snapshot gathers its value onto every process, whose rebuild keeps
    the process's own blocks."""
    from ..containers.distributed_vector import distributed_vector
    from ..parallel import redistribute as _rdx
    from ..parallel import runtime as _rt

    rt = runtime or _rt.runtime()
    if isinstance(container, distributed_vector):
        return _rdx.redistribute_vector(container, new_dist, rt)
    if new_dist is not None:
        raise ValueError(
            "explicit block distributions are a distributed_vector "
            "contract; matrices re-block with their default partition "
            "on the target runtime")
    if not _rdx._same_processes(container.runtime, rt):
        raise _resilience.ProgramError(
            "redistribute: the target runtime does not span the "
            "matrix's processes; a re-block runs within one process "
            "group", site="redistribute.processes")
    from . import checkpoint as _ck
    meta, arrays = _ck.snapshot(container)
    fresh = _ck.rebuild(meta, arrays, runtime=rt, reblock=True)
    _swap_state(container, fresh, rt)
    return container


def _swap_state(container, fresh, rt) -> None:
    """Adopt ``fresh``'s state into ``container`` in place (the same
    logical value on a new layout), re-bind what refers to the container
    itself (a vector's halo) and register it on ``rt`` in ``fresh``'s
    place."""
    container.__dict__.clear()
    container.__dict__.update(fresh.__dict__)
    from ..containers.distributed_vector import distributed_vector
    if isinstance(container, distributed_vector) and container._hb.width:
        from ..parallel.halo import span_halo
        container._halo = span_halo(container)
    rt._live.discard(fresh)
    rt.register(container)


# ---------------------------------------------------------------------------
# poisoning (the 'lost' fate)
# ---------------------------------------------------------------------------

_poison_classes: dict = {}


def _poison(container, why: str) -> None:
    """Mark ``container`` lost: any further attribute access raises the
    classified ``DeviceLostError``, so a lost container never feeds a
    wrong answer into a surviving computation."""
    cls = type(container)
    pc = _poison_classes.get(cls)
    if pc is None:
        def __getattribute__(self, name):
            if name.startswith("__") or name == "_elastic_lost_reason":
                return object.__getattribute__(self, name)
            raise _resilience.DeviceLostError(
                f"{cls.__name__} state was lost with the failed rank(s) "
                f"({object.__getattribute__(self, '_elastic_lost_reason')}"
                "); only a checkpoint that predates the loss can restore "
                "it", site="device.lost")

        pc = type("Lost" + cls.__name__, (cls,),
                  {"__getattribute__": __getattribute__})
        _poison_classes[cls] = pc
    container._elastic_lost_reason = why
    container.__class__ = pc


def is_lost(container) -> bool:
    """True when a shrink poisoned ``container``."""
    return type(container) in _poison_classes.values()


# ---------------------------------------------------------------------------
# the shrink
# ---------------------------------------------------------------------------

def _owned_ranks(container, P: int) -> set:
    """Ranks holding any of ``container``'s segments: a vector's nonempty
    windows; a matrix's grid prefix; every rank for other kinds."""
    from ..containers.distributed_vector import distributed_vector

    if isinstance(container, distributed_vector):
        owned = set()
        for r in range(container.nshards):
            b, e = container._rank_window(r)
            if b < e:
                owned.add(r)
        return owned
    grid = getattr(container, "grid_shape", None) \
        or getattr(container, "grid", None)
    if grid is not None:
        tiles = 1
        for g in tuple(grid):
            tiles *= int(g)
        return set(range(min(P, tiles)))
    return set(range(P))


def _plan_fate(c, lost_set: set, P: int, reason: str, local: bool):
    """One container's fate, decided on the old runtime with the host
    state the apply step needs (:func:`_apply_restore`'s payloads):
    ``("rescue", ("snap", (meta, arrays)))``, ``("restore", ("merge",
    values))`` for a vector, ``("restore", ("snap", (meta, arrays)))``
    for a dense or sparse matrix, ``("restore", ("ckpt", path))`` for
    other kinds, or ``("lost", reason)``.  ``local``: read this
    process's rows alone (a multi-process rescue, where every rank of
    another process is in ``lost_set``); a rescue then merges them as a
    restore does, over no checkpoint."""
    from ..containers.distributed_vector import distributed_vector
    from ..containers.dense_matrix import dense_matrix
    from ..containers.sparse_matrix import sparse_matrix

    if not (_owned_ranks(c, P) & lost_set):
        if not local:
            from . import checkpoint as _ck
            return "rescue", ("snap", _ck.snapshot(c))
        if isinstance(c, distributed_vector):
            return "rescue", ("merge", _merge_vector_values(c, lost_set,
                                                            None))
        return "rescue", ("snap", _merge_matrix_snapshot(c, lost_set, None))
    path = checkpoint_path(c)
    if path is None:
        return "lost", reason
    if isinstance(c, distributed_vector):
        return "restore", ("merge", _merge_vector_values(c, lost_set, path))
    if isinstance(c, (dense_matrix, sparse_matrix)):
        return "restore", ("snap", _merge_matrix_snapshot(c, lost_set,
                                                          path))
    return "restore", ("ckpt", path)


def _merge_vector_values(c, lost_set: set, path) -> torch.Tensor:
    """The per-segment value: the checkpoint's logical array with every
    surviving rank's window overwritten by its live values (read rank by
    rank: nothing is read from a lost rank).  ``path`` None: no lost
    rank holds a segment, and the live windows cover the value."""
    from . import checkpoint as _ck

    if path is None:
        base = torch.zeros(len(c), dtype=c.dtype)
    else:
        meta, arrays = _ck.read(path)
        if meta.get("kind") != "vector":
            raise ValueError(f"checkpoint at {path} holds a "
                             f"{meta.get('kind')!r}, not this vector")
        base = torch.as_tensor(_ck._from_raw(np.asarray(arrays["data"])))
        if tuple(base.shape) != (len(c),):
            raise ValueError(f"checkpoint length {tuple(base.shape)} != "
                             f"live vector ({len(c)},)")
        base = base.to(c.dtype).clone()
    for r in range(c.nshards):
        if r in lost_set:
            continue
        b, e = c._rank_window(r)
        if b < e:
            base[b:e] = c._local_values(r, b, e).cpu()
    return base


def _blank_state(c):
    """A ``(meta, arrays)`` state of a dense or sparse matrix of ``c``'s
    shape holding no value: the base that live tiles cover when none
    lies on a lost rank (a multi-process rescue, which reads no other
    process)."""
    from . import checkpoint as _ck
    from ..containers.dense_matrix import dense_matrix

    if isinstance(c, dense_matrix):
        return ({"kind": "dense_matrix",
                 "grid": [int(g) for g in c.grid_shape],
                 "tile": [int(t) for t in c.partition.tile]},
                {"data": _ck._raw_host(torch.zeros(tuple(c.shape),
                                                   dtype=c.dtype))})
    none = np.zeros(0, np.int64)
    return ({"kind": "sparse_matrix", "shape": [int(s) for s in c.shape],
             "grid": [int(g) for g in c.grid_shape]},
            {"rows": none, "cols": none,
             "vals": _ck._raw_host(torch.zeros(0, dtype=c.dtype))})


def _merge_matrix_snapshot(c, lost_set: set, path):
    """The per-tile ``(meta, arrays)`` snapshot of a dense or sparse
    matrix: the checkpoint's state with every tile of a surviving rank
    overwritten by its live values (nothing is read from a lost rank);
    tiles of lost ranks rewind to the checkpoint.  ``path`` None: no
    lost rank holds a tile, and the live tiles cover the state."""
    from . import checkpoint as _ck
    from ..containers.dense_matrix import dense_matrix

    meta, arrays = _ck.read(path) if path is not None else _blank_state(c)
    want = "dense_matrix" if isinstance(c, dense_matrix) else "sparse_matrix"
    if meta.get("kind") != want:
        raise ValueError(f"checkpoint at {path} holds a "
                         f"{meta.get('kind')!r}, not this {want}")
    if tuple(int(s) for s in meta.get("shape", c.shape)) != tuple(c.shape):
        raise ValueError(f"checkpoint shape {meta.get('shape')} != live "
                         f"matrix {tuple(c.shape)}")
    meta = dict(meta)
    if isinstance(c, dense_matrix):
        base = torch.as_tensor(_ck._from_raw(np.asarray(arrays["data"])))
        if tuple(base.shape) != tuple(c.shape):
            raise ValueError(f"checkpoint shape {tuple(base.shape)} != "
                             f"live matrix {tuple(c.shape)}")
        base = base.to(c.dtype).clone()
        for seg in c.__dr_segments__():
            if seg.__dr_rank__() in lost_set:
                continue
            # the tile's shard-local read, not materialize(): that would
            # read the whole matrix, the lost rank's tiles included
            base[seg.rb:seg.re, seg.cb:seg.ce] = seg.__dr_local__().cpu()
        return meta, {"data": _ck._raw_host(base)}
    # sparse: survivors give their live triples; the checkpoint gives only
    # the entries inside the lost tiles' windows
    ck_rows = np.asarray(arrays["rows"])
    ck_cols = np.asarray(arrays["cols"])
    ck_vals = np.asarray(arrays["vals"])
    dead = np.zeros(ck_rows.shape, bool)
    rows, cols, vals = [], [], []
    for seg in c.__dr_segments__():
        inside = ((ck_rows >= seg.rb) & (ck_rows < seg.re)
                  & (ck_cols >= seg.cb) & (ck_cols < seg.ce))
        rk = seg.__dr_rank__()
        if rk in lost_set:
            dead |= inside
            continue
        r, cc, v = seg.triples()
        if c.dtype == torch.bfloat16:  # triples widen bf16
            v = _ck._raw_host(c._vals[rk][:len(seg)])
        rows.append(r)
        cols.append(cc)
        vals.append(v)
    rows.append(ck_rows[dead])
    cols.append(ck_cols[dead])
    vals.append(ck_vals[dead])
    return meta, {"rows": np.concatenate(rows), "cols": np.concatenate(cols),
                  "vals": np.concatenate(vals)}


def _apply_restore(c, payload, new_rt) -> None:
    from . import checkpoint as _ck
    kind, data = payload
    if kind == "merge":
        c._rebind(new_rt, None)
        c.assign_array(data)
    elif kind == "snap":
        meta, arrays = data
        _swap_state(c, _ck.rebuild(meta, arrays, runtime=new_rt,
                                   reblock=True), new_rt)
    else:
        _swap_state(c, _ck.load(data, runtime=new_rt, reblock=True), new_rt)


def rescue_session(err=None, *, lost_ranks: Optional[Sequence[int]] = None,
                   reason: str = "") -> ShrinkReport:
    """Shrink the session onto the surviving ranks and rescue its live
    containers.  ``lost_ranks`` overrides the rank ``err`` carries; a
    loss that names no rank presumes the last rank.  Raises classified
    on an impossible rescue (an invalid rank, the
    ``DR_GPU_ELASTIC_MIN_DEVICES`` floor, a loss during a rescue, a fault
    at ``mesh.shrink``); on success the global runtime is the shrunken
    one and the report says what happened to every container.

    In a multi-process runtime the survivors must all be this process's
    ranks (see the module docstring): the shrink reads nothing from
    another process and leaves the process group untouched."""
    global _shrinks, _rescued, _restored, _lost, _wall_s, _rescuing
    global _last_report
    from .. import obs as _obs
    from ..parallel import runtime as _rt

    if _rescuing:
        raise _resilience.ProgramError(
            "elastic: device loss during an active rescue; a nested "
            "shrink cannot run under the first one", site="mesh.shrink")
    if not _rt.is_initialized():
        raise _resilience.ProgramError(
            "elastic: no runtime to shrink (init() first)",
            site="mesh.shrink")
    rt = _rt.runtime()
    P = rt.nprocs
    if lost_ranks is not None:
        ranks = sorted({int(r) for r in lost_ranks})
    else:
        rank = getattr(err, "rank", None)
        ranks = [int(rank)] if rank is not None else [P - 1]
    if not ranks or any(not 0 <= r < P for r in ranks):
        # a rank of an older runtime must fail loudly: remapping it
        # would rescue the wrong rank's data
        raise _resilience.ProgramError(
            f"elastic: lost-rank attribution {ranks} is invalid for the "
            f"current {P}-rank runtime (stale topology?)",
            site="mesh.shrink")
    reason = reason or (f"{type(err).__name__}: {err}" if err is not None
                        else "requested shrink")
    min_dev = env_int("DR_GPU_ELASTIC_MIN_DEVICES", 1)
    lost_set = set(ranks)
    keep = [r for r in range(P) if r not in lost_set]
    survivors = [rt.devices[r] for r in keep]
    t0 = time.perf_counter()
    sid = _obs.begin("mesh.shrink", cat="elastic",
                     lost=",".join(map(str, ranks)), nprocs=P)
    _rescuing = True
    report = ShrinkReport(reason=reason, lost_ranks=ranks, nprocs_before=P,
                          nprocs_after=len(survivors))
    try:
        _obs.event("device.lost", cat="elastic",
                   ranks=",".join(map(str, ranks)),
                   error=type(err).__name__ if err is not None
                   else "requested")
        _faults.fire("mesh.shrink", lost=tuple(ranks))
        if rt.multi_process and not set(keep) <= set(rt.local_ranks):
            away = sorted(r for r in keep if not rt.is_local(r))
            raise _resilience.ProgramError(
                f"elastic: the loss of rank(s) {ranks} leaves survivors in "
                f"several processes (rank(s) {away} live in other "
                f"processes than this one, process {rt.process_index} of "
                f"{rt.process_count}); a shrink builds a single-process "
                "runtime and cannot span the process group. Pass "
                "lost_ranks covering every rank of the other processes "
                "to downgrade this process to its own ranks",
                site="mesh.shrink")
        if len(survivors) < max(1, min_dev):
            raise _resilience.DeviceLostError(
                f"elastic: cannot shrink below DR_GPU_ELASTIC_MIN_DEVICES="
                f"{min_dev} ({len(survivors)} survivor(s) of {P}); "
                f"original loss: {reason}", site="mesh.shrink")
        # fates and host snapshots come from the old runtime, before it
        # flips
        fates = []
        for c in rt.live_containers():
            tc = time.perf_counter()
            try:
                fate = _plan_fate(c, lost_set, P, reason, rt.multi_process)
            except Exception as e:
                # a failed gather (a second fault on a dispatch, say)
                # must not take the rest of the session down: a
                # checkpoint still restores the container whole
                path = checkpoint_path(c)
                fate = ("restore", ("ckpt", path)) if path is not None \
                    else ("lost", f"{reason}; rescue gather failed: {e!r}")
            fates.append((c,) + fate + (time.perf_counter() - tc,))
        new_rt = _rt.init(survivors)
        if rt.multi_process:
            # no collective: a peer may be dead
            _rt._leave_group(
                f"shrank from {P} ranks over {rt.process_count} processes "
                f"onto rank(s) {keep} of process {rt.process_index}")
        new_rt.slots = [rt.slots[r] for r in keep]
        new_rt.dropped = sorted(rt.dropped + [(rt.slots[r], rt.devices[r])
                                              for r in ranks],
                                key=lambda sd: sd[0])
        for c, fate, payload, read_s in fates:
            name = type(c).__name__
            ta = time.perf_counter()
            try:
                if fate != "lost":
                    _apply_restore(c, payload, new_rt)
            except Exception as e:
                # a container that cannot land on the smaller runtime (a
                # halo wider than the new segment, a cyclic grid that
                # does not fit, a corrupt checkpoint) is lost, loudly
                fate, payload = "lost", f"{reason}; {fate} failed: {e!r}"
            if fate == "lost":
                _poison(c, payload)
                report.lost += 1
                detail = payload
            elif fate == "restore":
                report.restored += 1
                detail = payload[0]
            else:
                report.rescued += 1
                detail = ""
            report.fates.append((fate, name, detail))
            report.seconds.append(read_s + time.perf_counter() - ta)
        del fates
        # no key over the old ranks can match again: drop its cache
        # entries, plan graphs and their memory pools with them
        _pinning.release(rt)
        report.wall_s = round(time.perf_counter() - t0, 4)
        _shrinks += 1
        _rescued += report.rescued
        _restored += report.restored
        _lost += report.lost
        _wall_s += report.wall_s
        _last_report = report
        _publish(report)
        _announce(f"runtime shrank {P} -> {len(survivors)} rank(s) (lost "
                  f"rank(s) {ranks}): {report.rescued} rescued, "
                  f"{report.restored} restored, {report.lost} lost; "
                  f"{reason}")
        return report
    except _resilience.ResilienceError as e:
        # a failed rescue leaves its chapter too
        os.environ["_DR_GPU_ELASTIC_REASON"] = f"shrink failed: {e}"[:200]
        raise
    finally:
        _rescuing = False
        _obs.end(sid, survivors=len(survivors), rescued=report.rescued,
                 restored=report.restored, lost=report.lost)


def try_rescue(err) -> bool:
    """The guarded shrink of the automatic hooks: False (announced) when
    the rescue is impossible, and the caller then surfaces the original
    loss.  Never raises a classified error."""
    try:
        rescue_session(err)
        return True
    except _resilience.ResilienceError as e:
        _announce(f"rescue failed ({e}); surfacing the original device "
                  "loss")
        return False


def _publish(report: ShrinkReport) -> None:
    """The cumulative shrink chapter as environment markers."""
    os.environ["_DR_GPU_ELASTIC_REASON"] = report.reason[:200]
    os.environ["_DR_GPU_ELASTIC_SHRINKS"] = str(_shrinks)
    os.environ["_DR_GPU_ELASTIC_LOST_RANKS"] = \
        ",".join(map(str, report.lost_ranks))
    os.environ["_DR_GPU_ELASTIC_RESCUED"] = str(_rescued)
    os.environ["_DR_GPU_ELASTIC_RESTORED"] = str(_restored)
    os.environ["_DR_GPU_ELASTIC_LOST"] = str(_lost)
    os.environ["_DR_GPU_ELASTIC_NPROCS"] = str(report.nprocs_after)
    os.environ["_DR_GPU_ELASTIC_WALL_S"] = f"{_wall_s:.4f}"


# ---------------------------------------------------------------------------
# grow-back
# ---------------------------------------------------------------------------

def _grown_slots(rt, devices):
    """The rank slots of the runtime over ``devices``: each device takes
    the first unclaimed slot of ``rt`` on an equal device, else the first
    dropped slot on one, else a new slot.  Returns (slots, still
    dropped)."""
    current = list(zip(rt.slots, rt.devices))
    dropped = list(rt.dropped)
    nxt = max([s for s, _ in current] + [s for s, _ in dropped] + [-1]) + 1
    slots = []
    for d in devices:
        for pool in (current, dropped):
            hit = next((i for i, (_s, dd) in enumerate(pool) if dd == d),
                       None)
            if hit is not None:
                slots.append(pool.pop(hit)[0])
                break
        else:
            slots.append(nxt)
            nxt += 1
    return slots, dropped


def grow_session(devices=None, *, reason: str = "",
                 require_growth: bool = True) -> "GrowReport":
    """Re-admit recovered capacity: re-init the runtime on ``devices``
    (default: the current ranks plus the dropped slots
    ``runtime.probe_recovered`` finds answering) and move every live
    container onto it, in place.  ``require_growth=False`` admits a
    target of the same size.

    A grow never makes things worse: ``mesh.grow`` fires before the
    rebuild, so a fault there raises classified with the session
    untouched; a container whose move fails is ``kept`` on the old
    runtime, value intact; a container a shrink poisoned stays poisoned.
    On success the global runtime is the grown one and the
    ``_DR_GPU_ELASTIC_GROW_*`` markers are published."""
    _rt_mod.require_single_process("grow_session",
                                   _rt_mod.NO_READMISSION)
    global _grows, _moved, _kept, _grow_wall_s, _rescuing, _last_grow
    from .. import obs as _obs
    from ..parallel import runtime as _rt

    if _rescuing:
        raise _resilience.ProgramError(
            "elastic: grow during an active rescue or grow; a second "
            "re-layout cannot run under the first one", site="mesh.grow")
    if not _rt.is_initialized():
        raise _resilience.ProgramError(
            "elastic: no runtime to grow (init() first)", site="mesh.grow")
    rt = _rt.runtime()
    P = rt.nprocs
    if devices is None:
        recovered = _rt.probe_recovered()
        if not recovered:
            raise _resilience.ProgramError(
                "elastic: the recovery probe found no dropped rank slot "
                f"answering beyond the current {P} ranks; nothing to "
                "re-admit", site="mesh.grow")
        devices = rt.devices + list(recovered)
    devices = [_rt._as_device(d) for d in devices]
    if require_growth and len(devices) <= P:
        raise _resilience.ProgramError(
            f"elastic: the grow target has {len(devices)} rank(s), no more "
            f"than the current {P}; nothing to re-admit", site="mesh.grow")
    reason = reason or (f"re-admitting {len(devices) - P} recovered "
                        "device(s)")
    t0 = time.perf_counter()
    sid = _obs.begin("mesh.grow", cat="elastic", nprocs=P,
                     target=len(devices))
    _rescuing = True
    report = GrowReport(reason=reason, nprocs_before=P,
                        nprocs_after=len(devices))
    try:
        _obs.event("device.recover", cat="elastic",
                   admitted=len(devices) - P)
        _faults.fire("mesh.grow", target=len(devices))
        _validate_admitted(devices, rt)
        slots, still = _grown_slots(rt, devices)
        live = rt.live_containers()
        new_rt = _rt.init(devices)
        new_rt.slots, new_rt.dropped = slots, still
        for c in live:
            name = type(c).__name__
            if is_lost(c):
                report.poisoned += 1
                report.fates.append(("poisoned", name, ""))
                report.seconds.append(0.0)
                continue
            tc = time.perf_counter()
            try:
                redistribute(c, None, runtime=new_rt)
                report.moved += 1
                report.fates.append(("moved", name, ""))
            except Exception as e:
                # never worse than not growing: the container stays on
                # the old runtime, which is still live
                report.kept += 1
                report.fates.append(("kept", name, repr(e)))
                _announce(f"grow: {name} stays on the {P}-rank runtime "
                          f"(move failed: {e!r})")
            report.seconds.append(time.perf_counter() - tc)
        del live
        if not report.kept:
            _pinning.release(rt)
        report.wall_s = round(time.perf_counter() - t0, 4)
        _grows += 1
        _moved += report.moved
        _kept += report.kept
        _grow_wall_s += report.wall_s
        _last_grow = report
        _publish_grow(report)
        _announce(f"runtime grew {P} -> {len(devices)} rank(s): "
                  f"{report.moved} moved, {report.kept} kept, "
                  f"{report.poisoned} left poisoned; {reason}")
        return report
    finally:
        _rescuing = False
        _obs.end(sid, nprocs=report.nprocs_after, moved=report.moved,
                 kept=report.kept, poisoned=report.poisoned)


def _validate_admitted(devices, rt) -> None:
    """Touch every CUDA device being admitted that the current runtime
    does not use, under a deadline: a listed card that does not answer
    fails the grow classified before anything moves.  A device the
    current ranks use is live already."""
    have = set(rt.devices)
    fresh = [d for d in dict.fromkeys(devices)
             if d not in have and d.type == "cuda"]
    if not fresh:
        return

    def touch():
        for d in fresh:
            if d.index >= torch.cuda.device_count():
                raise RuntimeError(f"{d} is not a visible device")
            torch.empty(1, device=d)
            torch.cuda.synchronize(d)

    try:
        _resilience.with_deadline(touch, 30.0, site="mesh.grow", dump=False)
    except _resilience.ResilienceError:
        raise
    except Exception as e:
        raise _resilience.classified(
            f"elastic: re-admission validation failed; a listed device "
            f"did not answer ({e!r})", site="mesh.grow") from e


def _publish_grow(report: GrowReport) -> None:
    """The cumulative grow chapter as environment markers."""
    os.environ["_DR_GPU_ELASTIC_GROW_REASON"] = report.reason[:200]
    os.environ["_DR_GPU_ELASTIC_GROWS"] = str(_grows)
    os.environ["_DR_GPU_ELASTIC_GROW_NPROCS"] = str(report.nprocs_after)
    os.environ["_DR_GPU_ELASTIC_GROW_MOVED"] = str(_moved)
    os.environ["_DR_GPU_ELASTIC_GROW_KEPT"] = str(_kept)
    os.environ["_DR_GPU_ELASTIC_GROW_WALL_S"] = f"{_grow_wall_s:.4f}"


class GrowSupervisor(_resilience.ProbeTimer):
    """Bounded, seeded-backoff pacing of the recovery probes.  Passive:
    it owns no thread, the owner polls it between flushes.  Delays start
    at ``DR_GPU_ELASTIC_GROW_PROBE_S``, double up to
    ``DR_GPU_ELASTIC_GROW_PROBE_CAP_S``, and stop after
    ``DR_GPU_ELASTIC_GROW_PROBES`` probes."""

    def __init__(self, *, seed: int = 0):
        super().__init__(env_float("DR_GPU_ELASTIC_GROW_PROBE_S", 1.0),
                         env_float("DR_GPU_ELASTIC_GROW_PROBE_CAP_S", 60.0),
                         env_int("DR_GPU_ELASTIC_GROW_PROBES", 64), seed=seed)
        self.failures = 0
        self.grows = 0

    def poll(self, attempt) -> Optional[GrowReport]:
        """Run ``attempt()`` if a probe is due: its :class:`GrowReport`,
        or None when nothing recovered.  A failed attempt is counted and
        announced, and the session stays where it was.  Never raises."""
        now = time.monotonic()
        if not self.due(now):
            return None
        self.advance(now)
        try:
            rep = attempt()
        except Exception as e:
            self.failures += 1
            _announce(f"grow probe {self.probes}/{self.budget} failed "
                      f"({_resilience.classified(e)}); staying on the "
                      "current runtime")
            return None
        if rep is not None:
            self.grows += 1
        return rep


def _probe_and_grow() -> Optional[GrowReport]:
    """The supervisor's attempt: probe the dropped slots and re-admit the
    ones that answer."""
    from ..parallel import runtime as _rt
    recovered = _rt.probe_recovered()
    if not recovered:
        return None
    rt = _rt.runtime()
    return grow_session(
        devices=rt.devices + list(recovered),
        reason=f"recovery probe: {len(recovered)} device(s) returned")


def maybe_grow() -> Optional[GrowReport]:
    """The between-flushes poll: with ``DR_GPU_ELASTIC_GROW=1`` and a
    shrunken session, poll the supervisor and grow back when a dropped
    slot answers.  One environment check when disarmed; raises only its
    classified refusal, when armed in a multi-process runtime."""
    global _grow_sup, _grow_sup_epoch
    if not grow_enabled() or _rescuing or _shrinks == 0:
        return None
    _rt_mod.require_single_process("maybe_grow", _rt_mod.NO_READMISSION)
    from ..parallel import runtime as _rt
    if not _rt.is_initialized():
        return None
    if not _grow_lock.acquire(blocking=False):
        return None
    try:
        if _grow_sup is None or _grow_sup_epoch != _shrinks:
            _grow_sup = GrowSupervisor()  # a new shrink: a full budget
            _grow_sup_epoch = _shrinks
        rep = _grow_sup.poll(_probe_and_grow)
        if rep is not None:
            # a partial recovery keeps probing for the rest
            _grow_sup = GrowSupervisor()
            _grow_sup_epoch = _shrinks
        return rep
    finally:
        _grow_lock.release()


def reset() -> None:
    """Clear the markers, the checkpoint registry, the counters and the
    grow supervisor (between tests)."""
    global _shrinks, _rescued, _restored, _lost, _wall_s, _last_report
    global _rescuing, _grows, _moved, _kept, _grow_wall_s, _last_grow
    global _grow_sup, _grow_sup_epoch
    _shrinks = _rescued = _restored = _lost = 0
    _wall_s = 0.0
    _last_report = None
    _rescuing = False
    _grows = _moved = _kept = 0
    _grow_wall_s = 0.0
    _last_grow = None
    _grow_sup = None
    _grow_sup_epoch = -1
    _ckpts.clear()
    for m in MARKERS + GROW_MARKERS:
        os.environ.pop(m, None)
