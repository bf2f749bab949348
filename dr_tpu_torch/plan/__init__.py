"""Deferred execution plans (counterpart of ``dr_tpu/plan/__init__.py``).

Inside a region, calls on segment-aligned containers are RECORDED
instead of run, and the plan executes them at a flush::

    with dt.deferred() as p:
        dt.fill(a, 0.5)
        dt.for_each(a, scale, 1.5)
        dt.halo(a).exchange()
        dt.transform(a, b, shift, 2.0)
        total = dt.reduce(b)            # -> lazy PlanScalar
    print(float(total), p.explain())

Recorded: fill / iota / copy (host splice) / for_each / transform /
reduce / transform_reduce / dot, halo exchange / exchange_n / reduce,
stencil_transform, a collective redistribute, histogram and top_k (all
FUSIBLE: they join the open run), and inclusive / exclusive scan, the
iterated and blocked stencils, gemv, join, groupby_aggregate and unique
(OPAQUE: deferred in record order, run through their eager path at the
flush; they split the runs around them).  A run is a maximal sequence
of fusible ops over one runtime.

Flush points: region exit; host reads and writes of a container
(``to_array``, ``get``, ``put``, indexing, ``materialize``; gated by the
queue's footprint), ``fence``, ``dot_n`` / ``inclusive_scan_n`` /
``gemv_n``, a ``*_finalize`` of a halo, resolving a :class:`PlanScalar`;
a non-fusible op (sort, an unaligned route, a custom-op reduce, the
host-staged re-layout: :meth:`Plan.nonfusible`); and :meth:`Plan.flush`.

What a run is on the device.  The JAX package compiles a run into one
jitted program and has to seal every value crossing an op boundary
(a runtime ``*1.0`` and an optimization barrier), because XLA fuses
across op boundaries.  Eager PyTorch fuses nothing: a run here executes
each op's eager row function in record order, so a flush has the eager
sequence's bits by construction, and there is nothing in place of the
seal.  On CUDA ranks the counterpart of "one program per run" is a
``torch.cuda.CUDAGraph`` of the run:

* a run is captured only when every row of its containers lies on one
  CUDA device and every op was recorded ``graph_safe`` (no host sync, no
  data-dependent shape, every scalar operand a host number); the route
  is fixed by the device and by those flags, never by a failed capture;
* a key's first flush runs the ops in order; a later flush over the
  same rows and scalar values captures the run and replays it, and the
  flushes after that replay it.  The cache entry (``_plan_cache``,
  keyed as the JAX package keys its programs) holds the graph with the
  rows' ``data_ptr()``s and the scalar operands it baked in, and the
  signature of the last in-order run: a flush over other rows or other
  values runs in order (and captures when that signature repeats), so a
  graph never writes into another container of the same layout, and
  values that change every flush never pay a capture.  Scalars are
  keyed by value because the same bf16 multiply gives other bits when
  the scalar arrives as a device tensor instead of a Python number;
* an op that replaces a container's rows (a stencil step, a histogram,
  a top_k) writes the new rows back into the old ones in a graph
  candidate, in order as in the graph, so the containers keep their
  storage.  Rows that an opaque op replaces (the iterated stencils, the
  scans) move, and a run over them runs in order at every flush;
* a capture or a replay that fails raises classified
  (``utils/resilience``); nothing runs the ops in order instead.  CPU
  ranks always take the in-order route.  :meth:`Plan.stats` counts
  ``graph_captures``, ``graph_replays`` and ``eager_runs``;
* a scalar produced inside a graph lives in its static buffer and is
  cloned out after each replay; an op later in the same run reads it on
  the device, with no sync.  A replay adds the kernel launches its
  capture recorded to ``ops.kernels.launches``.

Failure model: ``plan.flush`` and ``sanitize.verify`` fire before
anything runs.  A fault there (or in a run's ``pre`` hooks, which fire
before the run executes) drops the unexecuted suffix of the queue: the
containers keep their pre-flush values for it, recorded re-layouts undo
their metadata flip, and unresolved :class:`PlanScalar` handles raise.

Elastic replay: every record call also logs a thunk that records it
again.  With ``DR_GPU_ELASTIC=1``, a ``DeviceLostError`` in the middle
of a flush undoes the unexecuted suffix's re-layouts, shrinks the
session (``utils/elastic.try_rescue``), records the suffix again on the
rescued containers and flushes it with reason ``"elastic replay"``;
pending handles of the dropped suffix take the values of their
re-recorded twins, and the faulted flush's log entry carries
``elastic_replayed``.  With elastic off, or when no rescue is possible,
the loss drops the queue as any other fault does.  The outermost
:func:`deferred` region's clean exit polls ``elastic.maybe_grow()``
(one environment check unless ``DR_GPU_ELASTIC_GROW=1``).

Across processes (``init_distributed``): every process records the same
calls in the same order, so its queue, its runs and its flush points
are the single controller's, and each run executes its ops in order on
the process's own rows (the row functions skip another process's
ranks and message it where the eager op does: a halo, a reduce, a
stencil step, a redistribute, a histogram, a top_k, a for_each over a
zip).  Opaque items take their eager multi-process paths.  A
:class:`PlanScalar` resolves to the same value on every process (the
reduce folds the gathered partials in rank order).  The route of a run
follows from its recorded ops and the runtime alone: a run holding an
op that messages another process (``_FusedOp.messages``) runs in order
on every process, since a capture on one process and an in-order run on
its peer would wait on each other's messages; a run of rank-local ops
may capture as with one controller.  The optimizer and ``plansan``
decide from the recorded ops, so every process rewrites and checks its
queue alike, and ``stats()`` / ``explain()`` are the same everywhere.

Optimizer: ``plan/opt.py`` rewrites the recorded queue at each flush
(merge, dce, pushdown; ``DR_GPU_PLAN_OPT`` / ``DR_GPU_PLAN_OPT_DISABLE``).
Under ``DR_GPU_SANITIZE=1``, ``plan/plansan.py`` verifies each run's
footprints and the optimized order, and every run's output is checked
finite.  Under tracing, each flush is a ``plan.flush`` span with
``plan.run`` / ``plan.opaque`` children and the ``plan.*`` counters.
"""

from __future__ import annotations

import threading as _threading
from contextlib import contextmanager
from typing import List, Optional

import numpy as np
import torch

from .. import obs as _obs
from ..algorithms import elementwise as _ew
from ..core.pinning import pinned_id
from ..ops import kernels as _kernels
from ..utils import faults as _faults
from ..utils import resilience as _resilience
from ..utils import sanitize as _sanitize
from ..utils import spmd_guard as _guard
from ..utils.spmd_guard import TappedCache, dtype_name
from ..views import views as _v

__all__ = ["Plan", "PlanScalar", "deferred", "active", "flush_reads",
           "barrier"]

#: the fused-run cache: one lookup per run executed, with the JAX
#: package's key; the value is the run's :class:`_GraphEntry`
_plan_cache: dict = TappedCache()

#: the recording plan is per thread (the program cache is shared)
_tls = _threading.local()


def _get_active() -> Optional["Plan"]:
    return getattr(_tls, "active", None)


def _set_active(p: Optional["Plan"]) -> None:
    _tls.active = p


def active() -> Optional["Plan"]:
    """The plan recording on this thread, or None.  None while a flush
    executes, so opaque thunks run eagerly instead of recording again."""
    p = _get_active()
    if p is None or p._flushing:
        return None
    return p


def flush_reads(reason: str = "host materialization", cont=None) -> None:
    """Flush the active plan before host-visible state is read or
    written.  With ``cont``, the flush is skipped when the queue provably
    never touches that container (``interference.queue_touches``)."""
    p = _get_active()
    if p is None or p._flushing or not p._queue:
        return
    if cont is not None and not p.queue_touches(cont):
        return
    p.flush(reason)


def barrier(what: str) -> None:
    """A non-fusible op is about to run eagerly: flush the active plan."""
    p = active()
    if p is not None:
        p.nonfusible(what)


class PlanScalar:
    """Lazy scalar of a reduction recorded in a deferred region.

    Resolving it (``item()`` / ``float()`` / ``int()`` / ``bool()`` /
    ``device()``) flushes the owning plan if needed.  While pending it can
    be passed as a scalar to later recorded ops: in the same run it stays
    on the device; across runs it is read at the consumer's flush."""

    __slots__ = ("_plan", "_run", "_idx", "_val", "_post", "_broken")

    def __init__(self, plan: "Plan", run, idx: int):
        self._plan = plan
        self._run = run
        self._idx = idx
        self._val = None
        self._post = None
        self._broken = False

    def with_post(self, post) -> "PlanScalar":
        """Attach the host-side fold :meth:`item` applies
        (``reduce(r, init=...)``): ``post`` takes the raw device scalar
        and returns the host value."""
        self._post = post
        return self

    def device(self) -> torch.Tensor:
        """The raw device scalar; refused for a handle with a host-side
        fold (the raw value would drop it)."""
        if self._post is not None:
            raise ValueError(
                "this deferred scalar carries a host-side init fold; "
                "resolve it with item()/float() instead of device()")
        return self._raw()

    def _raw(self) -> torch.Tensor:
        if self._val is None and not self._broken:
            self._plan.flush("scalar read")
        if self._val is None:
            raise RuntimeError(
                "deferred scalar was discarded before it resolved "
                "(faulted flush or abandoned region)")
        return self._val

    def item(self):
        v = self._raw()
        return self._post(v) if self._post is not None else v.item()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __index__(self):
        return int(self.item())

    def __bool__(self):
        return bool(self.item())

    def __eq__(self, other):
        # resolves: an identity comparison would be silently False
        if isinstance(other, PlanScalar):
            other = other.item()
        return self.item() == other

    # hashing would be a hidden flush
    __hash__ = None

    def __repr__(self):
        state = ("broken" if self._broken
                 else "pending" if self._val is None
                 else repr(self._val.item()))
        return f"PlanScalar({state})"


def _host_scalar(v) -> bool:
    return isinstance(v, (bool, int, float, complex, np.generic))


class _FusedOp:
    """One recorded fusible op: structural ``key``, ``emit(state, svals,
    souts)`` (``state[slot]`` is a container's list of rank rows, written
    in place or replaced), scalar ``spec`` ("t" = an operand of this
    recording, ("r", i) = scalar output i of the same run), the operand
    ``vals``, an optional ``pre`` hook fired before the run executes,
    and ``graph_safe`` (the op may be captured into a CUDA graph).

    Footprint (``plan/interference.py`` reads it): ``reads`` are run
    slots whose values the op consumes; ``writes`` are ``(slot, off, n,
    full)`` windows (``full``: the whole padded row is rebuilt); ``pure``
    ops may be eliminated by the dce pass; ``push`` carries what the
    pushdown pass needs; ``src`` is the recorded op a merged wrapper
    runs.  ``messages``: across processes the op exchanges values with
    another process (its run then runs in order everywhere)."""

    __slots__ = ("name", "key", "emit", "spec", "vals", "pre", "reads",
                 "writes", "pure", "push", "src", "graph_safe", "messages")

    def __init__(self, name, key, emit, spec=(), vals=(), pre=None,
                 reads=(), writes=(), pure=False, push=None,
                 graph_safe=True, messages=False):
        self.name = name
        self.key = key
        self.emit = emit
        self.spec = spec
        self.vals = list(vals)
        self.pre = pre
        self.reads = tuple(reads)
        self.writes = tuple(writes)
        self.pure = pure
        self.push = push
        self.src = None
        self.messages = messages
        self.graph_safe = graph_safe and all(_host_scalar(v)
                                             for v in self.vals)


class _Run:
    """A maximal fusible run: ops over one runtime, containers in
    first-use slot order, reduction handles in output order."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.ops: List[_FusedOp] = []
        self.conts = []
        self._cont_ids = {}
        self.handles: List[PlanScalar] = []

    def slot(self, cont) -> int:
        s = self._cont_ids.get(id(cont))
        if s is None:
            s = len(self.conts)
            self.conts.append(cont)
            self._cont_ids[id(cont)] = s
        return s


class _Opaque:
    """A recorded but not fused op, run through its eager path at the
    flush in record order.  ``reads`` are containers, ``writes`` are
    ``(container, full)`` pairs; None for either makes the item a
    barrier no pass reorders across.  ``meta`` is the relational record
    the pushdown pass may rewrite (the thunk re-reads it)."""

    __slots__ = ("name", "thunk", "reads", "writes", "meta")

    def __init__(self, name, thunk, reads=None, writes=None, meta=None):
        self.name = name
        self.thunk = thunk
        self.reads = None if reads is None else tuple(reads)
        self.writes = None if writes is None else tuple(writes)
        self.meta = meta


def _body(ops, state, tail) -> list:
    """Run the ops in record order over ``state``; returns the scalar
    outputs."""
    tail = iter(tail)
    souts: list = []
    for o in ops:
        svals = [souts[s[1]] if isinstance(s, tuple) else next(tail)
                 for s in o.spec]
        o.emit(state, svals, souts)
    return souts


def _row_devices(rows, rt) -> list:
    """The device of each rank of ``rows``: the row's own, and for a
    rank another process owns (a None row) the runtime's entry, where
    values received from that rank land (what the eager ops pass)."""
    return [d if r is None else r.device for r, d in zip(rows, rt.devices)]


def _graph_device(run) -> Optional[torch.device]:
    """The one CUDA device every row this process holds of the run lies
    on, else None."""
    dev = None
    for c in run.conts:
        for row in c._rows:
            if row is None:
                continue
            d = row.device
            if d.type != "cuda" or (dev is not None and d != dev):
                return None
            dev = d
    return dev


def _value_key(v):
    return (type(v).__name__, repr(v))


class _GraphEntry:
    """What ``_plan_cache`` holds for one run key: the signature (the
    rows' addresses and the scalar values) of the last run made in
    order, and the run's CUDA graph with the signature it baked in, its
    static scalar outputs and the kernel launches one replay makes."""

    __slots__ = ("seen", "graph", "sig", "souts", "launches")

    def __init__(self):
        self.seen = None
        self.graph = None
        self.sig = None
        self.souts = ()
        self.launches = {}

    def route(self, run, tail, dev) -> str:
        """The route of this flush: ``replay`` when the held graph was
        made over these rows and values, ``capture`` when the last run
        in order was, else ``eager`` (this signature is remembered)."""
        sig = (tuple(r.data_ptr() for c in run.conts for r in c._rows
                     if r is not None),
               tuple(_value_key(v) for v in tail))
        if self.graph is not None and self.sig == sig:
            return "replay"
        if self.seen == sig:
            return "capture"
        self.seen = sig
        return "eager"

    def capture(self, run, tail, dev) -> None:
        """Capture ``run`` over its rows (the signature last seen)."""
        self.graph, self.sig, self.souts = None, None, ()
        rows = [list(c._rows) for c in run.conts]
        state = [list(r) for r in rows]
        before = dict(_kernels.launches)
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(dev), torch.cuda.graph(g):
                souts = _body(run.ops, state, tail)
                # an op that replaced a container's rows writes its
                # result back: the graph keeps the containers' storage
                for orig, new in zip(rows, state):
                    for a, b in zip(orig, new):
                        if a is not b:
                            a.copy_(b)
        except Exception as e:
            raise _resilience.classified(e, site="plan.flush") from e
        finally:
            # a capture launches nothing: its launches move to replays
            self.launches = {k: _kernels.launches[k] - before[k]
                             for k in before
                             if _kernels.launches[k] != before[k]}
            _kernels.launches.update(before)
        self.graph, self.sig, self.souts = g, self.seen, tuple(souts)

    def replay(self) -> list:
        try:
            self.graph.replay()
        except Exception as e:
            raise _resilience.classified(e, site="plan.flush") from e
        for k, d in self.launches.items():
            _kernels.launches[k] += d
        return [s.clone() for s in self.souts]


class Plan:
    """A deferred execution plan: record algorithm calls, group them into
    runs, execute them at a flush.  Use :func:`deferred` or
    ``with Plan().record(): ...``."""

    def __init__(self):
        self._queue: list = []
        self._flushing = False
        #: structured flush log read by explain() / stats()
        self.log: list = []
        #: (queue item, undo thunk) of each recorded re-layout
        self._undo: list = []
        #: (queue item, thunk recording the op again, its handle or
        #: None) of each recorded op: the elastic replay log
        self._replay: list = []
        #: during an elastic replay only: id(old pending handle) -> its
        #: re-recorded handle
        self._subst: dict = {}

    def _note_undo(self, thunk) -> None:
        self._undo.append((self._queue[-1], thunk))

    def _note_replay(self, thunk, handle=None) -> None:
        self._replay.append((self._queue[-1], thunk, handle))

    def _subst_scalars(self, values) -> list:
        """``values`` with pending handles mapped to their re-recorded
        twins (the identity outside an elastic replay)."""
        if not self._subst:
            return list(values)
        return [self._subst.get(id(v), v) if isinstance(v, PlanScalar)
                else v for v in values]

    @staticmethod
    def _undo_items(undos, items) -> None:
        """Undo the metadata flip of every unexecuted item, newest
        first."""
        ids = {id(it) for it in items}
        for item, thunk in reversed(undos):
            if id(item) in ids:
                thunk()

    def queue_touches(self, cont) -> bool:
        """Could a queued item read or write ``cont``?"""
        from . import interference as _interf
        return _interf.queue_touches(self._queue, cont)

    # ------------------------------------------------------------ region
    @contextmanager
    def record(self):
        """Make this plan the recording one on this thread for the block;
        flushes on a clean exit, discards the pending ops if it raises."""
        if _get_active() is self:
            yield self
            return
        if _get_active() is not None:
            raise RuntimeError("another deferred plan is already "
                               "recording on this thread")
        _set_active(self)
        try:
            yield self
        except BaseException:
            self.discard("region error")
            raise
        else:
            self.flush("region exit")
        finally:
            _set_active(None)

    # --------------------------------------------------------- recording
    def _fusible_run(self, cont, values=()) -> _Run:
        """The open run for this container's runtime.  A runtime change
        ends the run, and so does consuming a pending scalar of the open
        run that carries a host-side fold (the producer must run first)."""
        rt = cont.runtime
        q = self._queue
        if q and isinstance(q[-1], _Run) and q[-1].runtime is rt \
                and not any(isinstance(v, PlanScalar) and v._run is q[-1]
                            and v._val is None and v._post is not None
                            for v in values):
            return q[-1]
        run = _Run(rt)
        q.append(run)
        return run

    def _scalar_spec(self, run: _Run, values):
        """A pending scalar of the same run becomes ("r", idx); any other
        value is an operand ("t") fetched at the flush."""
        spec, vals = [], []
        for v in values:
            if isinstance(v, PlanScalar) and v._run is run \
                    and v._val is None and v._post is None:
                spec.append(("r", v._idx))
            else:
                spec.append("t")
                vals.append(v)
        return tuple(spec), vals

    def record_generator(self, out_chain, gkind: str, value) -> bool:
        """fill / iota over an aligned output window."""
        cont = out_chain.cont
        value = self._subst_scalars([value])[0]
        run = self._fusible_run(cont, [value])
        slot = run.slot(cont)
        layout, off, n = cont.layout, out_chain.off, out_chain.n
        spec, vals = self._scalar_spec(run, [value])
        key = ("gen", gkind, slot, layout, off, n, dtype_name(cont.dtype),
               spec)
        rows_fn = _ew._fill_rows if gkind == "fill" else _ew._iota_rows

        def emit(state, svals, souts):
            rows_fn(state[slot], layout, off, n, svals[0])

        run.ops.append(_FusedOp(gkind, key, emit, spec, vals,
                                writes=((slot, off, n, False),),
                                pure=True))
        self._note_replay(lambda oc=out_chain, g=gkind, v=value:
                          self.record_generator(oc, g, v))
        return True

    def record_transform(self, ins, out_chain, op, scalars,
                         name="transform") -> bool:
        """Aligned transform / for_each: chain ``BoundOp`` scalars and
        the trailing scalars are operands."""
        cont = out_chain.cont
        chain_sc = self._subst_scalars(_ew._chain_scalars(ins))
        scalars = self._subst_scalars(scalars)
        all_sc = chain_sc + scalars
        run = self._fusible_run(cont, all_sc)
        out_slot = run.slot(cont)
        in_slots = tuple(run.slot(c.cont) for c in ins)
        in_ops = tuple(c.ops for c in ins)
        nchain = len(chain_sc)
        spec, vals = self._scalar_spec(run, all_sc)
        layout, off, n = cont.layout, out_chain.off, out_chain.n
        key = ("ew", out_slot, in_slots, layout, off, n,
               tuple(tuple(_ew._traced_op_key(o) for o in ops)
                     for ops in in_ops),
               _ew._op_key(op), dtype_name(cont.dtype), spec)

        def emit(state, svals, souts):
            _ew._transform_rows(state[out_slot], [state[s] for s in in_slots],
                                in_ops, layout, off, n, op, svals[nchain:],
                                svals[:nchain])

        # pushdown eligibility: a single plain same-dtype input and no
        # scalar that is a pending handle
        push = None
        if (len(ins) == 1 and not ins[0].ops
                and ins[0].cont.dtype == cont.dtype
                and not any(isinstance(s, PlanScalar) for s in all_sc)):
            push = (ins[0].cont, off, n, op, tuple(scalars))
        run.ops.append(_FusedOp(
            name, key, emit, spec, vals, reads=in_slots,
            writes=((out_slot, off, n, False),), pure=True, push=push))
        self._note_replay(lambda i=ins, oc=out_chain, o=op,
                          sc=tuple(scalars), nm=name:
                          self.record_transform(i, oc, o, sc, nm))
        return True

    def record_zip_foreach(self, ins, outs, fn, scalars) -> bool:
        """Aligned for_each over a zip (its components are the outputs)."""
        conts = [oc.cont for oc in outs]
        scalars = self._subst_scalars(scalars)
        run = self._fusible_run(conts[0], scalars)
        out_slots = tuple(run.slot(c) for c in conts)
        in_slots = tuple(run.slot(ch.cont) for ch in ins)
        spec, vals = self._scalar_spec(run, list(scalars))
        in_wins, out_wins = _ew._wins(ins), _ew._wins(outs)
        off, n = outs[0].off, outs[0].n
        key = ("zfe", out_slots, in_slots, conts[0].layout, off, n,
               tuple(dtype_name(c.dtype) for c in conts), _ew._op_key(fn),
               spec)

        def emit(state, svals, souts):
            _ew._zip_foreach_rows([state[s] for s in in_slots], in_wins,
                                  [state[s] for s in out_slots], out_wins,
                                  fn, svals)

        run.ops.append(_FusedOp(
            "for_each(zip)", key, emit, spec, vals, reads=in_slots,
            writes=tuple((s, off, n, False) for s in out_slots),
            pure=True, messages=True))
        self._note_replay(lambda i=ins, o=outs, f=fn, sc=tuple(scalars):
                          self.record_zip_foreach(i, o, f, sc))
        return True

    def record_reduce(self, chains, kind: str, zip_op=None) -> PlanScalar:
        """Monoid reduce of aligned chains (or the dot shape, a transform
        over a zip): the result is a scalar output of the run."""
        from ..algorithms import reduce as _red
        c0 = chains[0]
        cont = c0.cont
        chain_sc = self._subst_scalars(_ew._chain_scalars(chains))
        zsc = self._subst_scalars(zip_op.scalars) \
            if isinstance(zip_op, _v.BoundOp) else []
        all_sc = chain_sc + zsc
        run = self._fusible_run(cont, all_sc)
        slots = tuple(run.slot(c.cont) for c in chains)
        all_ops = tuple(c.ops for c in chains)
        nchain = len(chain_sc)
        spec, vals = self._scalar_spec(run, all_sc)
        layout, off, n = cont.layout, c0.off, c0.n
        k7 = _red._k7_takes(chains, kind, zip_op)
        key = ("red", slots, layout, off, n, kind,
               tuple(tuple(_ew._traced_op_key(o) for o in ops)
                     for ops in all_ops),
               _ew._traced_op_key(zip_op) if zip_op is not None else None,
               k7, spec)

        def emit(state, svals, souts):
            souts.append(_red._reduce_rows(
                [state[s] for s in slots], all_ops, layout, off, n, kind,
                zip_op, k7, svals[:nchain], svals[nchain:]))

        handle = PlanScalar(self, run, len(run.handles))
        run.handles.append(handle)
        run.ops.append(_FusedOp("reduce", key, emit, spec, vals,
                                reads=slots, messages=True))
        self._note_replay(lambda ch=chains, k=kind, z=zip_op:
                          self.record_reduce(ch, k, z), handle)
        return handle

    def record_splice(self, out_chain, values) -> bool:
        """Host array -> container window copy (the eager
        ``_write_window``); the array is an operand."""
        cont = out_chain.cont
        layout, off, n = cont.layout, out_chain.off, out_chain.n
        shp = tuple(values.shape)
        if shp != (n,):
            raise ValueError(
                f"copy: source shape {shp} does not match the "
                f"destination window ({n},)")
        run = self._fusible_run(cont, [values])
        slot = run.slot(cont)
        spec, vals = self._scalar_spec(run, [values])
        key = ("splice", slot, layout, off, n, dtype_name(cont.dtype), shp,
               spec)

        def emit(state, svals, souts):
            _ew._write_window_rows(state[slot], layout, off, n, svals[0])

        # the port's splice writes the window and nothing else (no ghost
        # zeroing, unlike the JAX package's): a window write that reads
        # nothing.  Over a whole container without a halo it is a full
        # rebuild all the same: such a row is owned cells plus pad
        # cells, and no writer leaves a pad cell other than zero
        full = off == 0 and n == len(cont) and not cont.halo_bounds.width
        run.ops.append(_FusedOp("copy(host)", key, emit, spec, vals,
                                writes=((slot, off, n, full),)))
        self._note_replay(lambda oc=out_chain, v=values:
                          self.record_splice(oc, v))
        return True

    def record_halo(self, dv, kind: str, op=None, iters: int = 1) -> bool:
        """Halo exchange / exchange_n / ghost -> owner reduce over the
        vector's rows (``parallel/halo.exchange_rows`` / ``reduce_rows``)."""
        from ..parallel import halo as _halo
        run = self._fusible_run(dv)
        slot = run.slot(dv)
        layout, periodic = dv.layout, dv.halo_bounds.periodic
        key = ("halo", kind, slot, layout, periodic, op, iters)

        def emit(state, svals, souts):
            rows = state[slot]
            devs = _row_devices(rows, dv.runtime)
            if kind == "reduce":
                _halo.reduce_rows(rows, devs, layout, periodic, op)
            else:
                for _ in range(iters):
                    _halo.exchange_rows(rows, devs, layout, periodic)

        run.ops.append(_FusedOp(f"halo.{kind}", key, emit, reads=(slot,),
                                writes=((slot, 0, len(dv), False),),
                                messages=True))
        self._note_replay(lambda d=dv, k=kind, o=op, it=iters:
                          self.record_halo(d, k, o, it))
        return True

    def record_stencil(self, in_cont, out_cont, periodic, prev, nxt,
                       key_op, body_op) -> bool:
        """One fused exchange + stencil step (``stencil._step_rows``)."""
        from ..algorithms import stencil as _st
        run = self._fusible_run(out_cont)
        si, so = run.slot(in_cont), run.slot(out_cont)
        layout = in_cont.layout
        key = ("stencil", si, so, layout, periodic, prev, nxt, key_op,
               dtype_name(out_cont.dtype))

        def emit(state, svals, souts):
            rows = state[si]
            state[so] = _st._step_rows(
                layout, _row_devices(rows, in_cont.runtime), rows,
                state[so], body_op, prev, nxt, periodic)

        run.ops.append(_FusedOp("stencil", key, emit, reads=(si, so),
                                writes=((so, 0, len(out_cont), False),),
                                messages=True))
        self._note_replay(lambda ic=in_cont, oc=out_cont, per=periodic,
                          pv=prev, nx=nxt, ko=key_op, bo=body_op:
                          self.record_stencil(ic, oc, per, pv, nx, ko, bo))
        return True

    def record_redistribute(self, cont, new_dist, rt) -> bool:
        """Collective re-layout: the container's layout metadata flips
        now (later recorded ops see the new geometry), its rows move when
        the run executes; an undo restores the metadata if the queue is
        dropped first.  Rows change shape, so the op is not graph-safe."""
        from ..parallel import pipeline as _pipe
        from ..parallel import redistribute as _rdx
        from ..parallel import runtime as _rtm
        src_rt, src_dist, src_layout = (cont.runtime, cont.distribution,
                                        cont.layout)
        cont._rebind(rt, new_dist, _rows=cont._rows)
        dst_layout = cont.layout
        run = self._fusible_run(cont)
        slot = run.slot(cont)
        dtype = cont.dtype
        moves = _rdx.plan_moves(src_layout, dst_layout)
        key = ("rdx", slot, src_layout, dst_layout, dtype_name(dtype))

        def emit(state, svals, souts):
            rows = state[slot]
            state[slot] = _rdx.exchange_rows(
                rows, _row_devices(rows, src_rt), src_layout, dst_layout,
                dtype, moves)

        def pre():
            _faults.fire("redistribute.exchange", src=str(src_layout),
                         dst=str(dst_layout))
            _pipe.fire_ppermute(what="redistribute")
            _obs.count("redistribute.bytes_moved",
                       moves[1] * dtype.itemsize)

        run.ops.append(_FusedOp(
            "redistribute", key, emit, pre=pre, reads=(slot,),
            writes=((slot, 0, len(cont), False),), graph_safe=False,
            messages=True))
        self._note_undo(lambda c=cont, r=src_rt, d=src_dist:
                        c._rebind(r, d, _rows=c._rows))
        # a replay records against the runtime current then
        self._note_replay(lambda c=cont, d=new_dist:
                          self.record_redistribute(c, d, _rtm.runtime()))
        return True

    def record_histogram(self, in_chain, out_chain, lo, hi) -> bool:
        """Fusible histogram (its output shape is the out container's):
        ``relational._histogram_rows``, with the chain's ``BoundOp``
        scalars and ``lo`` / ``hi`` as operands."""
        from ..algorithms import relational as _rel
        in_cont, out_cont = in_chain.cont, out_chain.cont
        all_sc = self._subst_scalars(_ew._chain_scalars([in_chain])
                                     + [lo, hi])
        run = self._fusible_run(out_cont, all_sc)
        si, so = run.slot(in_cont), run.slot(out_cont)
        spec, vals = self._scalar_spec(run, all_sc)
        in_layout, off, n = in_cont.layout, in_chain.off, in_chain.n
        out_layout, out_dtype = out_cont.layout, out_cont.dtype
        bins = out_chain.n
        ops = tuple(in_chain.ops)
        key = ("relhist", si, so, in_layout, off, n,
               tuple(_ew._traced_op_key(o) for o in ops),
               dtype_name(in_cont.dtype), out_layout, dtype_name(out_dtype),
               bins, spec)

        def emit(state, svals, souts):
            state[so] = _rel._histogram_rows(
                state[si], in_layout, off, n, ops, svals[:-2], out_layout,
                out_dtype, bins, svals[-2], svals[-1])

        run.ops.append(_FusedOp(
            "histogram", key, emit, spec, vals, reads=(si,),
            writes=((so, 0, bins, True),), pure=True,
            graph_safe=all(s == "t" for s in spec), messages=True))
        self._note_replay(lambda ic=in_chain, oc=out_chain, a=lo, b=hi:
                          self.record_histogram(ic, oc, a, b))
        return True

    def record_top_k(self, in_chain, ov_chain, oi_chain, largest,
                     merge) -> bool:
        """Fusible top-k (k is the out container's length):
        ``relational._top_k_rows``; under ``merge`` the out containers'
        current run state joins the candidates."""
        from ..algorithms import relational as _rel
        in_cont, ov_cont = in_chain.cont, ov_chain.cont
        oi_cont = oi_chain.cont if oi_chain is not None else None
        all_sc = self._subst_scalars(_ew._chain_scalars([in_chain]))
        run = self._fusible_run(ov_cont, all_sc)
        si, sov = run.slot(in_cont), run.slot(ov_cont)
        soi = run.slot(oi_cont) if oi_cont is not None else None
        spec, vals = self._scalar_spec(run, all_sc)
        in_layout, off, n = in_cont.layout, in_chain.off, in_chain.n
        ov_layout, ov_dtype = ov_cont.layout, ov_cont.dtype
        oi_layout = oi_cont.layout if oi_cont is not None else None
        k = ov_chain.n
        ops = tuple(in_chain.ops)
        key = ("reltopk", si, sov, soi, in_layout, off, n,
               tuple(_ew._traced_op_key(o) for o in ops),
               dtype_name(in_cont.dtype), ov_layout, dtype_name(ov_dtype),
               oi_layout, k, bool(largest), bool(merge), spec)

        def emit(state, svals, souts):
            new_v, new_i = _rel._top_k_rows(
                state[si], in_layout, off, n, ops, svals, state[sov],
                ov_layout, ov_dtype, None if soi is None else state[soi],
                oi_layout, k, largest, merge)
            state[sov] = new_v
            if soi is not None:
                state[soi] = new_i

        writes = ((sov, 0, k, True),)
        if soi is not None:
            writes += ((soi, 0, k, True),)
        reads = (si,)
        if merge:
            reads += (sov,) + ((soi,) if soi is not None else ())
        run.ops.append(_FusedOp("top_k", key, emit, spec, vals,
                                reads=reads, writes=writes, pure=True,
                                graph_safe=all(s == "t" for s in spec),
                                messages=True))
        self._note_replay(lambda ic=in_chain, vc=ov_chain, xc=oi_chain,
                          lg=largest, mg=merge:
                          self.record_top_k(ic, vc, xc, lg, mg))
        return True

    def record_opaque(self, name: str, thunk, reads=None, writes=None,
                      meta=None) -> bool:
        """Record an op that runs through its eager path at the flush (in
        record order); it closes the open run.  Omitting ``reads`` /
        ``writes`` makes it a barrier to the optimizer passes."""
        self._queue.append(_Opaque(name, thunk, reads=reads, writes=writes,
                                   meta=meta))
        self._note_replay(lambda n=name, t=thunk, r=reads, w=writes, m=meta:
                          self.record_opaque(n, t, r, w, m))
        return True

    def nonfusible(self, what: str) -> None:
        """A non-fusible op is about to run eagerly: flush what is
        pending first (order), under a reason that names it."""
        if self._queue:
            self.flush(f"non-fusible: {what}")

    # ----------------------------------------------------------- flushing
    def flush(self, reason: str = "explicit") -> None:
        """Execute the recorded queue in record order.  On an error the
        unexecuted suffix is dropped (its containers keep their values,
        pending handles break) and the error propagates."""
        if self._flushing or not self._queue:
            return
        from . import opt as _opt
        queue, self._queue = self._queue, []
        undos, self._undo = self._undo, []
        replay, self._replay = self._replay, []
        self._flushing = True
        sid = _obs.begin("plan.flush", cat="plan", reason=reason,
                         items=len(queue))
        entry = {"reason": reason, "items": []}
        self.log.append(entry)
        _plansan = None
        snap = None
        if _sanitize.installed():
            from . import plansan as _plansan
            snap = _plansan.snapshot(queue)
        exec_queue = queue
        idx = 0
        d0 = _guard.dispatch_count()
        try:
            # the sites fire before anything runs: a faulted flush
            # executes nothing
            _faults.fire("plan.flush")
            _faults.fire("sanitize.verify")
            exec_queue = _opt.optimize(self, queue, entry, parent=sid)
            if _plansan is not None:
                _plansan.check_serializable(snap, exec_queue)
            for idx, item in enumerate(exec_queue):
                self._exec_item(item, entry, sid, _plansan)
        except _resilience.DeviceLostError as de:
            # the unexecuted suffix, as recorded items: its re-layouts
            # undo first (the rescue then reads consistent containers),
            # then it is recorded again on the shrunken runtime
            suffix = _opt.expand_items(exec_queue[idx:])
            self._undo_items(undos, suffix)
            self._flushing = False
            try:
                recovered = self._elastic_recover(suffix, replay, de, entry)
            except BaseException:
                self._break_handles(queue)
                entry["error"] = True
                raise
            if not recovered:
                self._break_handles(queue)
                entry["error"] = True
                raise
        except BaseException:
            self._undo_items(undos, _opt.expand_items(exec_queue[idx:]))
            self._break_handles(queue)
            entry["error"] = True
            raise
        finally:
            entry["dispatches"] = _guard.dispatch_count() - d0
            self._flushing = False
            _obs.end(sid, dispatches=entry["dispatches"],
                     error=bool(entry.get("error")))
            if _obs.armed():
                _obs.count("plan.flushes")
                for it in entry["items"]:
                    if it["kind"] == "fused":
                        _obs.count("plan.fused_ops", len(it["ops"]))
                    else:
                        _obs.count("plan.opaque_ops")

    def _exec_item(self, item, entry, sid, _plansan) -> None:
        di = _guard.dispatch_count()
        t0 = _obs.now()
        if isinstance(item, _Opaque):
            if _plansan is not None:
                with _plansan.watch(item):
                    item.thunk()
            else:
                item.thunk()
            _obs.complete("plan.opaque", t0, cat="plan", parent=sid,
                          op=item.name)
            entry["items"].append(
                {"kind": "opaque", "name": item.name,
                 "dispatches": _guard.dispatch_count() - di})
            return
        armed = _sanitize.installed()
        # a run whose inputs are already non-finite has nothing to blame
        pre_ok = armed and all(_sanitize.is_finite(r) for c in item.conts
                               for r in c._rows if r is not None)
        if _plansan is not None:
            _plansan.verify_run(item)
        hit, route, captured = self._exec_run(item)
        _obs.complete("plan.run", t0, cat="plan", parent=sid,
                      ops=len(item.ops), cache_hit=hit, route=route)
        entry["items"].append(
            {"kind": "fused", "ops": [o.name for o in item.ops],
             "containers": len(item.conts), "cache_hit": hit,
             "route": route, "captured": captured,
             "dispatches": _guard.dispatch_count() - di})
        if pre_ok:
            ops = "+".join(o.name for o in item.ops)
            for c in item.conts:
                for r in c._rows:
                    if r is not None:
                        _sanitize.check_finite(
                            r, f"container state (fused run {ops})")
            for h in item.handles:
                if h._val is not None:
                    _sanitize.check_finite(
                        h._val, f"posted scalar (fused run {ops})")

    @staticmethod
    def _break_handles(queue) -> None:
        for item in queue:
            if isinstance(item, _Run):
                for h in item.handles:
                    if h._val is None:
                        h._broken = True
                        h._run = None

    def _elastic_recover(self, suffix, replay, err, entry) -> bool:
        """A device loss in the middle of a flush: shrink the session,
        record the unexecuted ``suffix`` again (its thunks re-read the
        rescued containers' layouts) and flush it.  Pending handles take
        their twins' values.  False when elastic is off or no rescue is
        possible: the caller then drops the queue."""
        from ..utils import elastic as _elastic
        if not (_elastic.enabled() and _elastic.try_rescue(err)):
            return False
        ids = {id(it) for it in suffix}
        links = []
        replayed = 0
        self._subst = {}
        try:
            for item, thunk, old_h in replay:
                if id(item) not in ids:
                    continue
                new = thunk()
                replayed += 1
                if old_h is not None and isinstance(new, PlanScalar):
                    self._subst[id(old_h)] = new
                    links.append((old_h, new))
        finally:
            self._subst = {}
        entry["elastic_replayed"] = replayed
        self.flush("elastic replay")
        for old_h, new_h in links:
            old_h._val = new_h._val
            old_h._run = None
            old_h._broken = new_h._val is None
        return True

    def _exec_run(self, run: _Run):
        """Execute one run: (cache hit, route, captured)."""
        for o in run.ops:
            if o.pre is not None:
                o.pre()
        key = ("plan", pinned_id(run.runtime),
               tuple((c.layout, dtype_name(c.dtype)) for c in run.conts),
               tuple(o.key for o in run.ops))
        ent = _plan_cache.get(key)
        hit = ent is not None
        if ent is None:
            ent = _plan_cache[key] = _GraphEntry()
        tail = []
        for o in run.ops:
            for v in o.vals:
                if isinstance(v, PlanScalar):
                    # a posted handle resolves through item(): its fold
                    # applies (its producer run has executed)
                    v = v.item() if v._post is not None else v._raw()
                tail.append(v)
        # decided by the recorded ops and the runtime alone: across
        # processes a run that messages another process never captures
        dev = (_graph_device(run)
               if all(o.graph_safe for o in run.ops)
               and not (run.runtime.multi_process
                        and any(o.messages for o in run.ops)) else None)
        route = "eager" if dev is None else ent.route(run, tail, dev)
        captured = route == "capture"
        if route == "eager":
            state = [list(c._rows) for c in run.conts]
            outs = _body(run.ops, state, tail)
            for c, rows in zip(run.conts, state):
                cur = c._rows
                if all(a is b for a, b in zip(rows, cur)):
                    continue
                if dev is None:
                    c._rows = rows
                    continue
                # a graph candidate keeps its containers' storage, as
                # its graph will: the next flush can then repeat the
                # signature and capture
                for a, b in zip(cur, rows):
                    if a is not b:
                        a.copy_(b)
        else:
            if captured:
                ent.capture(run, tail, dev)
            outs = ent.replay()
            route = "graph"
        # the operand values may be container-sized host arrays
        for o in run.ops:
            o.vals = []
        for h, val in zip(run.handles, outs):
            h._val = val
            h._run = None
        return hit, route, captured

    def discard(self, reason: str = "discard") -> None:
        """Drop every pending item unexecuted: handles break, recorded
        re-layouts undo their metadata flip."""
        queue, self._queue = self._queue, []
        undos, self._undo = self._undo, []
        self._replay = []
        self._undo_items(undos, queue)
        self._break_handles(queue)
        if queue:
            self.log.append({"reason": reason, "items": [],
                             "discarded": len(queue), "dispatches": 0})

    # ------------------------------------------------------ observability
    @property
    def dispatches(self) -> int:
        """Tapped dispatches across this plan's flushes."""
        return sum(e.get("dispatches", 0) for e in self.log)

    def stats(self) -> dict:
        items = [i for e in self.log for i in e.get("items", [])]
        fused = [i for i in items if i["kind"] == "fused"]
        opts = [e.get("opt") for e in self.log if e.get("opt")]
        return {
            "flushes": len(self.log),
            "fused_runs": len(fused),
            "fused_ops": sum(len(i["ops"]) for i in fused),
            "opaque_ops": sum(1 for i in items if i["kind"] == "opaque"),
            "cache_hits": sum(1 for i in fused if i["cache_hit"]),
            "dispatches": self.dispatches,
            "graph_captures": sum(1 for i in fused if i["captured"]),
            "graph_replays": sum(1 for i in fused
                                 if i["route"] == "graph"),
            "eager_runs": sum(1 for i in fused if i["route"] == "eager"),
            "opt": {
                "merged_runs": sum(o.get("merged_runs", 0) for o in opts),
                "dce_ops": sum(o.get("dce_ops", 0) for o in opts),
                "pushdowns": sum(o.get("pushdowns", 0) for o in opts),
            },
        }

    def explain(self) -> str:
        """Plan report: runs, flush reasons, routes and dispatch counts."""
        s = self.stats()
        lines = [
            f"plan: {s['flushes']} flush(es), {s['fused_runs']} fused "
            f"run(s) over {s['fused_ops']} op(s), {s['opaque_ops']} "
            f"opaque op(s), {s['dispatches']} dispatch(es), "
            f"{s['cache_hits']} program-cache hit(s), "
            f"{s['graph_replays']} graph replay(s) "
            f"({s['graph_captures']} capture(s)), {s['eager_runs']} "
            "in-order run(s)"]
        for e in self.log:
            tag = " [ERROR]" if e.get("error") else ""
            lines.append(f"  flush ({e['reason']}){tag}: "
                         f"{e.get('dispatches', 0)} dispatch(es)")
            o = e.get("opt")
            if o:
                lines.append(
                    f"    opt [{'+'.join(o.get('passes', ()))}]: "
                    f"{o.get('merged_runs', 0)} run(s) merged, "
                    f"{o.get('dce_ops', 0)} dead op(s) eliminated, "
                    f"{o.get('pushdowns', 0)} pushdown(s)")
            for it in e.get("items", []):
                if it["kind"] == "fused":
                    lines.append(
                        f"    fused run [{len(it['ops'])} ops, "
                        f"{it['containers']} container(s), "
                        f"{'hit' if it['cache_hit'] else 'compile'}, "
                        f"{it['route']}]: " + " -> ".join(it["ops"]))
                else:
                    lines.append(
                        f"    opaque {it['name']} "
                        f"({it['dispatches']} dispatch(es))")
            if e.get("discarded"):
                lines.append(
                    f"    discarded {e['discarded']} pending item(s)")
        return "\n".join(lines)


@contextmanager
def deferred():
    """Deferred-execution region: aligned algorithm calls record into a
    :class:`Plan` and run at region exit or at a flush point.  Nesting
    re-enters the active plan (per thread).  Yields the plan.  In a
    multi-process runtime every process enters the same region and
    records the same calls (see the module docstring)."""
    p = _get_active()
    if p is not None:
        yield p
        return
    p = Plan()
    with p.record():
        yield p
    # the outermost region's clean exit, after its flush, is the moment
    # between flushes where re-admitting a recovered rank is safe
    from ..utils import elastic as _elastic
    _elastic.maybe_grow()
