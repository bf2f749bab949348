"""plansan: the footprint-soundness runtime verifier (counterpart of
``dr_tpu/plan/plansan.py``).

The optimizer passes and the ``flush_reads`` skip trust the read/write
footprints recorded plan items declare; an under-declared footprint is a
silent miscompile.  Armed under ``DR_GPU_SANITIZE=1``:

* **Shadow verifier.**  Each fused run about to execute is replayed
  abstractly: the same emit closures run over rows on ``device="meta"``
  (shapes and dtypes, no data; in a multi-process runtime every rank's,
  under ``runtime.single_controller_view``, so the replay messages no
  other process) through a slot-tracking state proxy, and
  every slot an op reads (a state lookup) or writes (a replaced row list
  or an in-place write, seen on the tensors' version counters) is held
  against its declared footprint.  (The JAX package replays through
  ``jax.eval_shape``.)  An opaque thunk runs under the container-access
  watcher (``utils/sanitize.watch_containers``).  Violations raise
  :class:`FootprintViolation` with the trace-tail postmortem.
* **Conflict-serializability oracle.**  :func:`snapshot` captures the
  dependency structure of the recorded queue before the passes run;
  :func:`check_serializable` proves the executed queue keeps every
  read-write / write-read / write-write dependency among the surviving
  ops, every pending-scalar producer edge and every barrier ordering.

All footprint interpretation routes through ``plan/interference.py``.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List

import torch

from . import PlanScalar, _Run
from . import interference as _interf
from ..core.pinning import pinned_id
from ..parallel import runtime as _rt
from ..parallel.collectives import present
from ..utils import sanitize as _sanitize
from ..utils.resilience import _obs_tail
from ..utils.spmd_guard import dtype_name

__all__ = ["FAMILIES", "FAMILY_NAMES", "FootprintViolation",
           "SerializationViolation", "verify_run", "watch",
           "snapshot", "check_serializable"]


#: The op families whose record sites declare footprints: one name per
#: ``Plan.record_*`` method (tests/test_torch_plansan.py sweeps them).
FAMILIES = (
    ("generator", "record_generator"),
    ("transform", "record_transform"),
    ("zip_foreach", "record_zip_foreach"),
    ("reduce", "record_reduce"),
    ("splice", "record_splice"),
    ("halo", "record_halo"),
    ("stencil", "record_stencil"),
    ("redistribute", "record_redistribute"),
    ("histogram", "record_histogram"),
    ("top_k", "record_top_k"),
    ("opaque", "record_opaque"),
)

FAMILY_NAMES = tuple(n for n, _m in FAMILIES)


class FootprintViolation(_sanitize.SanitizeError):
    """A recorded item touched state outside its declared footprint:
    the under-declaration every optimizer pass would miscompile on.
    Carries the trace-tail postmortem like every classified error."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.trace_tail = _obs_tail()


class SerializationViolation(_sanitize.SanitizeError):
    """The optimized queue broke a dependency of the recorded order: a
    pass reordered conflicting work."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.trace_tail = _obs_tail()


# ---------------------------------------------------------------------------
# shadow verifier: fused runs
# ---------------------------------------------------------------------------

class _Tracker:
    """State proxy for the abstract replay: records which run slot each
    op looks up (a read) or replaces (a write), attributed to the op
    index in ``cur``; in-place writes are read off the rows' version
    counters by :func:`_replay`.  The merge pass's ``_SubState``
    wrappers compose through it."""

    __slots__ = ("_v", "_obs", "cur")

    def __init__(self, vals, obs):
        self._v = list(vals)
        self._obs = obs
        self.cur = 0

    def __getitem__(self, i):
        self._obs[self.cur][0].add(i)
        return self._v[i]

    def __setitem__(self, i, v):
        self._obs[self.cur][1].add(i)
        self._v[i] = v


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _abstract(v):
    """The stand-in of one operand in the abstract replay."""
    if isinstance(v, PlanScalar):
        if v._val is not None and v._post is None:
            return _meta(v._val)
        # pending (resolves at the flush) or posted (item(): a host float)
        return torch.empty((), dtype=torch.float32, device="meta")
    if isinstance(v, torch.Tensor):
        return _meta(v)
    return v


def _replay(run) -> List[tuple]:
    """Run the run's emits over meta rows and observe each op's slot
    access: a lookup is a read, a replaced row list or a row whose
    version counter moved is a write."""
    ops = tuple(run.ops)
    observed = [(set(), set()) for _ in ops]
    tail = []
    for o in ops:
        nt = sum(1 for s in o.spec if not isinstance(s, tuple))
        if nt != len(o.vals):
            raise _sanitize.SanitizeError(
                f"plansan: run {'+'.join(x.name for x in ops)} lost its "
                "operand values before it was verified")
        tail.extend(_abstract(v) for v in o.vals)
    # a rank another process owns (a None row) gets the shape of a row
    # this process holds: a container's rows all have one shape
    st = _Tracker([[_meta(r if r is not None else present(c._rows))
                    for r in c._rows] for c in run.conts], observed)
    tail = iter(tail)
    souts: list = []
    with _rt.single_controller_view():
        _replay_ops(ops, st, tail, souts, observed)
    return observed


def _replay_ops(ops, st, tail, souts, observed) -> None:
    for k, o in enumerate(ops):
        st.cur = k
        svals = [souts[s[1]] if isinstance(s, tuple) else next(tail)
                 for s in o.spec]
        rows0 = [list(rows) for rows in st._v]
        vers0 = [[r._version for r in rows] for rows in rows0]
        try:
            o.emit(st, svals, souts)
        except Exception as e:
            raise _sanitize.SanitizeError(
                f"plansan: the shadow replay of plan op {o.name!r} "
                f"failed ({e!r})") from e
        for i, (rows, vers) in enumerate(zip(rows0, vers0)):
            if any(r._version != v for r, v in zip(rows, vers)):
                observed[k][1].add(i)


#: program+footprint keys that already verified clean; successes only,
#: so a re-declared footprint (the mutation battery) re-verifies the
#: same emitted program instead of riding a stale pass.
_verified: set = set()
_VERIFIED_CAP = 1024


def _verify_key(run) -> tuple:
    return ("plansan", pinned_id(run.runtime),
            tuple((c.layout, dtype_name(c.dtype)) for c in run.conts),
            tuple(o.key for o in run.ops),
            tuple(_interf.op_footprint_key(o) for o in run.ops))


def verify_run(run) -> None:
    """Shadow-verify one fused run just before it executes: every slot
    an op's emit touches must sit inside its declared footprint.  Reads
    of a declared-write slot are allowed (a window write looks the rows
    up to write into them).  Window extents are not checked (slot
    granularity)."""
    key = _verify_key(run)
    if key in _verified:
        return
    observed = _replay(run)
    for o, (rds, wts) in zip(run.ops, observed):
        allowed_w = _interf.op_write_slots(o)
        allowed_r = _interf.op_read_slots(o) | allowed_w
        bad_r = sorted(rds - allowed_r)
        bad_w = sorted(wts - allowed_w)
        if bad_r or bad_w:
            def name(s):
                c = run.conts[s]
                return f"slot {s} ({type(c).__name__}[{len(c)}])"
            what = "; ".join(
                [f"READ of {name(s)}" for s in bad_r]
                + [f"WRITE of {name(s)}" for s in bad_w])
            raise FootprintViolation(
                f"plan op {o.name!r} touched state outside its "
                f"declared footprint: {what} (declared reads="
                f"{tuple(_interf.op_reads(o))}, writes="
                f"{tuple(_interf.op_writes(o))}); an under-declared "
                "footprint miscompiles under every optimizer pass: fix "
                "the record site")
    if len(_verified) >= _VERIFIED_CAP:
        _verified.clear()
    _verified.add(key)


# ---------------------------------------------------------------------------
# shadow verifier: opaque thunks
# ---------------------------------------------------------------------------

@contextmanager
def watch(item):
    """Observe container access while an opaque item's thunk runs:
    every instrumented container the thunk reads must be a declared
    read (or declared write — read-modify-write), every rebind a
    declared write.  Containers BORN inside the thunk (relational
    scratch, elastic rescues) are exempt.  A declared barrier
    (``None`` footprint) is exempt entirely — it already pays the
    worst case in every pass.  Violations collect during the thunk
    and raise AFTER it completes, so the watcher never truncates the
    eager path mid-write."""
    reads = _interf.opaque_reads(item)
    writes = _interf.opaque_writes(item)
    if reads is None or writes is None:
        yield
        return
    allowed_w = {id(c) for c, _full in writes}
    allowed_r = {id(c) for c in reads} | allowed_w
    exempt: set = set()
    bad: list = []

    def on_access(kind, cont):
        cid = id(cont)
        if cid in exempt:
            return
        ok = allowed_r if kind == "r" else allowed_w
        if cid not in ok:
            exempt.add(cid)   # report each container once
            bad.append(("READ" if kind == "r" else "WRITE", cont))

    def on_born(cont):
        exempt.add(id(cont))

    with _sanitize.watch_containers(on_access, on_born):
        yield
    if bad:
        what = "; ".join(f"{k} of {type(c).__name__}[{len(c)}]"
                         for k, c in bad)
        raise FootprintViolation(
            f"opaque op {item.name!r} touched containers outside its "
            f"declared footprint: {what} — declare the container at "
            "the record site, or record the op as a barrier "
            "(reads=None/writes=None) and pay the worst case")


# ---------------------------------------------------------------------------
# conflict-serializability oracle
# ---------------------------------------------------------------------------

class _Node:
    """One recorded unit of work at op granularity: a fused op or a
    whole opaque item, with its footprint resolved to container ids at
    snapshot time."""

    __slots__ = ("ident", "name", "rd", "wr", "barrier",
                 "run_id", "needs")

    def __init__(self, ident, name, rd, wr, barrier, run_id,
                 needs):
        self.ident = ident
        self.name = name
        self.rd = rd
        self.wr = wr
        self.barrier = barrier
        self.run_id = run_id
        self.needs = needs


def snapshot(queue) -> List[_Node]:
    """Capture the recorded queue's dependency structure BEFORE the
    optimizer runs — the pushdown pass rewrites opaque footprints in
    place, so the oracle must pin the original declarations now."""
    nodes: List[_Node] = []
    for item in queue:
        if isinstance(item, _Run):
            rid = id(item)
            for o in item.ops:
                nodes.append(_Node(
                    o, o.name,
                    frozenset(id(item.conts[s])
                              for s in _interf.op_read_slots(o)),
                    frozenset(id(item.conts[s])
                              for s in _interf.op_write_slots(o)),
                    False, rid,
                    frozenset(_interf.op_scalar_producers(o))))
            continue
        if _interf.opaque_is_barrier(item):
            nodes.append(_Node(item, item.name, frozenset(),
                               frozenset(), True, None, frozenset()))
            continue
        w = frozenset(id(c) for c, _full
                      in _interf.opaque_writes(item))
        r = frozenset(id(c) for c in _interf.opaque_reads(item)) | w
        nodes.append(_Node(item, item.name, r, w, False, None,
                           frozenset()))
    return nodes


def _conflict(a: _Node, b: _Node) -> bool:
    if a.barrier or b.barrier:
        return True
    return bool((a.wr & b.rd) or (a.rd & b.wr) or (a.wr & b.wr))


def check_serializable(nodes: List[_Node], exec_queue) -> None:
    """Prove the executed queue is a conflict-preserving reordering of
    the recorded one: every RW/WR/WW-conflicting recorded pair that
    SURVIVES the passes keeps its record order, every surviving op
    still follows its pending-scalar producers, and barriers order
    against everything.  Dropped ops are unconstrained (the dce pass
    is validated by bit-identity, not ordering)."""
    pos: dict = {}
    counter = 0
    for item in exec_queue:
        if isinstance(item, _Run):
            for o in item.ops:
                src = o
                while src.src is not None:
                    src = src.src
                pos[id(src)] = counter
                counter += 1
        else:
            pos[id(item)] = counter
            counter += 1

    alive = [(i, n, pos.get(id(n.ident))) for i, n in enumerate(nodes)]
    alive = [(i, n, p) for i, n, p in alive if p is not None]
    for x in range(len(alive)):
        i, a, pa = alive[x]
        for y in range(x + 1, len(alive)):
            j, b, pb = alive[y]
            scalar_edge = a.run_id is not None and a.run_id in b.needs
            if not scalar_edge and not _conflict(a, b):
                continue
            if pa < pb:
                continue
            why = ("pending-scalar producer" if scalar_edge
                   else "barrier" if (a.barrier or b.barrier)
                   else "data")
            raise SerializationViolation(
                f"optimized flush broke a {why} dependency: recorded "
                f"op {j} ({b.name!r}) executes at position {pb}, "
                f"before recorded op {i} ({a.name!r}) at {pa}: an "
                "optimizer pass reordered conflicting work (the "
                "conflict-serializability oracle)")
