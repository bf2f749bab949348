"""Plan optimizer: the pass pipeline run over a recorded queue at each
flush (counterpart of ``dr_tpu/plan/opt.py``).

The recorded queue is a logical plan: ops land in record order, and runs
split wherever an opaque op or a runtime change interrupts them.  This
module rewrites it just before execution:

* **merge**: fusible runs over one runtime that were split only by
  record order (an opaque op or another runtime's run between them)
  coalesce into one run.  A run moves earlier only past items whose
  declared footprints are disjoint from every container it touches, and
  never past the producer of a scalar operand it consumes.
* **dce**: a pure op whose written window is fully overwritten before
  any read (a backward interval-coverage walk; a full-row victim needs a
  full-row killer) is dropped; a run left empty disappears.
* **pushdown**: a single-input same-dtype projection whose output feeds
  only a relational op and dies afterwards is re-homed into that op's
  scratch copy (a view-chain ``BoundOp``), and the dce pass then drops
  the intermediate write.
* **capinfer** / **joinroute**: config-level passes consulted at op
  execution; they register here so one knob family covers them.
  ``capinfer`` lets the auto relational tier size its outputs from a
  ``relational.cap_ratio_<kind>`` hint and skip its count probe;
  ``joinroute`` lets the join read its route threshold,
  ``join.broadcast_max``, from the tuning DB
  (``algorithms/relational.py``, ``dr_tpu_torch/tuning.py``).

Every rewrite keeps the exact value of every observable: container
contents, resolved scalars, relational counts.  A merged run executes
the same ops in the same relative order as the split runs.
``DR_GPU_PLAN_OPT=0`` turns the pipeline off, ``auto`` (the default)
runs the rewrites that never add work, ``all`` adds pushdown and
capinfer; a pass named in ``DR_GPU_PLAN_OPT_DISABLE`` (csv) is skipped.

A pass that raises takes the flush down with the error: the flush drops
the whole queue (nothing has run yet) and the error propagates.  The
port runs no unoptimized queue in its place.
"""

from __future__ import annotations

from typing import List

from . import _FusedOp, _Opaque, _Run
from . import interference as _interf
from .. import obs as _obs
from ..utils.env import env_str

__all__ = ["optimize", "expand_items", "enabled", "mode", "PASSES",
           "PASS_NAMES"]

#: passes the default ``auto`` mode leaves OFF: they spend extra work
#: (probe dispatches, view rewrites) that only pays on relational
#: pipelines — ``all`` arms them
_AUTO_OFF = frozenset(("pushdown", "capinfer"))


def mode() -> str:
    """``DR_GPU_PLAN_OPT``: ``0`` / ``off`` disables every pass, ``all``
    arms every pass, anything else (default) is ``auto``."""
    raw = env_str("DR_GPU_PLAN_OPT", "auto").lower()
    if raw in ("0", "off", "none"):
        return "0"
    if raw == "all":
        return "all"
    return "auto"


def _disabled() -> set:
    return {s.strip().lower()
            for s in env_str("DR_GPU_PLAN_OPT_DISABLE").split(",")
            if s.strip()}


def enabled(name: str) -> bool:
    """Is pass ``name`` armed under the current mode + per-pass
    opt-outs?  The config-level passes (capinfer, joinroute) call this
    at op-execution time, so a sweep can flip them per call."""
    m = mode()
    if m == "0" or name in _disabled():
        return False
    if m == "auto" and name in _AUTO_OFF:
        return False
    return True


def expand_items(items) -> list:
    """Optimized queue items back to the RECORDED items they execute
    (merged/cloned runs carry ``_sources``) — the identity set the
    undo/replay/faulted-flush contracts are keyed on."""
    out = []
    for it in items:
        src = getattr(it, "_sources", None)
        if src is None:
            out.append(it)
        else:
            out.extend(expand_items(src))
    return out


# ---------------------------------------------------------------------------
# footprints: every aliasing and ordering query routes through
# plan/interference.py; a pass does not interpret footprints itself
# ---------------------------------------------------------------------------

class _Group:
    """A merge group under construction: runs in record order, merged
    into one program at materialization."""

    __slots__ = ("runs", "touch")

    def __init__(self, run):
        self.runs = [run]
        self.touch = {id(c) for c in run.conts}

    def add(self, run):
        self.runs.append(run)
        self.touch.update(id(c) for c in run.conts)


class _SubState:
    """List proxy translating a source run's slot numbering into the
    merged run's combined state list."""

    __slots__ = ("_s", "_m")

    def __init__(self, state, smap):
        self._s = state
        self._m = smap

    def __getitem__(self, i):
        return self._s[self._m[i]]

    def __setitem__(self, i, v):
        self._s[self._m[i]] = v


def _wrap(o: _FusedOp, smap, soff, wrapped) -> _FusedOp:
    """Re-slot one source op into the merged run: slots map through
    ``smap``, same-run scalar refs shift by ``soff`` (the merged souts
    list concatenates the sources' in order)."""
    spec2 = tuple(("r", s[1] + soff) if isinstance(s, tuple) else s
                  for s in o.spec)

    def emit(state, svals, souts, _o=o, _m=smap):
        _o.emit(_SubState(state, _m), svals, souts)

    reads2, writes2 = _interf.remap(o, smap)
    w = _FusedOp(o.name, ("mrg", o.key, smap, soff), emit, spec2,
                 o.vals, pre=o.pre, reads=reads2, writes=writes2,
                 pure=o.pure, graph_safe=o.graph_safe)
    # the wrapper runs the source op's emit; the plansan oracle maps
    # executed ops back to recorded ones through src
    w.src = o
    # the wrapper copied the operand values: the source op's copy is
    # dropped once every pass has run
    wrapped.append(o)
    return w


def _materialize(group: _Group) -> _Run:
    if len(group.runs) == 1:
        return group.runs[0]
    first = group.runs[0]
    m = _Run(first.runtime)
    m._sources = list(group.runs)
    m._wrapped = wrapped = []
    for r in group.runs:
        smap = tuple(m.slot(c) for c in r.conts)
        soff = len(m.handles)
        m.handles.extend(r.handles)
        identity = soff == 0 and smap == tuple(range(len(r.conts)))
        for o in r.ops:
            m.ops.append(o if identity
                         else _wrap(o, smap, soff, wrapped))
    return m


def _pass_merge(q):
    """Coalesce independent same-runtime fusible runs."""
    out: List = []
    merged = 0
    for item in q:
        if not (isinstance(item, _Run) and item.ops):
            out.append(item)
            continue
        touch = {id(c) for c in item.conts}
        # producers of scalar operands this run fetches at dispatch:
        # it must execute AFTER them, so it cannot move past one
        pending = _interf.scalar_producers(item)
        target = None
        for j in range(len(out) - 1, -1, -1):
            prev = out[j]
            if isinstance(prev, _Group):
                runs, ptouch = prev.runs, prev.touch
            elif isinstance(prev, _Run):
                runs, ptouch = [prev], _interf.item_touch(prev)
            else:
                runs, ptouch = None, _interf.item_touch(prev)
            if runs is not None and runs[0].runtime is item.runtime:
                if any(id(r) in pending for r in runs):
                    break  # scalar-dependent on the candidate itself
                target = j
                break
            # a middle item: this run may only move past it when their
            # footprints are disjoint and no scalar dependency exists
            if ptouch is None or (touch & ptouch):
                break
            if runs is not None and any(id(r) in pending for r in runs):
                break
        if target is None:
            out.append(item)
            continue
        prev = out[target]
        if isinstance(prev, _Group):
            prev.add(item)
        else:
            out[target] = g = _Group(prev)
            g.add(item)
        merged += 1
    final = [(_materialize(x) if isinstance(x, _Group) else x)
             for x in out]
    return final, merged


# ---------------------------------------------------------------------------
# dead-op elimination
# ---------------------------------------------------------------------------

def _clone_run(run: _Run, ops) -> _Run:
    nr = _Run(run.runtime)
    nr.conts = run.conts          # slot numbering stays valid
    nr._cont_ids = run._cont_ids
    nr.handles = run.handles
    nr.ops = ops
    nr._sources = [run]
    return nr


def _pass_dce(q):
    """Backward coverage walk: a pure op whose written windows are all
    overwritten before any read dies; reads reset coverage; a kept
    op's write window extends coverage only when the op does not read
    that container (the mask-preserve argument).  A full-row
    victim (ghost-zeroing relational outputs) retires only under a
    full-row killer."""
    out_rev: List = []
    removed = 0
    cov = _interf.Coverage()
    for item in reversed(q):
        if isinstance(item, _Opaque):
            cov.visit_opaque(item)
            out_rev.append(item)
            continue
        kept = []
        changed = False
        for o in reversed(item.ops):
            if cov.op_dead(item, o):
                removed += 1
                changed = True
                continue
            cov.visit_op(item, o)
            kept.append(o)
        if not changed:
            out_rev.append(item)
        elif kept or item.handles:
            out_rev.append(_clone_run(item, list(reversed(kept))))
        # else: every op died and no handles — the run disappears
    return list(reversed(out_rev)), removed


# ---------------------------------------------------------------------------
# projection pushdown into the relational scratch-sort copy
# ---------------------------------------------------------------------------

def _pushdown_one(q, item, name, chain):
    """Try to push the producer of input channel ``name`` (a plain
    whole/sub-range over ``cont``) into the relational scratch copy.
    Returns True when the rewrite landed."""
    from ..views import views as _v
    cont, off, n, plain = chain
    if not plain or n <= 0:
        return False
    ev = _interf.events(q)
    qi = q.index(item)
    own = [i for i, e in enumerate(ev) if e[2] == qi]
    if not own:
        return False
    e0, e1 = min(own), max(own) + 1
    # --- backward: the LAST touch of cont before the opaque must be a
    # pushable transform covering the read window
    T = None
    t_pos = None
    for i in range(e0 - 1, -1, -1):
        kind, cid, _qj, o, _full = ev[i]
        if kind == "barrier":
            return False
        if cid != id(cont):
            continue
        if kind == "w" and o is not None and o.push is not None:
            a, t_off, t_n, _op, _sc = o.push
            if t_off <= off and t_off + t_n >= off + n \
                    and a is not cont:
                T, t_pos = o, i
        break
    if T is None:
        return False
    a, t_off, t_n, op, scalars = T.push
    # --- the transform's input must be write-free between T and the
    # opaque (its value at the opaque's flush position must equal its
    # value where T would have run), and nothing else may touch the
    # intermediate in between
    for i in range(t_pos + 1, e0):
        kind, cid, _qj, _o, _full = ev[i]
        if kind == "barrier":
            return False
        if cid == id(a) and kind == "w":
            return False
        if cid == id(cont):
            return False
    # --- forward deadness: cont must be fully overwritten (no read
    # first) after the opaque, else eliminating T would be observable
    dead = False
    for i in range(e1, len(ev)):
        kind, cid, _qj, _o, full = ev[i]
        if kind == "barrier":
            return False
        if cid != id(cont):
            continue
        if kind == "w" and full:
            dead = True
            break
        return False
    if not dead:
        return False  # never overwritten: observable at flush end
    # --- rewrite: the relational input becomes a view chain over the
    # transform's input; the scratch copy fuses the op (one cast on
    # both paths, the same bits)
    base = a if (off == 0 and n == len(a)) \
        else _v.subrange(a, off, off + n)
    item.meta["inputs"][name] = _v.transform(base, op, *scalars)
    item.meta["chains"][name] = (a, off, n, False)
    reads = []
    for _cname, ch in item.meta["chains"].items():
        if ch[0] not in reads:
            reads.append(ch[0])
    item.reads = tuple(reads)
    return True


def _pass_pushdown(q):
    pushes = 0
    for item in q:
        if not (isinstance(item, _Opaque) and isinstance(item.meta,
                                                        dict)):
            continue
        chains = item.meta.get("chains")
        if not chains:
            continue
        for name in list(chains):
            if _pushdown_one(q, item, name, chains[name]):
                pushes += 1
    return q, pushes


# ---------------------------------------------------------------------------
# the pass pipeline
# ---------------------------------------------------------------------------

#: the pass registry: queue-rewrite passes carry their implementation;
#: config-level passes (consulted at op execution through
#: :func:`enabled`) register with None
PASSES = (
    ("pushdown", _pass_pushdown),
    ("dce", _pass_dce),
    ("merge", _pass_merge),
    ("capinfer", None),
    ("joinroute", None),
)

PASS_NAMES = tuple(n for n, _fn in PASSES)


def optimize(plan, queue, entry, parent=0):
    """Run the armed passes over ``queue``; returns the queue to
    execute.  Records the flush's optimizer note in ``entry`` and an obs
    span under the flush."""
    if not queue or mode() == "0":
        return queue
    note = {"passes": [], "merged_runs": 0, "dce_ops": 0,
            "pushdowns": 0}
    q = list(queue)
    t0 = _obs.now()
    for pname, fn in PASSES:
        if fn is None or not enabled(pname):
            continue
        tp = _obs.now()
        q, nhits = fn(q)
        # one span per pass under the flush
        _obs.complete(f"plan.opt.{pname}", tp, cat="plan",
                      parent=parent, hits=nhits)
        note["passes"].append(pname)
        if pname == "merge":
            note["merged_runs"] = nhits
        elif pname == "dce":
            note["dce_ops"] = nhits
        elif pname == "pushdown":
            note["pushdowns"] = nhits
    # the cached entries must not pin the wrapped source ops' operand
    # copies (a host splice array can be container-sized)
    for item in q:
        for o in getattr(item, "_wrapped", ()):
            o.vals = []
    for pname in ("capinfer", "joinroute"):
        if enabled(pname):
            note["passes"].append(pname)
    if note["passes"]:
        entry["opt"] = note
    _obs.complete("plan.opt", t0, cat="plan", parent=parent,
                  passes="+".join(note["passes"]),
                  merged_runs=note["merged_runs"],
                  dce_ops=note["dce_ops"],
                  pushdowns=note["pushdowns"])
    if _obs.armed():
        _obs.count("plan.opt.merged_runs", note["merged_runs"])
        _obs.count("plan.opt.dce_ops", note["dce_ops"])
        _obs.count("plan.opt.pushdowns", note["pushdowns"])
    return q
