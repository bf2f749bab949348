"""In-process span and event recorder, the tracing half of
``dr_tpu_torch.obs`` (counterpart of ``dr_tpu/obs/recorder.py``).

One bounded ring of trace events (a ``collections.deque`` whose
``maxlen`` is read from ``DR_GPU_TRACE_BUF`` each time :func:`arm` runs,
floor 16), ``time.perf_counter_ns`` for every timestamp, and thread-aware
nesting: each thread keeps its own span stack (the implicit parent),
while a span that another thread closes uses an explicit id
(:func:`begin` / :func:`end`, ``parent=``) and Chrome flow events
(:func:`flow`).

Overhead: with tracing off (the default) every entry point is one check
of the module guard ``_armed`` and allocates nothing: :func:`span`
returns a shared null context manager, :func:`begin` returns 0 and
:func:`event` / :func:`complete` / :func:`end` return at once.
:func:`events_recorded` counts every event ever recorded and must not
move while tracing is off.

Clock: timestamps are the host's.  A span adds no
``torch.cuda.synchronize`` of its own, so on the card a span around an
op that does not wait for the device measures when the op was queued,
not how long it ran; device time comes from ``utils/profiling``.

Arming: :func:`install` (run when ``dr_tpu_torch`` is imported) arms
when ``DR_GPU_TRACE=1`` and registers the Chrome-trace export into
``DR_GPU_TRACE_DIR`` at process exit; :func:`arm` is the switch in code.

The hooks ``_on_dispatch``, ``_on_compile``, ``_on_site`` and
``_on_fault`` are the JAX package's; they wait for the port's
``spmd_guard`` and ``faults`` modules, and :func:`arm` installs nothing
until those exist.
"""

from __future__ import annotations

import atexit
import sys
import threading
import time
from collections import deque
from itertools import islice
from typing import List, Optional

from ..utils.env import env_flag, env_int

__all__ = ["armed", "arm", "install", "span", "begin", "end", "complete",
           "event", "flow", "now", "current", "tail", "events", "size",
           "events_recorded", "reset", "thread_names"]

#: the module guard: every entry point checks it first
_armed = False
_installed = False

_lock = threading.Lock()
#: the bounded event ring; maxlen re-read from DR_GPU_TRACE_BUF at arm()
_ring: deque = deque(maxlen=65536)
#: count of events ever recorded (the ring may have dropped some)
_recorded = 0
_next_id = 1
#: open cross-thread spans: id -> (name, cat, tid, t0_ns, parent, attrs)
_open: dict = {}
#: tid -> thread name, for the exporter's metadata events
_tid_names: dict = {}

_tls = threading.local()


def armed() -> bool:
    return _armed


def now() -> int:
    """Recorder clock (perf_counter ns) when armed, else 0: callers keep
    it to record a :func:`complete` span afterwards."""
    return time.perf_counter_ns() if _armed else 0


def events_recorded() -> int:
    """Count of trace events recorded in this process; it does not move
    while tracing is off."""
    return _recorded


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current() -> int:
    """Span id at the top of this thread's span stack (0 = none)."""
    st = getattr(_tls, "stack", None)
    return st[-1][0] if st else 0


def _alloc_id() -> int:
    global _next_id
    with _lock:
        sid = _next_id
        _next_id += 1
    return sid


def _tid() -> int:
    t = threading.get_ident()
    if t not in _tid_names:
        _tid_names[t] = threading.current_thread().name
    return t


def _record(ev: dict) -> None:
    # the one way onto the ring: a span begun while armed whose end lands
    # after a disarm must not move the counter or the ring
    if not _armed:
        return
    global _recorded
    with _lock:
        _recorded += 1
        _ring.append(ev)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared no-op context manager handed out while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


class Span:
    """An armed context-manager span: nested through the thread's stack,
    recorded as one complete ("X") event on exit.  ``set(**attrs)`` adds
    attributes before the record."""

    __slots__ = ("name", "cat", "attrs", "sid", "parent", "t0")

    def __init__(self, name: str, cat: str, parent: int, attrs: dict):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.parent = parent
        self.sid = _alloc_id()
        self.t0 = 0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        if self.parent == 0:
            self.parent = current()
        _stack().append((self.sid, self))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, etype, evalue, tb) -> bool:
        t1 = time.perf_counter_ns()
        st = _stack()
        if st and st[-1][0] == self.sid:
            st.pop()
        if etype is not None:
            self.attrs.setdefault("error", etype.__name__)
        if self.parent:
            self.attrs.setdefault("parent", self.parent)
        _record({"ph": "X", "name": self.name, "cat": self.cat,
                 "id": self.sid, "tid": _tid(),
                 "ts": self.t0 // 1000, "dur": (t1 - self.t0) // 1000,
                 "args": self.attrs})
        return False


def span(name: str, cat: str = "", parent: int = 0, **attrs):
    """Context-manager span; the shared no-op when tracing is off.
    ``parent=0`` nests under this thread's current span."""
    if not _armed:
        return _NULL
    return Span(name, cat, parent, attrs)


def begin(name: str, cat: str = "", parent: int = 0, **attrs) -> int:
    """Open a span that any thread may close with :func:`end`; returns
    its id (0 when off).  It does not join the caller's span stack."""
    if not _armed:
        return 0
    sid = _alloc_id()
    with _lock:
        _open[sid] = (name, cat, _tid(), time.perf_counter_ns(),
                      parent or current(), attrs)
    return sid


def end(sid: int, **attrs) -> None:
    """Close a :func:`begin` span (a no-op for id 0 and unknown ids: a
    span begun before a disarm, or ended twice, must not raise)."""
    if sid == 0:
        return
    with _lock:
        entry = _open.pop(sid, None)
    if entry is None:
        return
    name, cat, tid, t0, parent, a = entry
    a.update(attrs)
    if parent:
        a.setdefault("parent", parent)
    t1 = time.perf_counter_ns()
    _record({"ph": "X", "name": name, "cat": cat, "id": sid, "tid": tid,
             "ts": t0 // 1000, "dur": (t1 - t0) // 1000, "args": a})


def complete(name: str, t0_ns: int, cat: str = "", parent: int = 0,
             t1_ns: Optional[int] = None, **attrs) -> None:
    """Record a span that already ended, from a :func:`now` timestamp.
    A no-op when off or when ``t0_ns`` is 0 (what :func:`now` returns
    while disarmed)."""
    if not _armed or not t0_ns:
        return
    if parent:
        attrs.setdefault("parent", parent)
    t1 = t1_ns if t1_ns is not None else time.perf_counter_ns()
    _record({"ph": "X", "name": name, "cat": cat, "id": _alloc_id(),
             "tid": _tid(), "ts": t0_ns // 1000,
             "dur": max(0, (t1 - t0_ns) // 1000), "args": attrs})


def event(name: str, cat: str = "", **attrs) -> None:
    """Instant event (Chrome "i" phase)."""
    if not _armed:
        return
    _record({"ph": "i", "name": name, "cat": cat, "tid": _tid(),
             "ts": time.perf_counter_ns() // 1000, "s": "t",
             "args": attrs})


def flow(fid: int, phase: str, name: str = "serve.request") -> None:
    """Chrome flow event ("s" start, "t" step, "f" finish) binding two
    slices; ``fid`` is the linking id (the source span's id)."""
    if not _armed or fid == 0 or phase not in ("s", "t", "f"):
        return
    ev = {"ph": phase, "name": name, "cat": "flow", "id": fid,
          "tid": _tid(), "ts": time.perf_counter_ns() // 1000}
    if phase == "f":
        ev["bp"] = "e"  # bind to the enclosing slice
    _record(ev)


# ---------------------------------------------------------------------------
# inspection
# ---------------------------------------------------------------------------

def events() -> List[dict]:
    """Shallow copy of the ring's current contents."""
    with _lock:
        return list(_ring)


def size() -> int:
    """Current ring occupancy, without a copy."""
    with _lock:
        return len(_ring)


def tail(n: Optional[int] = None) -> List[dict]:
    """The last ``n`` recorded events (default ``DR_GPU_TRACE_TAIL``,
    40): the postmortem a classified error carries.  Sliced from the
    offset, without copying the whole ring under the lock."""
    if n is None:
        n = env_int("DR_GPU_TRACE_TAIL", 40)
    with _lock:
        return list(islice(_ring, max(0, len(_ring) - n), None))


def thread_names() -> dict:
    return dict(_tid_names)


def reset() -> None:
    """Drop every recorded event and open span (tests; the count of
    :func:`events_recorded` is kept)."""
    with _lock:
        _ring.clear()
        _open.clear()


# ---------------------------------------------------------------------------
# hooks for spmd_guard and faults (installed by the slice that ports them)
# ---------------------------------------------------------------------------

def _key_label(key) -> str:
    """Short label of a dispatch key: the leading tag of the tuple keys,
    else the type name (not repr: keys can be large)."""
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        return key[0]
    return type(key).__name__


def _on_dispatch(key) -> None:
    event("dispatch", cat="dispatch", key=_key_label(key))


def _on_compile(key) -> None:
    event("compile", cat="dispatch", key=_key_label(key))


def _on_site(site: str, ctx: dict) -> None:
    # dispatch.cache and device.lost reach the trace through the dispatch
    # hook already
    if site in ("dispatch.cache", "device.lost"):
        return
    # a site's context keys may collide with event()'s own parameters
    event(site, cat="site",
          **{(f"ctx_{k}" if k in ("name", "cat") else k): str(v)[:80]
             for k, v in ctx.items()})


def _on_fault(site: str, kind: str) -> None:
    event("fault", cat="fault", site=site, kind=kind)


def arm(on: bool = True) -> None:
    """Flip the module guard.  Arming re-reads ``DR_GPU_TRACE_BUF`` and
    keeps the tail of the ring's contents."""
    global _armed, _ring
    if on:
        cap = env_int("DR_GPU_TRACE_BUF", 65536, floor=16)
        with _lock:
            if _ring.maxlen != cap:
                _ring = deque(_ring, maxlen=cap)
        _armed = True
    else:
        _armed = False


def _atexit_export() -> None:  # pragma: no cover - process teardown
    from . import export
    try:
        path = export.write()
        print(f"dr_tpu_torch.obs: trace written to {path}", file=sys.stderr)
    except OSError as e:
        print(f"dr_tpu_torch.obs: trace export failed: {e!r}",
              file=sys.stderr)


def install() -> bool:
    """Arm from the environment (``DR_GPU_TRACE=1``) and register the
    Chrome-trace export at process exit; idempotent; returns whether
    tracing is armed."""
    global _installed
    if _installed or not env_flag("DR_GPU_TRACE"):
        return _armed
    arm(True)
    atexit.register(_atexit_export)
    _installed = True
    return True
