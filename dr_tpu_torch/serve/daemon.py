"""Serving daemon: ONE resident device claim, crash-safe multi-client
serving (counterpart of ``dr_tpu/serve/daemon.py``).

One long-lived process owns the claim on the card's ranks, and every
other process is a THIN client speaking the length-prefixed JSON/npy
protocol over a local Unix-domain socket.  Clients come and go (and
crash); the claim never moves.

Threads::

    accept loop ──> per-connection reader ──> AdmissionQueue
                                                   │ take_batch
                                             dispatch thread (ONE:
                                             all device work serializes
                                             here, each batch on a
                                             with_deadline worker)

The dispatcher coalesces the batchable requests of each queue pop into
ONE ``dr_tpu_torch.deferred()`` region, so concurrent clients' ops flush
as one plan (``plan/__init__.py``; on CUDA ranks a run whose rows and
scalars repeat replays one CUDA graph); non-fusible ops (sort, the
data-dependent relational ops, the resident cache's put/get/drop) run
alone after the fused group, order preserved within the batch.
Robustness contract (the ``serve.accept`` / ``serve.request`` /
``serve.flush`` / ``serve.drain`` fault sites):

* request errors are classified and SERIALIZED back to the client —
  they never kill the daemon;
* a client disconnect mid-request cancels its work cleanly (no reply,
  no poisoned claim);
* overload is a typed ``ServerOverloaded`` rejection (queue.py);
* expired requests are shed before dispatch;
* a deterministic error in one request of a fused batch fails that
  request alone (poison-pill isolation: each request re-runs solo);
* a ``RelayDownError`` or a flush past its watchdog
  (``DeadlineExpired``) fails its batch classified, and the daemon
  serves on on the same ranks.  A flush that overran is never
  replayed: its abandoned worker may still be launching.  No batch (and
  no grow-back) starts while it runs: the next one waits for it up to
  the flush deadline and then fails classified, unlaunched;
* a DEVICE loss mid-batch (``DeviceLostError``, ``DR_GPU_ELASTIC=1``)
  shrinks the resident claim to the surviving ranks through the
  elastic layer (``utils/elastic.py``): the retry leg replays the batch
  on the shrunken runtime, handlers rebuild their containers, and no
  client is dropped; the shrink lands in ``stats()["shrinks"]`` and the
  story's serve chapter.  With ``DR_GPU_ELASTIC_GROW=1`` a shrunken
  claim grows back between batches (and at a batch's region exit):
  ``stats()["grows"]``;
* a stale socket file from a dead daemon is taken over at start; a
  LIVE daemon makes a second ``start()`` fail with a classified error
  before the newcomer can race the claim;
* ``drain()`` (the ``drain`` wire op and the ``__main__`` SIGTERM
  handler) stops admitting — new compute requests get a classified
  ``ServerDraining`` — finishes the in-flight batches, and stops; with
  ``DR_GPU_SERVE_STATE_DIR`` set, ``put``/``drop`` append to a
  crash-safe journal (``journal.py``) replayed at the next start,
  behind a generation fence that stops a stale daemon which lost the
  socket takeover from ever serving again.

Where the port differs from the JAX daemon: the claim is the runtime
already initialised on the requested route (``dt.init(["cpu"] * 8)``
before a ``cpu=True`` server, ``dt.init(["cuda:0"] * 4)`` before a
device one), else ``dt.init()`` (every CUDA device; it raises without
one) or, with ``cpu=True``, one CPU rank.  A daemon not asked for the
CPU never serves on it: there is no degrade to the CPU route and no
route re-promotion, ``stats()["restarts"]`` stays 0 and the route is
the requested one.  A batch runs on a fresh watchdog thread, which sets
the device of the ranks it runs on; no other thread of the daemon
touches the card while a batch may be capturing a CUDA graph (the
reader threads decode npy on the host, and ``stop()`` waits for the
running batch before it drops the residents), and no batch of another
server in the process runs at once (``_RANKS``: the replicas of an
in-process router fleet share one runtime).  A reply's write is
bounded by the connection's ``SO_SNDTIMEO``, not by ``settimeout()``
around the send as in the JAX daemon: that flips the descriptor
non-blocking under the connection's reader thread, whose next
``recv()`` can then fail with EAGAIN and drop a healthy client.  Notes
the JAX package warns through its fallback registry (a stale socket
taken over, an unavailable arena or journal) go to ``drlog``, the
counters and ``stats()["notes"]``.
"""

from __future__ import annotations

import os
import socket
import struct
import tempfile
import threading
import time
import weakref

import numpy as np
import torch

from .. import obs as _obs
from ..obs import metrics as _om
from ..utils import elastic as _elastic
from ..utils import faults as _faults
from ..utils import resilience
from ..utils.env import env_float, env_int, env_str
from ..utils.logging import drlog
from . import arena as _arena
from . import journal as _journal
from . import protocol
from .queue import AdmissionQueue, Request
from .resident import ResidentCache, ResidentStub
from ..parallel import runtime as _rt_mod

#: always-live per-request latency split (the obs metrics registry):
#: queue-wait (submit -> dispatch pop), service (dispatch pop -> reply
#: posted), and the shared batch-flush wall time.  Sampled on every run;
#: the ``stats`` wire op reports them, traced or not.
_h_queue_wait = _om.histogram("serve.queue_wait_ms")
_h_service = _om.histogram("serve.service_ms")
_h_flush = _om.histogram("serve.flush_ms")


#: distinct tenants granted their own histogram pair; past the cap
#: further names fold into one overflow bucket — tenant ids are
#: client-supplied strings, and per-request ids must not grow the
#: metrics registry (serialized on every stats op) without bound
_TENANT_HIST_CAP = 64
_tenant_hist_keys: set = set()


def _h_tenant(kind: str, tenant: str):
    """Per-tenant latency histogram (``serve.<kind>_ms.t.<tenant>``):
    the numbers that make weighted-fair isolation visible — a heavy
    tenant's queue-wait dilates, a light tenant's stays flat.  Names
    beyond the first ``_TENANT_HIST_CAP`` distinct tenants share the
    ``__other__`` bucket."""
    if tenant not in _tenant_hist_keys:
        if len(_tenant_hist_keys) >= _TENANT_HIST_CAP:
            tenant = "__other__"
        _tenant_hist_keys.add(tenant)
    return _om.histogram(f"serve.{kind}_ms.t.{tenant}")


__all__ = ["Server", "default_socket_path", "daemon_alive",
           "reset_state", "OPS"]


def default_socket_path() -> str:
    """``DR_GPU_SERVE_SOCKET``, or a per-uid path under the system temp
    dir (Unix-domain socket paths are capped near 107 bytes, so the
    default stays short).  Its name differs from the JAX package's
    default, so the two daemons never share a socket."""
    return env_str("DR_GPU_SERVE_SOCKET") or os.path.join(
        tempfile.gettempdir(), f"dr_gpu_serve_{os.getuid()}.sock")


def daemon_alive(path: str, timeout: float = 2.0) -> bool:
    """True when SOMETHING holds the socket at ``path`` — an answering
    daemon, or one that has bound but is still claiming its ranks (a
    connect succeeds against the listen backlog before the accept loop
    runs).  Only a refused/failed CONNECT reads as dead: treating a slow
    claimer as dead would let a second daemon take over the socket and
    race the claim."""
    from .client import Client
    try:
        c = Client(path, timeout=timeout)
    except Exception:
        return False  # nothing listening: stale socket file
    try:
        c.ping()
    except Exception:
        pass  # bound but not serving yet: still alive
    finally:
        c.close()
    return True


# ---------------------------------------------------------------------------
# op registry
# ---------------------------------------------------------------------------
# module-level ops: plan cache keys pin callable identity, so
# per-request closures would miss the cache every batch

def _op_scale(x, a, b):
    return x * a + b


class _OpSpec:
    __slots__ = ("name", "narrays", "batchable", "handler", "validate")

    def __init__(self, name, narrays, batchable, handler, validate=None):
        self.name = name
        self.narrays = narrays
        self.batchable = batchable
        self.handler = handler
        #: intake-time request check (reader thread): a malformed
        #: request is rejected to ITS client before it can join — and
        #: poison — a fused batch
        self.validate = validate


def _vec(arr, mutate=False):
    """Operand to container: a resident reference (intake substituted a
    :class:`ResidentStub`) resolves to the CACHED container — no
    rebuild, no host->device transfer; a handler that MUTATES its
    operand gets a device-side scratch copy instead (the cache entry
    must keep answering later requests unchanged).  Plain arrays build
    fresh f32 containers on the daemon's ranks."""
    import dr_tpu_torch as dt
    cont = getattr(arr, "_dr_resident", None)
    if cont is not None:
        if not mutate:
            return cont
        scratch = dt.distributed_vector(len(cont), cont.dtype)
        dt.copy(cont, scratch)
        return scratch
    return dt.distributed_vector.from_array(
        np.ascontiguousarray(np.asarray(arr, np.float32)))


def _v_fill(req):
    if int(req.params.get("n", 0)) <= 0:
        raise resilience.ProgramError(
            f"serve: fill needs params.n >= 1, got "
            f"{req.params.get('n', 0)!r}", site="serve.request")


def _h_fill(req):
    import dr_tpu_torch as dt
    v = dt.distributed_vector(int(req.params["n"]), np.float32)
    dt.fill(v, float(req.params.get("value", 0.0)))
    return lambda: ({}, [dt.to_numpy(v)])


def _h_scale(req):
    import dr_tpu_torch as dt
    v = _vec(req.arrays[0], mutate=True)
    dt.for_each(v, _op_scale, float(req.params.get("a", 1.0)),
                float(req.params.get("b", 0.0)))
    return lambda: ({}, [dt.to_numpy(v)])


def _h_reduce(req):
    import dr_tpu_torch as dt
    s = dt.reduce(_vec(req.arrays[0]))
    return lambda: ({"scalar": float(s)}, [])


def _v_vector(req):
    for a in req.arrays:
        if np.asarray(a).ndim != 1 or np.asarray(a).size == 0:
            raise resilience.ProgramError(
                f"serve: op {req.op!r} takes non-empty 1-D arrays, got "
                f"shape {np.asarray(a).shape}", site="serve.request")


def _v_dot(req):
    _v_vector(req)
    a, b = req.arrays
    if np.asarray(a).shape != np.asarray(b).shape:
        raise resilience.ProgramError(
            "serve: dot operands must share a shape",
            site="serve.request")


def _h_dot(req):
    import dr_tpu_torch as dt
    a, b = req.arrays
    s = dt.dot(_vec(a), _vec(b))
    return lambda: ({"scalar": float(s)}, [])


def _h_scan(req):
    import dr_tpu_torch as dt
    v = _vec(req.arrays[0])
    out = dt.distributed_vector(len(v), np.float32)
    dt.inclusive_scan(v, out)
    return lambda: ({}, [dt.to_numpy(out)])


def _h_sort(req):
    import dr_tpu_torch as dt
    v = _vec(req.arrays[0], mutate=True)
    dt.sort(v, descending=bool(req.params.get("descending", False)))
    return lambda: ({}, [dt.to_numpy(v)])


# --- relational layer: join/groupby/unique have data-dependent result
# sizes and run SOLO (solo keeps one request's big expansion out of its
# batchmates' flush); topk/histogram are static-shape FUSIBLE and batch
# into the shared deferred flush with the elementwise ops.  Result
# arrays come back trimmed to the real row count.

def _v_groupby(req):
    _v_vector(req)
    from ..algorithms.relational import AGGS
    a, b = req.arrays
    if np.asarray(a).shape != np.asarray(b).shape:
        raise resilience.ProgramError(
            "serve: groupby keys and values must share a shape",
            site="serve.request")
    if str(req.params.get("agg", "sum")) not in AGGS:
        raise resilience.ProgramError(
            f"serve: unknown groupby agg {req.params.get('agg')!r} "
            f"(known: {', '.join(AGGS)})", site="serve.request")


def _h_groupby(req):
    import dr_tpu_torch as dt
    k, v = _vec(req.arrays[0]), _vec(req.arrays[1])
    n = len(k)
    ok = dt.distributed_vector(n, np.float32)
    ov = dt.distributed_vector(n, np.float32)
    ng = dt.groupby_aggregate(k, v, ok, ov,
                              agg=str(req.params.get("agg", "sum")))

    def fin():
        m = int(ng)
        return ({"count": m}, [dt.to_numpy(ok)[:m], dt.to_numpy(ov)[:m]])
    return fin


def _h_unique(req):
    import dr_tpu_torch as dt
    v = _vec(req.arrays[0])
    out = dt.distributed_vector(len(v), np.float32)
    nu = dt.unique(v, out)

    def fin():
        m = int(nu)
        return ({"count": m}, [dt.to_numpy(out)[:m]])
    return fin


def _v_join(req):
    _v_vector(req)
    from ..algorithms.relational import JOIN_HOWS
    lk, lv, rk, rv = (np.asarray(a) for a in req.arrays)
    if lk.shape != lv.shape or rk.shape != rv.shape:
        raise resilience.ProgramError(
            "serve: join keys and values must share a shape per side",
            site="serve.request")
    if str(req.params.get("how", "inner")) not in JOIN_HOWS:
        raise resilience.ProgramError(
            f"serve: unknown join how {req.params.get('how')!r} "
            f"(known: {', '.join(JOIN_HOWS)})", site="serve.request")


def _h_join(req):
    import dr_tpu_torch as dt
    lk, lv = _vec(req.arrays[0]), _vec(req.arrays[1])
    rk, rv = _vec(req.arrays[2]), _vec(req.arrays[3])
    # default capacity covers the common feature-join shapes; a
    # many-to-many expansion beyond it raises the classified capacity
    # ProgramError back to THIS client (params.capacity overrides)
    cap = int(req.params.get("capacity", 4 * (len(lk) + len(rk))))
    ok = dt.distributed_vector(cap, np.float32)
    ol = dt.distributed_vector(cap, np.float32)
    orr = dt.distributed_vector(cap, np.float32)
    m = dt.join(lk, lv, rk, rv, ok, ol, orr,
                how=str(req.params.get("how", "inner")),
                fill=float(req.params.get("fill", 0.0)))

    def fin():
        c = int(m)
        return ({"count": c}, [dt.to_numpy(ok)[:c], dt.to_numpy(ol)[:c],
                               dt.to_numpy(orr)[:c]])
    return fin


def _v_topk(req):
    _v_vector(req)
    if int(req.params.get("k", 0)) < 1:
        raise resilience.ProgramError(
            f"serve: topk needs params.k >= 1, got "
            f"{req.params.get('k', 0)!r}", site="serve.request")


def _h_topk(req):
    import dr_tpu_torch as dt
    v = _vec(req.arrays[0])
    k = int(req.params["k"])
    tv = dt.distributed_vector(k, np.float32)
    ti = dt.distributed_vector(k, np.int32)
    dt.top_k(v, tv, ti, largest=bool(req.params.get("largest", True)))
    return lambda: ({}, [dt.to_numpy(tv), dt.to_numpy(ti)])


def _v_histogram(req):
    _v_vector(req)
    bins = int(req.params.get("bins", 0))
    lo = req.params.get("lo")
    hi = req.params.get("hi")
    if bins < 1 or lo is None or hi is None \
            or not float(hi) > float(lo):
        raise resilience.ProgramError(
            f"serve: histogram needs params bins >= 1 and hi > lo "
            f"(got bins={bins!r}, lo={lo!r}, hi={hi!r})",
            site="serve.request")


def _h_histogram(req):
    import dr_tpu_torch as dt
    v = _vec(req.arrays[0])
    out = dt.distributed_vector(int(req.params["bins"]), np.int32)
    dt.histogram(v, out, float(req.params["lo"]), float(req.params["hi"]))
    return lambda: ({}, [dt.to_numpy(out)])


# --- resident container cache: put builds the tenant's container ONCE
# on the dispatch worker; later ops reference it by name (header refs)
# and skip the rebuild; get/drop read back / evict.  All three run solo
# — put/get move whole payloads and must not dilate their batchmates'
# fused flush.

def _name_of(req) -> str:
    return str(req.params["name"])


def _v_named(req):
    if not str(req.params.get("name", "")):
        raise resilience.ProgramError(
            f"serve: op {req.op!r} needs a nonempty params.name",
            site="serve.request")


def _v_put(req):
    _v_named(req)
    _v_vector(req)


def _h_put(req):
    entry, cached = req.server._resident.put(req.tenant, _name_of(req),
                                             req.arrays[0])
    # durability: journal the put before the reply — once the client
    # hears "ok" the entry survives a SIGKILL
    req.server._journal_put(req.tenant, _name_of(req), entry,
                            req.arrays[0])
    return lambda: ({"handle": _name_of(req), "tag": entry.tag,
                     "bytes": entry.nbytes, "cached": cached}, [])


def _h_get(req):
    import dr_tpu_torch as dt
    entry = req.server._resident.require(req.tenant, _name_of(req))
    arr = dt.to_numpy(entry.cont)
    return lambda: ({"tag": entry.tag}, [arr])


def _h_drop(req):
    dropped = req.server._resident.drop(req.tenant, _name_of(req))
    if dropped:
        req.server._journal_drop(req.tenant, _name_of(req))
    return lambda: ({"dropped": dropped}, [])


#: op name -> (operand count, batchable into one deferred flush?).
#: sort is NON-fusible (a plan flush point) and the relational
#: join/groupby/unique record OPAQUE with data-dependent result sizes —
#: all of these dispatch alone, after the batch's fused group;
#: topk/histogram are static-shape fusible and batch.
OPS = {
    "fill": _OpSpec("fill", 0, True, _h_fill, _v_fill),
    "scale": _OpSpec("scale", 1, True, _h_scale, _v_vector),
    "reduce": _OpSpec("reduce", 1, True, _h_reduce, _v_vector),
    "dot": _OpSpec("dot", 2, True, _h_dot, _v_dot),
    "scan": _OpSpec("scan", 1, True, _h_scan, _v_vector),
    "sort": _OpSpec("sort", 1, False, _h_sort, _v_vector),
    "join": _OpSpec("join", 4, False, _h_join, _v_join),
    "groupby": _OpSpec("groupby", 2, False, _h_groupby, _v_groupby),
    "unique": _OpSpec("unique", 1, False, _h_unique, _v_vector),
    "topk": _OpSpec("topk", 1, True, _h_topk, _v_topk),
    "histogram": _OpSpec("histogram", 1, True, _h_histogram,
                         _v_histogram),
    "put": _OpSpec("put", 1, False, _h_put, _v_put),
    "get": _OpSpec("get", 0, False, _h_get, _v_named),
    "drop": _OpSpec("drop", 0, False, _h_drop, _v_named),
}


class _Conn:
    """Per-connection daemon-side state: the socket, a write lock (the
    dispatcher and the reader both reply), and the pending-request set
    cancelled wholesale on disconnect."""

    __slots__ = ("sock", "lock", "pending", "closed", "__weakref__")

    def __init__(self, sock):
        self.sock = sock
        self.lock = threading.Lock()
        self.pending = set()
        self.closed = False


#: live in-process servers; serve.reset() stops leaks
_live_servers: "weakref.WeakSet" = weakref.WeakSet()


class _RankGate:
    """The ranks of the process's runtime, shared by every in-process
    ``Server`` (an in-process fleet's replicas claim the same runtime):
    ``busy`` counts the batch workers running on them, of any server,
    under ``cv``.  One batch at a time: a second server's worker would
    launch into a CUDA graph another is capturing, share a kernel's
    per-stream workspace, and move launch counts under a capture."""

    def __init__(self):
        self.cv = threading.Condition()
        self.busy = 0


_RANKS = _RankGate()

#: the env markers the daemon publishes for ``resilience.session_story``
#: (the router's markers are cleared here too, so a story never
#: outlives its test)
_MARKERS = ("_DR_GPU_SERVE_DEGRADED", "_DR_GPU_SERVE_QUEUE_DEPTH",
            "_DR_GPU_SERVE_SHED", "_DR_GPU_SERVE_RESTARTS",
            "_DR_GPU_SERVE_ROUTER_DEAD", "_DR_GPU_SERVE_ROUTER_REASON",
            "_DR_GPU_SERVE_DRAINS", "_DR_GPU_SERVE_RESPAWNS",
            "_DR_GPU_SERVE_ROUTER_DRAINED",
            "_DR_GPU_SERVE_ROUTER_RECOVERED",
            "_DR_GPU_SERVE_JOURNAL_RECOVERED",
            "_DR_GPU_SERVE_JOURNAL_TRUNCATED")

#: the most recent notes a server keeps for ``stats()["notes"]``
_NOTES_KEPT = 16


def reset_state() -> None:
    """Stop every live in-process server and clear the serve env
    markers, so one test's daemon (or its story) cannot leak into the
    next."""
    for srv in list(_live_servers):
        try:
            srv.stop()
        except Exception:  # pragma: no cover - teardown best effort
            pass
    for m in _MARKERS:
        os.environ.pop(m, None)


class Server:
    """The resident daemon.  ``start()`` refuses/takes over the socket,
    claims its ranks ONCE, and serves until ``stop()`` (or a client
    ``shutdown`` op).  In-process use::

        srv = Server(path).start()
        try:
            with Client(path) as c:
                c.scale(x, a=2.0)
        finally:
            srv.stop()
    """

    def __init__(self, socket_path=None, *, queue_depth=None,
                 tenant_cap=None, batch_max=None, batch_window=None,
                 flush_deadline=None, cpu=False,
                 state_dir=None):
        self.path = socket_path or default_socket_path()
        # crash-safe resident-state journal: armed by a state directory
        # (kwarg or DR_GPU_SERVE_STATE_DIR); None = resident state stays
        # process-memory-only
        self.state_dir = (env_str("DR_GPU_SERVE_STATE_DIR") or None
                          if state_dir is None else str(state_dir))
        self._journal = None
        self._journal_errors = 0
        # graceful drain
        self._draining = threading.Event()
        self.drain_timeout = env_float("DR_GPU_SERVE_DRAIN_TIMEOUT",
                                       30.0)
        self._drains = 0
        self._drain_rejects = 0
        #: replies mid-write (dispatch thread): the drain gate must
        #: cover the reply send too — the queue slot releases BEFORE
        #: the reply hits the wire, and a drain that stopped in that
        #: window would tear the very reply it waited for
        self._finishing = 0
        #: the REQUESTED route, which is the only route this daemon
        #: ever serves on
        self.cpu_requested = bool(cpu)
        self.requested_route = "cpu" if cpu else "device"
        self._route = None
        #: ranks before the FIRST shrink of the current degraded
        #: episode: a grow-back clears the degraded flag only once the
        #: claim is back to this size
        self._pre_shrink_nprocs = None
        self.queue_depth = (env_int("DR_GPU_SERVE_QUEUE_DEPTH", 64)
                            if queue_depth is None else int(queue_depth))
        self.tenant_cap = (env_int("DR_GPU_SERVE_TENANT_CAP", 8)
                           if tenant_cap is None else int(tenant_cap))
        self.batch_max = (env_int("DR_GPU_SERVE_BATCH_MAX", 16)
                          if batch_max is None else int(batch_max))
        self.batch_window = (env_float("DR_GPU_SERVE_BATCH_WINDOW", 0.002)
                             if batch_window is None
                             else float(batch_window))
        self.flush_deadline = (env_float("DR_GPU_SERVE_FLUSH_DEADLINE",
                                         120.0)
                               if flush_deadline is None
                               else float(flush_deadline))
        self.default_deadline = env_float("DR_GPU_SERVE_DEADLINE", 30.0)
        # serving data plane: the shared-memory arena (created at start;
        # None = inline-wire only) and the per-tenant resident cache
        self.arena_min = env_int("DR_GPU_SERVE_ARENA_MIN_BYTES", 1 << 16)
        self._arena = None
        self._arena_unavailable = None
        self._resident = ResidentCache()
        self._queue = AdmissionQueue(self.queue_depth, self.tenant_cap)
        self._stop = threading.Event()
        self._stopped = threading.Event()
        self._stop_lock = threading.Lock()
        self._hold = threading.Event()  # test hook: park dispatch
        #: this server's batch workers still running, a flush
        #: abandoned at its deadline included: stop() drops no resident
        #: while one runs (it may be capturing a graph over them, and a
        #: second thread's CUDA calls would break that).  No batch of
        #: any server starts while one runs (``_RANKS``, whose condition
        #: guards this count too)
        self._workers = 0
        self._sock = None
        self._bound = False
        self._threads = []
        self._conns: "weakref.WeakSet" = weakref.WeakSet()
        self._lock = threading.Lock()
        self.degraded = None
        self.devices = None
        self._notes: list = []
        # counters
        self._requests = 0
        self._replies = 0
        self._errors = 0
        self._cancelled = 0
        self._accept_drops = 0
        self._flushes = 0
        self._batched = 0
        self._batch_hw = 0
        self._restarts = 0
        self._shrinks = 0
        self._grows = 0
        self._plan = {"graph_captures": 0, "graph_replays": 0,
                      "eager_runs": 0}

    def _note(self, msg: str) -> None:
        """Log a note (a stale socket taken over, an unavailable arena
        or journal): ``drlog``, a ``serve.note`` trace event, and the
        last few in ``stats()["notes"]``."""
        drlog.debug("serve: {}", msg)
        _obs.event("serve.note", cat="serve", msg=msg[:200])
        with self._lock:
            self._notes.append(msg)
            del self._notes[:-_NOTES_KEPT]

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Server":
        # socket refusal, then BIND, then claim: holding the socket
        # before the claim closes the window where a second daemon sees
        # no socket and races the claim; daemon_alive treats
        # bound-but-claiming as alive, so the newcomer still refuses
        _rt_mod.require_single_process("Server.start", _rt_mod.ONE_SERVER)
        self._refuse_or_takeover()
        # the shared-memory arena is pure host state: created before the
        # claim, destroyed at stop.  A host without usable shared memory
        # serves on the inline wire (a transport, not a route off the
        # device), counted as an arena fallback.
        if env_int("DR_GPU_SERVE_ARENA", 1, floor=0):
            try:
                self._arena = _arena.Arena()
            except Exception as e:
                self._arena = None
                self._arena_unavailable = repr(e)
                _arena.note_fallback(f"shared-memory arena unavailable "
                                     f"({e!r}); serving on the inline "
                                     "wire only")
                self._note("shared-memory arena unavailable; inline "
                           "wire only")
        self._bind()
        if self.state_dir:
            # journal ownership rides socket ownership: the generation
            # bump happens right after the bind so a stale daemon that
            # lost the takeover is fenced the moment the new owner holds
            # the socket
            try:
                self._journal = _journal.Journal(self.state_dir,
                                                 self.path)
                self._journal.claim()
            except (OSError, resilience.ResilienceError) as e:
                # an unwritable state dir degrades DURABILITY, never
                # the daemon
                self._journal = None
                self._journal_errors += 1
                self._note(f"resident journal unavailable ({e}); serving "
                           "without resident durability")
        try:
            self._claim()
            self._replay_journal()
        except BaseException:
            self.stop()  # a failed claim must release the socket
            raise
        self._stop.clear()
        self._draining.clear()
        self._stopped.clear()
        for name, fn in (("serve-accept", self._accept_loop),
                         ("serve-dispatch", self._dispatch_loop)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        _live_servers.add(self)
        return self

    def _refuse_or_takeover(self) -> None:
        if not os.path.exists(self.path):
            return
        if daemon_alive(self.path):
            raise resilience.ProgramError(
                f"serve: another daemon is already serving on "
                f"{self.path} — refusing to race its device claim",
                site="serve.accept")
        # dead daemon's leftover: note it and take the socket over
        self._note("stale socket file taken over (previous daemon died "
                   "uncleanly)")
        os.unlink(self.path)

    def _claim(self) -> None:
        """Claim the ranks ONCE: the runtime already initialised on the
        requested route, else ``init()`` — every CUDA device, raising
        without one — or one CPU rank when the CPU was requested.  Any
        failure is classified (site ``runtime.init``); there is no other
        route to try."""
        from ..parallel import runtime as _rt
        want = "cpu" if self.cpu_requested else "cuda"
        try:
            rt = _rt.runtime() if _rt.is_initialized() else None
            if rt is None or any(d.type != want for d in rt.devices):
                rt = _rt.init(["cpu"] if self.cpu_requested else None)
        except Exception as e:
            ce = resilience.classified(e, site="runtime.init")
            if ce is e:
                raise
            raise ce from e
        self.devices = list(rt.devices)
        self._route = self.requested_route

    def _bind(self) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.bind(self.path)
        except OSError as e:
            s.close()
            raise resilience.classified(
                f"serve: cannot bind {self.path}: {e!r}",
                site="serve.accept")
        s.listen(64)
        s.settimeout(0.2)  # keep the accept loop responsive to stop()
        self._sock = s
        self._bound = True

    def stop(self) -> None:
        """Stop serving: drain nothing, break the loops, close the
        socket, publish the serve markers.  Idempotent — the FIRST
        caller performs the teardown, later callers block until it
        completes."""
        if not self._stop_lock.acquire(blocking=False):
            self._stopped.wait(timeout=10.0)
            return
        try:
            if self._stopped.is_set():
                return
            self._do_stop()
            self._stopped.set()
        finally:
            self._stop_lock.release()

    def _do_stop(self) -> None:
        self._stop.set()
        with _RANKS.cv:  # a batch waiting on a worker gives up
            _RANKS.cv.notify_all()
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:  # pragma: no cover - already closed
                pass
        # close accepted connections too: shutdown() first — a plain
        # close() does not interrupt a reader thread already blocked
        # in recv(); shutdown delivers the EOF into the in-flight read
        for cs in list(self._conns):
            cs.closed = True
            try:
                cs.sock.shutdown(socket.SHUT_RDWR)
            except OSError:  # pragma: no cover - already gone
                pass
            try:
                cs.sock.close()
            except OSError:  # pragma: no cover - already closed
                pass
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        self._threads = []
        # data-plane teardown: the arena segment is unlinked (a dead
        # daemon must not leak /dev/shm) and the resident cache is
        # dropped so its containers release device memory — once no
        # batch is running: its worker may be capturing a CUDA graph
        # over those very rows
        if self._arena is not None:
            self._arena.destroy()
            self._arena = None
        if self._await_workers(self.flush_deadline):
            self._resident.clear()
        else:  # pragma: no cover - a wedged batch keeps its rows
            self._note("stop: a batch is still running; the resident "
                       "containers are left to it")
        if self._bound:
            # only the daemon that BOUND the socket may unlink it: a
            # stop() after a refused start must not delete the LIVE
            # incumbent's socket
            self._bound = False
            try:
                if os.path.exists(self.path):
                    os.unlink(self.path)
            except OSError:  # pragma: no cover - teardown best effort
                pass
            self._publish_markers()
        _live_servers.discard(self)

    def drain(self, timeout=None, *, _fire=True) -> None:
        """Graceful drain (the ``drain`` wire op and the ``__main__``
        SIGTERM handler land here): stop admitting — new compute
        requests are rejected with the classified ``ServerDraining`` —
        finish the in-flight batches, (the journal's appends are
        fsync'd, so there is nothing left to flush), publish the
        markers, and stop.  Bounded by ``timeout`` (default
        ``DR_GPU_SERVE_DRAIN_TIMEOUT``): on expiry ``stop()`` cancels
        whatever remains.  Idempotent: a second caller waits for the
        first drain to complete.  ``_fire=False`` skips the fault fire
        — for callers (the wire op) that already fired it synchronously
        to deliver a classified rejection."""
        if _fire:
            _faults.fire("serve.drain", path=self.path)
        if self._draining.is_set() or self._stopped.is_set():
            self._stopped.wait(self.drain_timeout if timeout is None
                               else float(timeout))
            return
        self._draining.set()
        self._drains += 1
        os.environ["_DR_GPU_SERVE_DRAINS"] = \
            str(env_int("_DR_GPU_SERVE_DRAINS", 0, floor=0) + 1)
        _obs.event("serve.drain", cat="serve", path=self.path)
        deadline = time.monotonic() + (self.drain_timeout
                                       if timeout is None
                                       else float(timeout))
        while time.monotonic() < deadline:
            if self._queue.idle() and not self._finishing:
                break
            time.sleep(0.005)
        self.stop()

    def draining(self) -> bool:
        return self._draining.is_set()

    # ------------------------------------------------- resident journal
    def _replay_journal(self) -> None:
        """Replay the resident-state journal into the cache: a drained
        or SIGKILLed daemon comes back serving its tenants' residents
        bit-equal, then the journal compacts to the live set (atomic
        rewrite).  A torn tail truncates cleanly inside
        ``Journal.replay`` (marker published); any classified replay
        failure leaves an EMPTY resident cache — a corrupt journal must
        never brick the daemon."""
        if self._journal is None:
            return
        try:
            live = self._journal.replay()
            for (tenant, name), (_tag, payload) in live.items():
                arr = _journal.decode_payload(payload)
                self._resident.put(tenant, name, arr)
        except (OSError, resilience.ResilienceError) as e:
            self._journal_errors += 1
            # entries replayed BEFORE the failure must not linger: a
            # partial resident set served as if whole is a silent
            # wrong answer — empty is the honest state
            self._resident.clear()
            self._note(f"resident journal replay failed ({e}); starting "
                       "with an empty resident cache")
            return
        try:
            self._journal.compact(live)
        except (OSError, resilience.ResilienceError) as e:
            # compaction failed AFTER a complete replay: compact is
            # atomic temp+replace, so the old journal is intact on disk
            # and the replayed residents are whole — keep them
            self._journal_errors += 1
            self._note(f"resident journal compaction failed ({e}); "
                       "replayed residents kept, journal left as-is")
        if self._journal.replayed:
            os.environ["_DR_GPU_SERVE_JOURNAL_RECOVERED"] = \
                str(self._journal.replayed)
        if self._journal.truncated_bytes:
            os.environ["_DR_GPU_SERVE_JOURNAL_TRUNCATED"] = \
                str(self._journal.truncated_bytes)
            self._note(f"resident journal tail was torn "
                       f"({self._journal.truncated_bytes} bytes "
                       "truncated); every record before the tear "
                       "replayed")
        _obs.event("serve.journal.replay", cat="serve",
                   entries=self._journal.replayed,
                   truncated=self._journal.truncated_bytes)

    def _journal_put(self, tenant: str, name: str, entry, arr) -> None:
        """Journal one resident put.  A generation-fence violation is
        fatal — the stale daemon stops serving and the classified error
        reaches the requesting client; any other journal failure
        degrades DURABILITY (noted, counted), never the request."""
        jr = self._journal
        if jr is None or jr.has(tenant, name, entry.tag):
            return
        try:
            jr.append("put", tenant, name, entry.tag,
                      _arena.npy_bytes(np.ascontiguousarray(
                          np.asarray(arr, np.float32))))
        except (OSError, resilience.ResilienceError) as e:
            self._journal_fail(e)

    def _journal_drop(self, tenant: str, name: str) -> None:
        jr = self._journal
        if jr is None:
            return
        try:
            jr.append("drop", tenant, name)
        except (OSError, resilience.ResilienceError) as e:
            self._journal_fail(e)

    def _journal_fail(self, e) -> None:
        self._journal_errors += 1
        if self._journal is not None and self._journal.fenced:
            # stale generation: a newer daemon owns the state — this
            # daemon can never serve again.  Mark, stop on a helper
            # thread (we are ON the dispatch path), and re-raise so the
            # requesting client sees the classified error instead of a
            # silently un-journaled put.
            self._mark_degraded(
                "serve: resident journal fenced (a newer daemon took "
                "over the socket and the state); stale daemon "
                "stopping")
            threading.Thread(target=self._fence_stop,
                             name="serve-fence-stop",
                             daemon=True).start()
            raise e
        self._note(f"resident journal append failed ({e}); durability "
                   "degraded for this entry")

    def _fence_stop(self) -> None:
        """Stop a FENCED daemon — but only after the classified fence
        error (and anything else in flight) has hit the wire: a stop
        racing the reply write would hand the client a torn socket
        instead of the ProgramError that explains the death."""
        self._draining.set()  # a stale daemon must not admit more work
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if self._queue.idle() and not self._finishing:
                break
            time.sleep(0.005)
        self.stop()

    def wait(self, timeout=None) -> bool:
        """Block until the daemon is asked to stop (shutdown op /
        signal handler calling stop()); True when it was."""
        return self._stop.wait(timeout)

    def hold(self) -> None:
        """Park the dispatcher (requests queue but nothing executes) —
        the deterministic window the overload / shedding / batching
        tests need."""
        self._hold.set()

    def release(self) -> None:
        self._hold.clear()

    # ------------------------------------------------------------ accepting
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            sock = self._sock
            if sock is None:
                break
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listening socket closed under us: stopping
            try:
                _faults.fire("serve.accept")
            except resilience.ResilienceError:
                # classified accept fault: drop THIS connection, keep
                # serving — the client sees a classified close
                self._accept_drops += 1
                conn.close()
                continue
            # bound each reply write in the kernel (SO_SNDTIMEO): a
            # live-but-not-reading client whose reply overflows the
            # socket buffer must not pin the ONE dispatch thread
            # forever.  Never through settimeout() at send time: that
            # flips the descriptor non-blocking under the reader
            # thread, whose next recv() can then fail with EAGAIN and
            # drop a healthy connection
            d = max(self.default_deadline, 0.001)
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            struct.pack("ll", int(d),
                                        int((d % 1.0) * 1e6)))
            cs = _Conn(conn)
            self._conns.add(cs)
            t = threading.Thread(target=self._client_loop, args=(cs,),
                                 name="serve-client", daemon=True)
            t.start()

    def _client_loop(self, cs: _Conn) -> None:
        try:
            while not self._stop.is_set():
                try:
                    header, arrays = protocol.recv_frame(cs.sock)
                except resilience.ResilienceError as e:
                    # the connection must close either way (framing is
                    # desynced), but a MALFORMED frame is the client's
                    # deterministic bug: serialize the ProgramError
                    # back first so the client does not misread the
                    # bare close as a retryable transient
                    if isinstance(e, resilience.ProgramError):
                        self._send(cs, protocol.error_header(e))
                    break
                except OSError:
                    break  # socket closed under us (stop() teardown)
                if header is None:
                    break  # clean client disconnect
                if not self._handle_frame(cs, header, arrays):
                    break
        finally:
            cs.closed = True
            with self._lock:
                pending = list(cs.pending)
            for req in pending:
                # client crash mid-request: cancel cleanly — the
                # dispatcher skips the work, the claim is untouched
                req.cancelled = True
            if pending:
                self._cancelled += len(pending)
            if self._arena is not None:
                # a crashed client's leases (request slots it never
                # sent, reply slots it never released) free wholesale
                self._arena.release_owner(cs)
            try:
                cs.sock.close()
            except OSError:  # pragma: no cover - already closed
                pass

    def _arena_required(self):
        if self._arena is None:
            raise resilience.TransientBackendError(
                "serve: this daemon runs without a shared-memory "
                "arena — use the inline wire", site="arena.map")
        return self._arena

    def _merge_operands(self, cs: _Conn, header: dict, arrays,
                        tenant: str):
        """Assemble a request's logical operand list from the three
        transports: inline wire payloads, arena handles
        (``header["arena"]`` — mapped, then released: the bytes are
        copied out at intake), and resident references
        (``header["refs"]`` — resolved to stubs carrying the cached
        container, so the handler skips the rebuild).  An entry tagged
        ``keep`` is mapped but NOT released — the client holds the
        lease across requests (safe because ``map`` copies the bytes
        out before the reply, and the disconnect teardown still frees
        the slot wholesale).  Host work only: this runs on a reader
        thread."""
        entries = header.get("arena")
        if entries is not None:
            ar = self._arena_required()
            it = iter(arrays)
            wire = []
            for e in entries:
                if e is None:
                    wire.append(next(it, None))
                else:
                    wire.append(ar.map(e))
                    if not e.get("keep"):
                        ar.release(e)
            if any(w is None for w in wire):
                raise resilience.ProgramError(
                    "serve: frame carries fewer inline payloads than "
                    "its arena map declares", site="arena.map")
            arrays = wire
        refs = header.get("refs")
        if refs is not None:
            it = iter(arrays)
            out = []
            for r in refs:
                if r is None:
                    out.append(next(it, None))
                else:
                    out.append(ResidentStub(
                        self._resident.require(tenant, str(r))))
            if any(a is None for a in out):
                raise resilience.ProgramError(
                    "serve: frame carries fewer payloads than its "
                    "refs list declares", site="serve.request")
            arrays = out
        return arrays

    def _handle_frame(self, cs: _Conn, header: dict, arrays) -> bool:
        """One request frame; returns False to close the connection."""
        op = str(header.get("op", ""))
        rid = header.get("id")
        rel = header.get("arena_release")
        if rel:
            # piggybacked releases from the client's last reply — a bad
            # handle is the client's deterministic bug, serialized back
            # before the op can run
            try:
                ar = self._arena_required()
                for h in rel:
                    ar.release(h)
            except Exception as e:
                self._errors += 1
                self._send(cs, protocol.error_header(
                    resilience.classified(e, site="arena.release"),
                    id=rid))
                return True
        if op == "ping":
            hdr = {"ok": True, "pong": True, "pid": os.getpid(),
                   "id": rid}
            if self._arena is not None:
                hdr["arena"] = {"name": self._arena.name,
                                "size": self._arena.size}
            if self._draining.is_set():
                # health checks must see a draining daemon as NOT ready
                hdr["draining"] = True
            self._send(cs, hdr)
            return True
        if op == "drain":
            # the fault site fires HERE, before the ack — a faulted
            # drain must reach the caller classified, not die in the
            # helper thread after a positive acknowledgement
            try:
                _faults.fire("serve.drain", path=self.path)
            except resilience.ResilienceError as e:
                self._send(cs, protocol.error_header(e, id=rid))
                return True
            self._send(cs, {"ok": True, "draining": True, "id": rid})
            threading.Thread(target=lambda: self.drain(_fire=False),
                             name="serve-drain", daemon=True).start()
            return False
        if op == "stats":
            self._send(cs, {"ok": True, "stats": self.stats(),
                            "id": rid})
            return True
        if op == "arena_alloc":
            try:
                ar = self._arena_required()
                sizes = (header.get("params") or {}).get("nbytes", [])
                slots = []
                try:
                    for nb in sizes:
                        slots.append(ar.alloc(int(nb), owner=cs))
                except BaseException:
                    for h in slots:  # all-or-nothing lease
                        ar.release(h)
                    raise
                self._send(cs, {"ok": True, "id": rid, "slots": slots})
            except Exception as e:
                self._errors += 1
                self._send(cs, protocol.error_header(
                    resilience.classified(e, site="arena.map"),
                    id=rid))
            return True
        if op == "arena_release":
            try:
                ar = self._arena_required()
                handles = (header.get("params") or {}).get("handles",
                                                           [])
                for h in handles:
                    ar.release(h)
                self._send(cs, {"ok": True, "id": rid,
                                "released": len(handles)})
            except Exception as e:
                self._errors += 1
                self._send(cs, protocol.error_header(
                    resilience.classified(e, site="arena.release"),
                    id=rid))
            return True
        if op == "shutdown":
            self._send(cs, {"ok": True, "stopping": True, "id": rid})
            threading.Thread(target=self.stop, name="serve-stop",
                             daemon=True).start()
            return False
        req = None
        try:
            _faults.fire("serve.request", op=op)
            if self._draining.is_set():
                # admission is closed: reject with the typed drain
                # signal, before this daemon stops
                self._drain_rejects += 1
                raise resilience.ServerDraining(
                    f"serve: daemon on {self.path} is draining — "
                    "send this tenant's work to a live daemon",
                    site="serve.request")
            spec = OPS.get(op)
            if spec is None:
                raise resilience.ProgramError(
                    f"serve: unknown op {op!r} (known: "
                    f"{', '.join(sorted(OPS))})", site="serve.request")
            tenant = str(header.get("tenant", "default"))
            arrays = self._merge_operands(cs, header, arrays, tenant)
            if len(arrays) != spec.narrays:
                raise resilience.ProgramError(
                    f"serve: op {op!r} takes {spec.narrays} array(s), "
                    f"got {len(arrays)}", site="serve.request")
            deadline = header.get("deadline_s", self.default_deadline)
            req = Request(op, header.get("params"), arrays,
                          tenant=tenant,
                          deadline_s=(None if deadline is None
                                      else float(deadline)), rid=rid)
            req.server = self
            req.arena_ok = bool(header.get("arena_ok")) \
                and self._arena is not None
            if spec.validate is not None:
                spec.validate(req)
            req.conn = cs
            # the request's obs span opens at intake (reader thread)
            # and closes in _finish (dispatch side); the flow start lets
            # the exporter draw the arrow into the batch-flush span it
            # lands in.  span stays 0 while tracing is off.
            req.span = _obs.begin("serve.request", cat="serve", op=op,
                                  tenant=req.tenant, rid=str(rid))
            _obs.flow(req.span, "s")
            with self._lock:
                cs.pending.add(req)
            self._queue.submit(req)
            self._requests += 1
        except Exception as e:
            # classified and serialized back — never kills the daemon
            ce = resilience.classified(e, site="serve.request")
            if req is not None:
                with self._lock:
                    cs.pending.discard(req)
                _obs.end(req.span, error=type(ce).__name__)
                req.span = 0
            self._errors += 1
            self._send(cs, protocol.error_header(ce, id=rid))
        return True

    # ----------------------------------------------------------- dispatching
    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            live = []
            try:
                live, dropped = self._queue.take_batch(
                    self.batch_max, self.batch_window, stop=self._stop,
                    paused=self._hold)
                for req in dropped:
                    if req.cancelled:
                        self._queue.release(req)
                        # no reply is owed, but the obs span opened at
                        # intake must still close
                        _obs.end(req.span, error="cancelled")
                        req.span = 0
                        continue
                    self._finish(req, error=resilience.DeadlineExpired(
                        f"serve: request {req.op!r} expired after "
                        "queueing — shed before dispatch",
                        site="serve.request"))
                if not live:
                    continue
                fusible = [r for r in live
                           if OPS.get(r.op) and OPS[r.op].batchable]
                solo = [[r] for r in live
                        if not (OPS.get(r.op) and OPS[r.op].batchable)]
                for group in ([fusible] if fusible else []) + solo:
                    self._exec_group(group)
                # BETWEEN batches — the only moment the dispatcher
                # provably owns no in-flight device work, once no
                # worker of any server runs — poll the mesh grow-back,
                # holding the ranks.  Never raises, cheap when off.
                if self._take_ranks(0):
                    try:
                        self._maybe_grow()
                    finally:
                        self._free_ranks()
            except Exception as e:  # the dispatcher must never die: a
                # dead dispatch loop turns every later request into a
                # silent hang — fail what we hold, classified, and keep
                # serving
                ce = resilience.classified(e, site="serve.flush")
                for req in live:
                    if req.result is None and req.error is None:
                        self._finish(req, error=ce)

    def _note_plan(self, plan) -> None:
        """Add one flushed region's graph captures, replays and
        in-order runs to ``stats()["plan"]``."""
        st = plan.stats()
        with self._lock:
            for k in self._plan:
                self._plan[k] += int(st.get(k, 0))

    def _exec_group(self, group) -> None:
        """Execute one compatible group: batchable ops coalesce into a
        single deferred-plan flush; errors are classified per request
        (poison-pill isolation) or for the group."""
        import dr_tpu_torch as dt
        batchable = OPS[group[0].op].batchable
        # first execution of each request: stamp the dispatch start and
        # sample queue-wait (a poison-pill re-run keeps the original
        # stamp and must not re-observe), emitting the retroactive
        # queue-wait span under the request's span
        t_exec = time.monotonic()
        for req in group:
            if req.t_exec is None:
                req.t_exec = t_exec
                qw_ms = (t_exec - req.t_submit) * 1e3
                _h_queue_wait.observe(qw_ms)
                _h_tenant("queue_wait", req.tenant).observe(qw_ms)
                if req.span:
                    _obs.complete("serve.queue_wait", req.t0_ns,
                                  cat="serve", parent=req.span)

        def run():
            # a fresh watchdog thread: it takes the device of the
            # ranks it runs on (the current device is per thread)
            cuda = [d for d in dt.devices() if d.type == "cuda"]
            if cuda:
                torch.cuda.set_device(cuda[0])
            # the injection site fires INSIDE the retried body: a
            # transient here recovers on the retry leg, in process
            _faults.fire("serve.flush", ops=len(group))
            finishers = []
            if batchable:
                with dt.deferred() as plan:
                    for r in group:
                        finishers.append(OPS[r.op].handler(r))
                # region exited: the whole group flushed as ONE plan
                self._note_plan(plan)
            else:
                for r in group:
                    finishers.append(OPS[r.op].handler(r))
            return [f() for f in finishers]

        def guarded():
            try:
                return resilience.retry(run, attempts=2, base=0.01,
                                        seed=0)
            finally:
                self._free_ranks()

        # one worker on the ranks at a time, across every server of the
        # process: a batch of another replica, or a flush abandoned at
        # its deadline that runs on, makes this batch wait (bounded by
        # the deadline, and by stop()); past it the batch fails
        # classified, never launched.  Taken here, the ranks are this
        # batch's worker's until it ends.
        if not self._take_ranks(self.flush_deadline):
            ce = resilience.DeadlineExpired(
                "serve: another batch (a flush abandoned at its deadline, "
                "or another server's) still runs on the ranks; this "
                "batch was not started", site="serve.flush")
            for req in group:
                self._finish(req, error=ce)
            return

        # the shared batch-flush span: every member request's span is
        # linked (args.links + flow finish events), so one client
        # request's trace tree reaches the fused dispatch it rode
        fid = _obs.begin("serve.batch_flush", cat="serve",
                         requests=len(group), batchable=batchable,
                         links=[r.span for r in group if r.span])
        for r in group:
            _obs.flow(r.span, "f")
        t_flush = time.monotonic()
        # a DeviceLostError inside the retried body triggers the elastic
        # shrink (resilience.retry, DR_GPU_ELASTIC=1): the batch REPLAYS
        # on the shrunken ranks — handlers rebuild their containers —
        # and no client is dropped.  The counter diff below turns a
        # mid-batch shrink into the serve chapter of the story.
        shrinks0 = _elastic.shrink_count()
        grows0 = _elastic.grow_count()
        nprocs0 = dt.nprocs()
        try:
            try:
                results = resilience.with_deadline(
                    guarded, self.flush_deadline, site="serve.flush",
                    dump=False)
            finally:
                # sample EVERY flush, failures and deadline overruns
                # included — the slowest flushes are exactly the ones
                # that fail
                _h_flush.observe((time.monotonic() - t_flush) * 1e3)
                _obs.end(fid)
                # shrink detection lives HERE, not on the success path:
                # a shrink whose REPLAY then fails still changed the
                # resident claim and must land in stats/markers — and
                # the poison-pill re-runs each re-sample, so a shrink is
                # counted exactly once
                shrunk = _elastic.shrink_count() - shrinks0
                if shrunk:
                    self._shrinks += shrunk
                    self.devices = list(dt.devices())
                    if self._pre_shrink_nprocs is None:
                        self._pre_shrink_nprocs = nprocs0
                    self._mark_degraded(
                        f"serve: device loss mid-batch; resident claim "
                        f"degraded to the {dt.nprocs()}-rank shrunken "
                        "mesh")
                # the symmetric diff: a grow-back riding this batch's
                # deferred-region exit changed the resident claim too
                grown = _elastic.grow_count() - grows0
                if grown:
                    self._grows += grown
                    self.devices = list(dt.devices())
                    self._note_grown()
            self._flushes += 1
            if batchable:
                self._batched += len(group)
                self._batch_hw = max(self._batch_hw, len(group))
            for req, res in zip(group, results):
                self._finish(req, result=res)
        except (resilience.RelayDownError, resilience.DeadlineExpired) \
                as e:
            # no route to move to: the group fails classified and the
            # daemon serves on the same ranks.  A flush past its
            # watchdog is never replayed: its abandoned worker may still
            # be launching on them.
            ce = resilience.classified(e, site="serve.flush")
            for req in group:
                self._finish(req, error=ce)
        except Exception as e:
            ce = resilience.classified(e, site="serve.flush")
            if isinstance(ce, resilience.ProgramError) and len(group) > 1:
                # poison-pill isolation: a deterministic error in ONE
                # request must not fail its batchmates — re-run each
                # request alone so only the culprit sees the error
                for req in group:
                    self._exec_group([req])
                return
            for req in group:
                self._finish(req, error=ce)

    def _await_workers(self, timeout) -> bool:
        """Wait up to ``timeout`` s for every batch worker of this
        server to end; True if none runs."""
        with _RANKS.cv:
            _RANKS.cv.wait_for(lambda: self._workers == 0, timeout)
            return self._workers == 0

    def _take_ranks(self, timeout) -> bool:
        """Wait up to ``timeout`` s (or until this daemon stops) for the
        ranks to be free of every server's batch worker, and take them:
        True once this server's worker is counted on them."""
        with _RANKS.cv:
            _RANKS.cv.wait_for(
                lambda: _RANKS.busy == 0 or self._stop.is_set(), timeout)
            if _RANKS.busy:
                return False
            _RANKS.busy += 1
            self._workers += 1
            return True

    def _free_ranks(self) -> None:
        with _RANKS.cv:
            _RANKS.busy -= 1
            self._workers -= 1
            _RANKS.cv.notify_all()

    def _maybe_grow(self) -> None:
        """Mesh grow-back poll, BETWEEN batches on the dispatch thread:
        a claim the elastic layer shrank polls the module supervisor for
        returned ranks (``elastic.maybe_grow``, also reached at each
        batch's deferred-region exit).  Never raises — a failed probe
        or grow leaves the claim where it was."""
        rep = _elastic.maybe_grow()
        if rep is not None:
            import dr_tpu_torch as dt
            self._grows += 1
            self.devices = list(dt.devices())
            self._note_grown()

    def _note_grown(self) -> None:
        """A mesh grow-back landed: clear the degraded flag only once
        the claim is back to its PRE-SHRINK size — a partial recovery
        keeps reporting degraded while the supervisor probes for the
        rest."""
        import dr_tpu_torch as dt
        if self._pre_shrink_nprocs is not None and \
                dt.nprocs() < self._pre_shrink_nprocs:
            return
        self._pre_shrink_nprocs = None
        self.degraded = None

    # ------------------------------------------------------------- replies
    def _finish(self, req: Request, result=None, error=None) -> None:
        self._finishing += 1
        try:
            self._finish_inner(req, result, error)
        finally:
            self._finishing -= 1

    def _finish_inner(self, req: Request, result=None,
                      error=None) -> None:
        self._queue.release(req)
        req.finish(result=result, error=error)
        if req.t_exec is not None:
            # service = dispatch start -> reply posted (shed requests
            # never executed, so they carry no service sample)
            sv_ms = (time.monotonic() - req.t_exec) * 1e3
            _h_service.observe(sv_ms)
            _h_tenant("service", req.tenant).observe(sv_ms)
        if req.span:
            _obs.event("serve.reply", cat="serve", parent=req.span,
                       rid=str(req.rid),
                       outcome=(type(error).__name__ if error else "ok"))
            _obs.end(req.span,
                     **({"error": type(error).__name__} if error
                        else {}))
            req.span = 0
        if error is not None:
            self._errors += 1
        cs = req.conn
        if cs is None:
            return  # direct in-process submit: the waiter reads slots
        with self._lock:
            cs.pending.discard(req)
        if req.cancelled or cs.closed:
            return
        if error is not None:
            self._send(cs, protocol.error_header(error, id=req.rid))
        else:
            extra, arrays = result
            hdr = {"ok": True, "id": req.rid, **extra}
            staged: list = []
            arrays = self._stage_reply(req, hdr, arrays, staged)
            self._send(cs, hdr, arrays)
            if staged and cs.closed:
                # the connection died between the closed-check above
                # and the send: its disconnect teardown may have run
                # release_owner BEFORE our put landed, so the staged
                # slots would leak — release them here; whichever party
                # ran second reads "stale"
                ar = self._arena
                for h in staged:
                    try:
                        if ar is not None:
                            ar.release(h)
                    except resilience.ResilienceError:
                        pass  # the teardown's release won the race

    def _stage_reply(self, req: Request, hdr: dict, arrays,
                     staged: list):
        """Route reply payloads through the arena when the client
        accepts it (``arena_ok``) and the payload clears the
        ``DR_GPU_SERVE_ARENA_MIN_BYTES`` floor; small results and an
        exhausted arena stay on the inline wire.  Reply slots are owned
        by the client's connection: released by its next frame's
        piggyback, or wholesale at disconnect."""
        if not (req.arena_ok and self._arena is not None and arrays):
            return arrays
        entries, inline, used = [], [], False
        for a in arrays:
            a = np.asarray(a)
            if a.nbytes >= self.arena_min:
                try:
                    h = self._arena.put(_arena.npy_bytes(a),
                                        owner=req.conn)
                    entries.append(h)
                    staged.append(h)
                    used = True
                    continue
                except resilience.TransientBackendError:
                    _arena.note_fallback(
                        "reply arena exhausted; inline wire")
            entries.append(None)
            inline.append(a)
        if not used:
            return arrays
        hdr["arena_results"] = entries
        return inline

    def _send(self, cs: _Conn, header: dict, arrays=()) -> None:
        try:
            with cs.lock:
                # the write is bounded by the socket's SO_SNDTIMEO (set
                # at accept)
                protocol.send_frame(cs.sock, header, arrays)
            if header.get("ok"):
                self._replies += 1
        except OSError:
            # client vanished (or stopped reading) between dispatch and
            # reply: cancel cleanly; the resident claim is untouched.  A
            # send past SO_SNDTIMEO raises EAGAIN, an OSError.  Close the
            # socket too so the reader thread unblocks.
            cs.closed = True
            self._cancelled += 1
            try:
                cs.sock.close()
            except OSError:  # pragma: no cover - already closed
                pass

    # ------------------------------------------------------------- stories
    def stats(self) -> dict:
        """The JAX daemon's stats keys (``restarts`` stays 0 and the
        route is the requested one), plus ``plan`` (the flushed regions'
        graph captures, replays and in-order runs), ``arena_fallbacks``
        (inline-wire fallbacks counted in this process), and ``notes``
        (the latest notes, oldest first)."""
        q = self._queue.stats()
        extra = {}
        if self._arena is not None:
            extra["arena"] = self._arena.stats()
        elif self._arena_unavailable is not None:
            extra["arena_unavailable"] = self._arena_unavailable
        extra["resident"] = self._resident.stats()
        if self._journal is not None:
            extra["journal"] = {**self._journal.stats(),
                                "errors": self._journal_errors}
        with self._lock:
            plan = dict(self._plan)
            notes = list(self._notes)
        return {"requests": self._requests, "replies": self._replies,
                **extra,
                "errors": self._errors, "cancelled": self._cancelled,
                "accept_drops": self._accept_drops,
                "flushes": self._flushes,
                "batched_requests": self._batched,
                "batch_hw": self._batch_hw,
                "restarts": self._restarts,
                "shrinks": self._shrinks,
                "grows": self._grows,
                "drains": self._drains,
                "draining": self._draining.is_set(),
                "drain_rejects": self._drain_rejects,
                "route": {"requested": self.requested_route,
                          "current": self._route},
                "degraded": self.degraded,
                "plan": plan,
                "arena_fallbacks": _arena.fallbacks(),
                "notes": notes,
                # the obs metrics snapshot rides the stats wire op: the
                # daemon-side queue-wait / service / flush histograms,
                # counters, and dispatch counts — JSON-serializable by
                # construction
                "obs": _obs.snapshot(), **q}

    def _mark_degraded(self, reason: str) -> None:
        self.degraded = reason
        self._publish_markers()

    def _publish_markers(self) -> None:
        """Publish the serve chapter of the session's story as env
        markers (``resilience.session_story`` folds them into its
        ``serve`` chapter)."""
        if self.degraded:
            os.environ["_DR_GPU_SERVE_DEGRADED"] = self.degraded
        os.environ["_DR_GPU_SERVE_QUEUE_DEPTH"] = \
            str(self._queue.depth_hw)
        os.environ["_DR_GPU_SERVE_SHED"] = str(self._queue.shed)
        os.environ["_DR_GPU_SERVE_RESTARTS"] = str(self._restarts)
