"""Thin client for the serving daemon (counterpart of
``dr_tpu/serve/client.py``).

A client owns NO device claim: it speaks the length-prefixed JSON/npy
protocol over the daemon's Unix-domain socket, one request in flight
per connection (concurrency = more connections: a load generator runs
one Client per worker thread).  Every failure surfaces
as a CLASSIFIED taxonomy error:

* nothing listening at the socket → ``RelayDownError`` (the daemon is
  this client's relay);
* the daemon dropped the connection / a torn reply frame / a socket
  timeout → ``TransientBackendError`` (reconnect and resubmit);
* a serialized daemon error → re-raised as the class the daemon
  caught (``ServerOverloaded``, ``DeadlineExpired``, ``DeviceOOM``,
  ``ProgramError``, …) via ``protocol.raise_error``.

Retry policy (``retries`` / ``DR_GPU_SERVE_CLIENT_RETRIES``): with more than one attempt armed, transient failures and
``ServerOverloaded`` rejections resubmit through the shared
seeded-backoff ``resilience.retry`` — bounded attempts, deadline-aware
(a retry that would land past the request's ``deadline_s`` is not
taken), reconnecting first when the failure invalidated the
connection.  The default is ONE attempt: an overload rejection is
information the caller may want to act on, so backoff is opt-in.
``RelayDownError`` (nothing listening) never retries: that is a
dead daemon, not a blip.  Every retry draws from the process-wide
shared token budget (``DR_GPU_SERVE_RETRY_BUDGET``): a fleet-wide failure drains the bucket once, fleet-wide, and
then fails fast classified instead of feeding a retry storm.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional

import numpy as np

from ..utils import resilience
from ..utils.env import env_float, env_int
from . import arena as _arena
from . import protocol

__all__ = ["Client", "Ref", "shared_retry_budget", "reset_retry_budget"]

#: control ops that never stage payloads through the arena (they have
#: none, or they ARE the arena's own lease/release round trips)
_CONTROL_OPS = frozenset(
    ("ping", "stats", "shutdown", "drain", "arena_alloc",
     "arena_release"))

# ---------------------------------------------------------------------------
# shared retry budget
# ---------------------------------------------------------------------------
# ONE bucket per process, drawn on by every Client retry: without it,
# per-request retries multiply across clients into a retry storm that
# amplifies exactly the overload it is retrying through.

_budget_lock = threading.Lock()
_shared_budget: Optional[resilience.TokenBudget] = None


def shared_retry_budget() -> resilience.TokenBudget:
    """The process-wide retry :class:`~..utils.resilience.TokenBudget`
    (capacity ``DR_GPU_SERVE_RETRY_BUDGET``, refilled by
    ``DR_GPU_SERVE_RETRY_RATIO`` of a token per successful request)."""
    global _shared_budget
    with _budget_lock:
        if _shared_budget is None:
            _shared_budget = resilience.TokenBudget(
                env_int("DR_GPU_SERVE_RETRY_BUDGET", 8, floor=0),
                env_float("DR_GPU_SERVE_RETRY_RATIO", 0.1))
        return _shared_budget


def reset_retry_budget() -> None:
    """Drop the shared bucket (refilled lazily from env) — the
    between-test hygiene hook (serve.reset)."""
    global _shared_budget
    with _budget_lock:
        _shared_budget = None


class Ref:
    """A resident-container reference: pass in
    place of an array operand and the daemon substitutes the tenant's
    cached container — no payload on the wire, no container rebuild::

        c.put("features", x)
        c.reduce(Ref("features"))     # zero-copy repeat op
    """

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = str(name)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Ref({self.name!r})"


class Client:
    """Synchronous connection to a serving daemon.

    ``timeout`` bounds every socket operation (default: the daemon's
    default request deadline + slack) — a wedged daemon costs a
    classified timeout, never an eternal hang."""

    def __init__(self, path: Optional[str] = None, *,
                 timeout: Optional[float] = None,
                 tenant: str = "default",
                 retries: Optional[int] = None,
                 arena: Optional[bool] = None,
                 budget: Optional[resilience.TokenBudget] = None):
        from .daemon import default_socket_path
        self.path = path or default_socket_path()
        self.tenant = tenant
        self.retries = max(1, env_int("DR_GPU_SERVE_CLIENT_RETRIES", 1)
                           if retries is None else int(retries))
        # every retry draws from ONE shared process-wide token bucket
        # unless the caller threads its own
        self._budget = (shared_retry_budget() if budget is None
                        else budget)
        self._next_id = 0
        self._timeout = (env_float("DR_GPU_SERVE_DEADLINE", 30.0) + 10.0
                         if timeout is None else timeout)
        self._sock = None
        # shared-memory arena: None = auto (use
        # it when the daemon advertises one and a payload clears the
        # min-bytes floor), False = inline wire always.  Attachment is
        # lazy — a ping discovers the segment on first need.
        self._arena_want = (env_int("DR_GPU_SERVE_ARENA", 1,
                                    floor=0) != 0
                            if arena is None else bool(arena))
        self._arena_min = env_int("DR_GPU_SERVE_ARENA_MIN_BYTES",
                                  1 << 16)
        self._arena: Optional[_arena.ClientArena] = None
        self._arena_state = "unknown"  # unknown | on | off
        self._pending_release: list = []
        # slot-lease cache: granted request
        # leases are KEPT across requests (the ``keep`` wire marker)
        # and reused for same-shape payloads — the per-request
        # ``arena_alloc`` round trip disappears on steady traffic.
        # Keyed by the lease's aligned byte capacity; bounded by
        # DR_GPU_SERVE_LEASE_CACHE slots (0 disables), excess leases
        # release by piggyback.  The cache drops whenever the
        # connection does (the daemon's disconnect teardown frees the
        # owner's slots, so a held handle's generation may bump) and
        # on any ``arena.map``-classified reply (a stale-generation
        # handle must never be offered twice).
        self._lease_cap = env_int("DR_GPU_SERVE_LEASE_CACHE", 8,
                                  floor=0)
        self._lease_cache: dict = {}
        self.lease_hits = 0
        self.lease_misses = 0
        self._connect()
        if arena:  # explicit opt-in attaches eagerly (big REPLIES
            # can ride the arena even when no request payload does)
            self._ensure_arena()

    def _connect(self) -> None:
        """(Re)open the daemon connection; classified on failure.  A
        refused/absent socket is ``RelayDownError`` — the daemon is
        this client's relay, and retrying a dead one burns budget."""
        self._broken = None  # set to a reason once the conn desyncs
        # reply slots owed from the OLD connection free at the
        # daemon's disconnect teardown — releasing them on a fresh
        # connection would double-free a recycled slot
        self._pending_release = []
        # held request leases died with the old connection too (owner
        # teardown freed them; the slot ids may already be re-leased
        # at a bumped generation)
        self._lease_cache = {}
        # re-arm arena discovery: a reconnect after an invalidation
        # (whose close() detached the segment) must not leave a
        # long-lived retrying client on the inline wire forever
        if self._arena is None:
            self._arena_state = "unknown"
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(self._timeout)
        try:
            self._sock.connect(self.path)
        except (ConnectionRefusedError, FileNotFoundError) as e:
            self._sock.close()
            self._sock = None
            raise resilience.RelayDownError(
                f"serve: no daemon listening at {self.path} ({e!r})",
                site="serve.request")
        except OSError as e:
            self._sock.close()
            self._sock = None
            raise resilience.classified(
                f"serve: cannot connect to {self.path}: {e!r}",
                site="serve.request")

    # ------------------------------------------------------------- plumbing
    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        # held leases die with the connection (owner teardown)
        self._lease_cache = {}
        if self._arena is not None:
            self._arena.close()
            self._arena = None
            self._arena_state = "off"
        if self._sock is None:
            return
        try:
            self._sock.close()
        except OSError:  # pragma: no cover - already closed
            pass

    def _invalidate(self, reason: str) -> None:
        self._broken = reason
        self.close()

    def request(self, op: str, arrays=(), params: Optional[dict] = None,
                *, deadline_s: Optional[float] = None,
                tenant: Optional[str] = None):
        """One request/reply round trip.  Returns the scalar result,
        the single result array, a list of arrays, or the raw reply
        header (control ops); raises the daemon's classified error.

        A timeout INVALIDATES the connection: the daemon's late reply
        would otherwise desynchronize the stream (the next request
        would read it as its own answer).  With ``retries`` armed the
        policy reconnects and resubmits through ``resilience.retry``
        (seeded backoff, overloads included, deadline-aware); at the
        default single attempt, reconnect with a fresh Client."""
        if self.retries <= 1:
            out = self._request_once(op, arrays, params,
                                     deadline_s=deadline_s,
                                     tenant=tenant)
            self._budget.note_success()
            return out

        def attempt():
            if self._broken or self._sock is None:
                self._connect()  # RelayDownError here is final: no
                # daemon means resubmission cannot land
            return self._request_once(op, arrays, params,
                                      deadline_s=deadline_s,
                                      tenant=tenant)

        out = resilience.retry(
            attempt, attempts=self.retries,
            retry_on=(resilience.TransientBackendError,
                      resilience.ServerOverloaded),
            deadline_s=deadline_s, budget=self._budget)
        self._budget.note_success()
        return out

    # ------------------------------------------------------- arena plumbing
    def _ensure_arena(self) -> None:
        """Discover + attach the daemon's arena once (lazy: the first
        payload that clears the min-bytes floor pays the one ping).
        Any failure turns the arena OFF for this client: inline wire,
        full function, counted fallback."""
        if self._arena_state != "unknown":
            return
        self._arena_state = "off"
        try:
            info = self._request_once("ping").get("arena")
            if info:
                self._arena = _arena.ClientArena(str(info["name"]),
                                                 int(info["size"]))
                self._arena_state = "on"
        except resilience.ResilienceError:
            raise  # connection-level failures are real errors
        except Exception as e:
            _arena.note_fallback(f"client attach failed ({e!r}); "
                                 "inline wire")

    def _lease_size(self, nbytes: int) -> int:
        """The aligned capacity a lease of ``nbytes`` rounds up to —
        the cache key (same-shape payloads land on the same size)."""
        return max(_arena.ALIGN,
                   (int(nbytes) + _arena.ALIGN - 1)
                   // _arena.ALIGN * _arena.ALIGN)

    def _cache_lease(self, handle: dict) -> None:
        """Return a still-held lease to the cache, or queue its
        release by piggyback when the cache is full."""
        if self._lease_cap > 0 and sum(
                len(v) for v in self._lease_cache.values()) \
                < self._lease_cap:
            self._lease_cache.setdefault(int(handle["nbytes"]),
                                         []).append(handle)
        else:
            self._pending_release.append(
                {"slot": handle["slot"],
                 "generation": handle["generation"]})

    def _drop_lease_cache(self) -> None:
        """Invalidate every held lease COLD — no releases queued (a
        stale release would poison the next request's piggyback);
        the daemon's disconnect teardown reaps the slots.  Queued
        reply releases drop too: a generation bump that invalidated a
        held lease may equally have invalidated an owed reply slot,
        and one stale handle in the piggyback fails the whole next
        request."""
        self._lease_cache = {}
        self._pending_release = []

    def _stage_arena(self, op, arrays):
        """Split a request's payloads between the arena and the inline
        wire: big payloads lease slots (one small ``arena_alloc``
        round trip), write their npy bytes ONCE into shared memory,
        and ride the header as handles; everything else stays inline.
        A cached lease of the right capacity skips the alloc round
        trip entirely (the ``keep`` discipline above).  Any arena
        failure (exhaustion transient, overload) falls back to
        fully-inline for THIS request.  Returns ``(inline_arrays,
        entries, held)`` — ``held`` are the leases to re-cache once
        the exchange settles."""
        if (op in _CONTROL_OPS or not self._arena_want
                or not arrays):
            return arrays, None, []
        sizes = [np.asarray(a).nbytes for a in arrays]
        big = [i for i, nb in enumerate(sizes)
               if nb >= self._arena_min]
        if not big:
            return arrays, None, []
        self._ensure_arena()
        if self._arena is None:
            return arrays, None, []
        payloads = {i: _arena.npy_bytes(arrays[i]) for i in big}
        handles = {}
        for i in big:
            pool = self._lease_cache.get(
                self._lease_size(len(payloads[i])))
            if pool:
                handles[i] = pool.pop()
                self.lease_hits += 1
        missing = [i for i in big if i not in handles]
        if missing:
            self.lease_misses += len(missing)
            try:
                slots = self._request_once(
                    "arena_alloc",
                    params={"nbytes": [len(payloads[i])
                                       for i in missing]})["slots"]
            except (resilience.TransientBackendError,
                    resilience.ServerOverloaded) as e:
                _arena.note_fallback(
                    f"lease failed ({type(e).__name__}); "
                    "inline wire for this request")
                for h in handles.values():  # reused leases survive
                    self._cache_lease(h)
                return arrays, None, []
            handles.update(zip(missing, slots))
        entries = [None] * len(arrays)
        keep = self._lease_cap > 0
        for i in big:
            entries[i] = self._arena.write(handles[i], payloads[i])
            if keep:
                entries[i]["keep"] = True
        inline = [a for i, a in enumerate(arrays) if i not in set(big)]
        # cache disabled: the daemon releases at intake (no keep), so
        # nothing is held past this request
        return inline, entries, list(handles.values()) if keep else []

    def _read_reply_arena(self, reply, rarrays):
        """Merge a reply's inline payloads with its arena results; the
        mapped handles queue for release (piggybacked on the next
        frame — the daemon's disconnect teardown covers the rest)."""
        entries = reply.get("arena_results")
        if entries is None:
            return rarrays
        if self._arena is None:
            raise resilience.ProgramError(
                "serve: daemon sent arena results to a client without "
                "an attached arena", site="arena.map")
        it = iter(rarrays)
        merged = []
        for e in entries:
            if e is None:
                merged.append(next(it))
            else:
                merged.append(self._arena.read(e))
                self._pending_release.append(
                    {"slot": e["slot"], "generation": e["generation"]})
        return merged

    def _request_once(self, op, arrays=(), params=None, *,
                      deadline_s=None, tenant=None, _stage=True):
        if self._broken:
            raise resilience.TransientBackendError(
                f"serve: connection invalidated ({self._broken}); "
                "reconnect to resubmit", site="serve.request")
        header = {"op": op, "params": params or {},
                  "tenant": tenant or self.tenant}
        orig = list(arrays)
        arrays = list(orig)
        if any(isinstance(a, Ref) for a in arrays):
            header["refs"] = [a.name if isinstance(a, Ref) else None
                              for a in arrays]
            arrays = [a for a in arrays if not isinstance(a, Ref)]
        if _stage:
            arrays, entries, held = self._stage_arena(op, arrays)
        else:
            entries, held = None, []
        if entries is not None:
            header["arena"] = entries
        if self._arena is not None and op not in _CONTROL_OPS:
            header["arena_ok"] = True
        if self._pending_release and op != "arena_alloc":
            header["arena_release"] = self._pending_release
            self._pending_release = []
        self._next_id += 1
        rid = self._next_id
        header["id"] = rid
        if deadline_s is not None:
            header["deadline_s"] = deadline_s
        try:
            return self._exchange(op, header, arrays, rid, held)
        except resilience.TransientBackendError as e:
            # a daemon-side transient AT MAP INTAKE (a cached lease
            # skipped the alloc round trip, so the fault lands there
            # now): the arena is never a correctness dependency, so
            # this request is resent fully
            # inline; the held leases stay valid (keep discipline,
            # nothing released) and re-cache in the finally below
            if (entries is not None and _stage and not self._broken
                    and getattr(e, "site", "") == "arena.map"):
                _arena.note_fallback(
                    "daemon-side map transient; inline wire for "
                    "this request")
                return self._request_once(op, orig, params,
                                          deadline_s=deadline_s,
                                          tenant=tenant, _stage=False)
            raise
        finally:
            # the exchange settled (reply, error, or invalidation):
            # still-held leases go back to the cache while the
            # connection stands; a broken connection's leases died
            # with it (owner teardown) and drop cold
            if held and not self._broken and self._sock is not None:
                for h in held:
                    self._cache_lease(h)

    def _exchange(self, op, header, arrays, rid, held):
        try:
            protocol.send_frame(self._sock, header, arrays)
            reply, rarrays = protocol.recv_frame(self._sock)
        except resilience.ResilienceError:
            # torn/oversized/malformed mid-exchange: the stream
            # position is unknown (e.g. a rejected payload's bytes are
            # still unread), so the connection cannot be trusted for
            # another request
            self._invalidate("classified protocol error mid-exchange")
            raise
        except socket.timeout:
            self._invalidate(f"request {op!r} timed out")
            raise resilience.TransientBackendError(
                f"serve: request {op!r} timed out waiting for the "
                "daemon", site="serve.request")
        except OSError as e:
            # the connection died under the exchange (broken pipe /
            # reset when the daemon stopped): the same retryable
            # class as a torn wire frame — classified() would text-
            # match "broken pipe" into the deterministic bucket
            self._invalidate("socket error mid-request")
            raise resilience.TransientBackendError(
                f"serve: connection to {self.path} failed mid-request: "
                f"{e!r}", site="serve.request")
        if reply is None:
            raise resilience.TransientBackendError(
                "serve: daemon closed the connection before a reply "
                "(socket closed)", site="serve.request")
        if reply.get("id") not in (None, rid):
            # a reply for an EARLIER request (stream desync): refuse to
            # hand one request's data back as another's answer
            self._invalidate(
                f"reply id {reply.get('id')} != request id {rid}")
            raise resilience.TransientBackendError(
                "serve: reply stream desynchronized (stale reply id) — "
                "open a fresh Client", site="serve.request")
        if not reply.get("ok", False):
            try:
                protocol.raise_error(reply)
            except resilience.ProgramError as e:
                if held and getattr(e, "site", "") == "arena.map":
                    # generation-bump defense: a stale-handle map is
                    # the ONE way a held lease can be wrong — drop
                    # every cached lease cold (no releases: a stale
                    # release would poison the next request) and let
                    # the disconnect teardown reap the slots
                    self._drop_lease_cache()
                    held.clear()
                raise
        rarrays = self._read_reply_arena(reply, rarrays)
        if "scalar" in reply:
            return float(reply["scalar"])
        if rarrays:
            return rarrays[0] if len(rarrays) == 1 else rarrays
        return reply

    # ----------------------------------------------------------- op helpers
    def ping(self) -> dict:
        return self.request("ping")

    def stats(self) -> dict:
        """The daemon's full stats block (one ``stats`` wire op):
        request/reply/error counters, queue accounting, and the
        ``obs`` metrics snapshot: the daemon-side queue-wait /
        service / flush histograms."""
        return self.request("stats")["stats"]

    def metrics(self) -> dict:
        """Just the parsed observability snapshot from the ``stats``
        wire op (``stats()["obs"]``): counters, gauges, and the
        per-request latency histograms the daemon samples."""
        return self.stats().get("obs", {})

    def route(self) -> dict:
        """The daemon's serving route, ``{"requested": "cpu"|"device",
        "current": ...}``.  A daemon of this package serves on the route
        it was asked for and never moves off it: ``current`` equals
        ``requested`` (``stats()["restarts"]`` stays 0); a mesh that
        shrank and grew back counts in ``stats()["shrinks"]`` and
        ``stats()["grows"]``."""
        return self.stats()["route"]

    def shutdown(self) -> dict:
        return self.request("shutdown")

    def drain(self) -> dict:
        """Ask the daemon to drain gracefully: it stops
        admitting, finishes in-flight batches, flushes the resident
        journal, and exits.  Returns the acknowledgement; the daemon
        closes this connection once the drain is scheduled."""
        return self.request("drain")

    # ------------------------------------------------- resident cache
    def put(self, name: str, x, **kw) -> dict:
        """Park ``x`` as this tenant's resident container ``name`` on
        the daemon — built once, referenced by :class:`Ref` in later
        ops (zero payload, no rebuild).  Returns ``{"handle", "tag",
        "bytes", "cached"}``; ``cached`` True means identical content
        was already resident."""
        return self.request("put", [x], {"name": str(name)}, **kw)

    def get(self, name: str, **kw) -> np.ndarray:
        """Read a resident container back."""
        return self.request("get", params={"name": str(name)}, **kw)

    def drop(self, name: str, **kw) -> dict:
        """Evict a resident container (idempotent — the reply says
        whether anything was dropped)."""
        return self.request("drop", params={"name": str(name)}, **kw)

    def arena_active(self) -> bool:
        """True once this client is attached to the daemon's
        shared-memory arena; False while its bytes take the inline
        wire (no arena on the daemon, or a failed attach, counted in
        ``serve.arena.fallbacks``)."""
        return self._arena is not None

    def fill(self, n: int, value: float = 0.0, **kw) -> np.ndarray:
        return self.request("fill", params={"n": int(n),
                                            "value": float(value)}, **kw)

    def scale(self, x, a: float = 1.0, b: float = 0.0, **kw) -> np.ndarray:
        return self.request("scale", [x], {"a": float(a),
                                           "b": float(b)}, **kw)

    def reduce(self, x, **kw) -> float:
        return self.request("reduce", [x], **kw)

    def dot(self, x, y, **kw) -> float:
        return self.request("dot", [x, y], **kw)

    def scan(self, x, **kw) -> np.ndarray:
        return self.request("scan", [x], **kw)

    def sort(self, x, descending: bool = False, **kw) -> np.ndarray:
        return self.request("sort", [x],
                            {"descending": bool(descending)}, **kw)

    # ----------------------------------------------- relational layer
    def join(self, lk, lv, rk, rv, how: str = "inner",
             fill: float = 0.0, capacity=None, **kw):
        """Sort-merge join on the daemon; returns the TRIMMED
        ``[keys, left_values, right_values]`` row arrays.  A result
        beyond ``capacity`` (default ``4 * (len(lk) + len(rk))``)
        raises the daemon's classified capacity ``ProgramError``."""
        params = {"how": str(how), "fill": float(fill)}
        if capacity is not None:
            params["capacity"] = int(capacity)
        return self.request("join", [lk, lv, rk, rv], params, **kw)

    def groupby(self, keys, values, agg: str = "sum", **kw):
        """Group-by aggregate; returns trimmed
        ``[group_keys, aggregates]``."""
        return self.request("groupby", [keys, values],
                            {"agg": str(agg)}, **kw)

    def unique(self, x, **kw) -> np.ndarray:
        """Sorted distinct values (trimmed)."""
        return self.request("unique", [x], **kw)

    def top_k(self, x, k: int, largest: bool = True, **kw):
        """The k best elements; returns ``[values, indices]``
        best-first.  Batches into the shared deferred flush."""
        return self.request("topk", [x], {"k": int(k),
                                          "largest": bool(largest)},
                            **kw)

    def histogram(self, x, bins: int, lo: float, hi: float, **kw) \
            -> np.ndarray:
        """Fixed-bin histogram counts over ``[lo, hi]``.  Batches
        into the shared deferred flush."""
        return self.request("histogram", [x],
                            {"bins": int(bins), "lo": float(lo),
                             "hi": float(hi)}, **kw)
