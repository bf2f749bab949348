"""Admission control + weighted-fair scheduling for the serving daemon
(counterpart of ``dr_tpu/serve/queue.py``).

The queue is the daemon's overload contract , and
its ISOLATION contract too:

* **bounded depth** — once ``depth`` requests are queued, submission
  raises a classified :class:`ServerOverloaded` rejection, never a
  hang or an unbounded backlog;
* **per-tenant in-flight caps** — one chatty client cannot monopolize
  the resident claim: a tenant at its cap is rejected while others
  keep being admitted;
* **deadline shedding** — every request carries an absolute expiry;
  :meth:`AdmissionQueue.take_batch` returns expired (and cancelled)
  requests separately so the dispatcher sheds them BEFORE paying a
  device dispatch for work nobody is waiting on;
* **weighted-fair pop** — requests queue per tenant and
  :meth:`take_batch` drains them by deficit-weighted round-robin
  (``DR_GPU_SERVE_TENANT_WEIGHTS``, e.g. ``"gold:4,free:1"``;
  unlisted tenants weigh 1): each ring turn banks a tenant's weight
  into its deficit and pops one request per whole unit, so a heavy
  tenant's burst dilates its OWN queue-wait while a light tenant's
  requests keep landing near the front of every batch.  Order stays
  FIFO within a tenant; a tenant whose queue drains leaves the ring
  (no banking while idle — standard DRR).

Transport-free on purpose: a :class:`Request` is just the op + its
operands + completion slots (an Event the submitter can wait on); the
daemon attaches connections and replies, tests submit directly.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Tuple

from ..obs import metrics as _metrics
from ..obs import recorder as _rec
from ..utils.env import env_str
from ..utils.resilience import ServerOverloaded

__all__ = ["Request", "AdmissionQueue", "parse_weights"]

#: always-live overload/shed counters (the obs metrics registry):
#: request-rate events the serve ``stats`` op reports on every run,
#: traced or not
_c_rejected = _metrics.counter("serve.rejected")
_c_shed = _metrics.counter("serve.shed")


class Request:
    """One admitted unit of work.

    ``expiry`` is an absolute ``time.monotonic()`` deadline (None =
    never sheds).  ``cancelled`` is set by the daemon when the
    submitting client disconnects mid-request — the dispatcher skips
    the work and the reply.  ``finish`` posts the result/error and
    wakes any in-process waiter."""

    __slots__ = ("op", "params", "arrays", "tenant", "expiry", "conn",
                 "rid", "cancelled", "result", "error", "_done",
                 "t_submit", "t_exec", "t0_ns", "span", "server",
                 "arena_ok")

    def __init__(self, op: str, params: Optional[dict], arrays,
                 tenant: str = "default",
                 deadline_s: Optional[float] = None, rid=None):
        self.op = op
        self.params = dict(params or {})
        self.arrays = list(arrays or [])
        self.tenant = tenant
        self.expiry = (None if deadline_s is None
                       else time.monotonic() + float(deadline_s))
        self.conn = None
        self.rid = rid
        self.cancelled = False
        self.result = None
        self.error = None
        self._done = threading.Event()
        # observability: queue-wait = dispatch start -
        # t_submit; t_exec is set once by the dispatcher; span is the
        # request's obs span id (0 untraced) and t0_ns the
        # recorder-clock creation time for the retroactive
        # queue-wait span
        self.t_submit = time.monotonic()
        self.t_exec = None
        self.t0_ns = _rec.now()
        self.span = 0
        # daemon-side attachments (None for direct test submits): the
        # owning Server (resident-cache handlers reach their store
        # through it) and whether the client accepts arena replies
        self.server = None
        self.arena_ok = False

    def expired(self) -> bool:
        return self.expiry is not None and time.monotonic() > self.expiry

    def finish(self, result=None, error=None) -> None:
        self.result = result
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def __repr__(self):  # pragma: no cover - debugging aid
        state = ("done" if self._done.is_set()
                 else "cancelled" if self.cancelled else "pending")
        return f"Request({self.op!r}, tenant={self.tenant!r}, {state})"


def parse_weights(spec: str) -> dict:
    """Parse ``DR_GPU_SERVE_TENANT_WEIGHTS`` (``"tenant:weight,..."``)
    into ``{tenant: weight}``.  Tolerant like every env parse: a
    malformed entry is skipped, weights floor at a small positive
    value (a zero/negative weight would starve the tenant outright —
    the opposite of what this queue exists to prevent)."""
    out: dict = {}
    for raw in (spec or "").replace(";", ",").split(","):
        entry = raw.strip()
        if not entry or ":" not in entry:
            continue
        tenant, w = entry.rsplit(":", 1)
        try:
            out[tenant.strip()] = max(float(w), 1e-3)
        except ValueError:
            continue
    return out


class AdmissionQueue:
    """Bounded per-tenant queues behind a deficit-weighted round-robin
    pop, with per-tenant in-flight accounting.

    A tenant's in-flight count covers queued AND executing requests;
    :meth:`release` (called by the dispatcher as each request finishes)
    returns the slot.  Counters (``depth_hw``, ``shed``, ``rejected``,
    ``admitted``) feed the daemon's stats and the serve degradation
    markers."""

    def __init__(self, depth: int, tenant_cap: int,
                 weights: Optional[dict] = None):
        self.depth = int(depth)
        self.tenant_cap = int(tenant_cap)
        self.weights = dict(parse_weights(
            env_str("DR_GPU_SERVE_TENANT_WEIGHTS"))
            if weights is None else weights)
        self._cv = threading.Condition()
        self._subq: dict = {}           # tenant -> deque (FIFO within)
        self._ring: deque = deque()     # active tenants, DRR order
        self._deficit: dict = {}        # tenant -> banked pop credit
        self._qn = 0                    # total queued
        self._inflight: dict = {}
        self.depth_hw = 0
        self.shed = 0
        self.rejected = 0
        self.admitted = 0

    def __len__(self) -> int:
        with self._cv:
            return self._qn

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    def submit(self, req: Request) -> None:
        """Admit ``req`` or raise :class:`ServerOverloaded` (classified,
        site ``serve.request``) — overload is a typed rejection the
        client can act on, never a hang."""
        with self._cv:
            if self._qn >= self.depth:
                self.rejected += 1
                _c_rejected.add()
                raise ServerOverloaded(
                    f"serve: queue depth cap {self.depth} reached — "
                    "back off and resubmit", site="serve.request")
            if self._inflight.get(req.tenant, 0) >= self.tenant_cap:
                self.rejected += 1
                _c_rejected.add()
                raise ServerOverloaded(
                    f"serve: tenant {req.tenant!r} is at its in-flight "
                    f"cap ({self.tenant_cap})", site="serve.request")
            q = self._subq.get(req.tenant)
            if q is None:
                q = self._subq[req.tenant] = deque()
            if not q:
                # (re)joining the ring starts with a clean slate: an
                # idle tenant banks no credit (standard DRR)
                self._ring.append(req.tenant)
                self._deficit[req.tenant] = 0.0
            q.append(req)
            self._qn += 1
            self._inflight[req.tenant] = \
                self._inflight.get(req.tenant, 0) + 1
            self.admitted += 1
            self.depth_hw = max(self.depth_hw, self._qn)
            self._cv.notify()

    def idle(self) -> bool:
        """True when nothing is queued AND no admitted request is
        still executing (in-flight covers queued + dispatched until
        :meth:`release`) — the graceful-drain gate."""
        with self._cv:
            return self._qn == 0 and not self._inflight

    def release(self, req: Request) -> None:
        """Return ``req``'s tenant slot (request left execution)."""
        with self._cv:
            left = self._inflight.get(req.tenant, 0) - 1
            if left > 0:
                self._inflight[req.tenant] = left
            else:
                self._inflight.pop(req.tenant, None)

    def _pop_drr(self, max_n: int) -> List[Request]:
        """Drain up to ``max_n`` requests by deficit-weighted
        round-robin over the active-tenant ring (caller holds the
        lock).  Each ring turn banks the tenant's weight; one request
        pops per whole credit, FIFO within the tenant.  A drained
        tenant leaves the ring and forfeits its residue."""
        batch: List[Request] = []
        while len(batch) < max_n and self._qn > 0:
            if not self._ring:  # pragma: no cover - _qn implies a ring
                break
            tenant = self._ring[0]
            q = self._subq.get(tenant)
            if not q:
                self._ring.popleft()
                self._deficit.pop(tenant, None)
                self._subq.pop(tenant, None)
                continue
            # bank the tenant's weight; sub-unit weights accumulate
            # across turns until a whole credit pops (weights floor at
            # a positive value, so every tenant pops eventually)
            self._deficit[tenant] = \
                self._deficit.get(tenant, 0.0) + self.weight(tenant)
            while q and len(batch) < max_n \
                    and self._deficit[tenant] >= 1.0:
                batch.append(q.popleft())
                self._qn -= 1
                self._deficit[tenant] -= 1.0
            if not q:
                # drained: leave the ring AND drop the empty deque —
                # per-request tenant ids must not grow the table
                # forever (the tenant re-creates both on next submit)
                self._ring.popleft()
                self._deficit.pop(tenant, None)
                self._subq.pop(tenant, None)
            else:
                self._ring.rotate(-1)
        return batch

    def take_batch(self, max_n: int, window_s: float,
                   stop: Optional[threading.Event] = None,
                   paused: Optional[threading.Event] = None,
                   ) -> Tuple[List[Request], List[Request]]:
        """Pop the next batch: blocks for the first request, then
        coalesces up to ``max_n`` arrivals within ``window_s`` (the
        batching window concurrent clients land in) and drains them
        weighted-fair (:meth:`_pop_drr` — FIFO within a tenant, DRR
        across tenants).  While ``paused`` is set nothing is popped
        (requests keep queueing — the Server.hold() test hook;
        the pause must live HERE, not in the dispatch loop, or a
        dispatcher already blocked waiting would pop a batch the
        moment one arrives, hold or no hold).  Returns ``(live,
        dropped)`` — ``dropped`` holds expired and cancelled requests,
        already removed, for the dispatcher to shed (their tenant
        slots are NOT yet released; the dispatcher releases as it
        finishes/sheds each request)."""
        with self._cv:
            while self._qn == 0 or (paused is not None
                                    and paused.is_set()):
                if stop is not None and stop.is_set():
                    return [], []
                self._cv.wait(0.1)
            deadline = time.monotonic() + max(0.0, window_s)
            while self._qn < max_n:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            batch = self._pop_drr(max_n)
        live, dropped = [], []
        for r in batch:
            if r.cancelled or r.expired():
                dropped.append(r)
                if not r.cancelled:
                    self.shed += 1
                    _c_shed.add()
            else:
                live.append(r)
        return live, dropped

    def stats(self) -> dict:
        with self._cv:
            per_tenant = {t: len(q) for t, q in self._subq.items() if q}
            out = {"queued": self._qn, "depth_hw": self.depth_hw,
                   "shed": self.shed, "rejected": self.rejected,
                   "admitted": self.admitted}
            if per_tenant:
                out["tenant_queued"] = per_tenant
            if self.weights:
                out["tenant_weights"] = dict(self.weights)
            return out
