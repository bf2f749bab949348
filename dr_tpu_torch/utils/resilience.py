"""The classified failure taxonomy, retry and deadlines (counterpart of
``dr_tpu/utils/resilience.py``).

* **Taxonomy**: every failure is classified into
  :class:`TransientBackendError` (a second attempt may land),
  :class:`RelayDownError`, :class:`DeviceOOM` (back off the problem
  size, not the clock), :class:`DeviceLostError`, or
  :class:`ProgramError` (deterministic; retrying is futile).
  :func:`classify` maps an exception or raw error text onto the taxonomy
  with the JAX package's token tables (a CUDA ``out of memory`` is a
  :class:`DeviceOOM`); :func:`classified` wraps an error into its class.
  While tracing is armed (``dr_tpu_torch.obs``) each classified error
  carries the tail of the trace ring as ``trace_tail``.
* **retry / with_deadline**: :func:`retry` runs a callable with
  exponential backoff and deterministic seeded jitter
  (:func:`backoff_schedule`), and records the ``retry`` event and the
  ``resilience.retries`` / ``resilience.retry_budget_denied`` counters.
  :func:`with_deadline` bounds a possibly hanging call with a watchdog
  thread; on expiry it records ``deadline.expired``, dumps the active
  ``spmd_guard`` dispatch trace and the obs tail, and raises
  :class:`DeadlineExpired`.

Not in this slice: ``retry``'s elastic shrink on a
:class:`DeviceLostError` comes with the ``elastic`` slice; until then a
device loss surfaces classified and is not retried.
``degradation_story`` reads re-exec markers of the JAX package's bench
and serving daemon, which the port does not have; it comes with
``serve/``, if at all.

Dropped: ``first_touch_or_cpu``, ``route_first_touch``,
``relay_listening``, ``dead_relay`` and ``FirstTouch``.  They switch a
failed first device touch to the CPU, and the port has no fallback:
``init()`` takes the visible CUDA devices or raises, and a failed first
touch raises classified under the site ``runtime.init``.
"""

from __future__ import annotations

import random
import sys
import threading
import time
from typing import Callable, Optional, Sequence

__all__ = [
    "ResilienceError", "TransientBackendError", "RelayDownError",
    "DeviceOOM", "ProgramError", "CheckpointCorruptError",
    "DeadlineExpired", "ServerOverloaded", "ServerDraining",
    "DeviceLostError",
    "classify", "classified",
    "backoff_schedule", "ProbeTimer", "TokenBudget",
    "retry", "with_deadline", "dump_dispatch_trace", "dump_obs_tail",
]


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------

def _obs_tail():
    """The last trace events while tracing (``dr_tpu_torch.obs``) is
    armed: the postmortem a classified error carries; None while tracing
    is off (one module-global check, no allocation)."""
    from ..obs import recorder as _rec
    if not _rec._armed:
        return None
    return _rec.tail()


class ResilienceError(RuntimeError):
    """Base of the classified failure taxonomy.  ``site`` names the site
    that raised (empty when classified from a raw error with no site).
    ``trace_tail``: the last ``DR_GPU_TRACE_TAIL`` trace events while
    tracing is armed, else None."""

    def __init__(self, message: str, *, site: str = ""):
        super().__init__(message)
        self.site = site
        self.trace_tail = _obs_tail()


class TransientBackendError(ResilienceError):
    """The backend hiccuped (UNAVAILABLE, a reset connection): a later
    attempt may land; the retryable class."""


class RelayDownError(ResilienceError):
    """Nothing is listening at the other end: retrying only burns the
    caller's time budget."""


class DeviceOOM(ResilienceError):
    """RESOURCE_EXHAUSTED or a CUDA out of memory: back off the problem
    size, not the clock."""


class ProgramError(ResilienceError):
    """Deterministic program/user error: retrying is futile; surface."""


class CheckpointCorruptError(ProgramError):
    """A checkpoint file is truncated, corrupt or foreign: the classified
    answer to a torn write (``utils/checkpoint.py``)."""


class DeadlineExpired(ResilienceError):
    """A watchdogged call overran its deadline.  Raised by
    :func:`with_deadline` after the dispatch-trace dump; the hung worker
    thread is left behind (a daemon thread)."""


class ServerOverloaded(ResilienceError):
    """A serving daemon's admission control rejected the request: back
    off and resubmit (used by the ``serve/`` slice)."""


class ServerDraining(ResilienceError):
    """A serving daemon is draining: reconnect elsewhere (used by the
    ``serve/`` slice)."""


class DeviceLostError(ResilienceError):
    """A device died mid-session: retrying the same program on the same
    ranks cannot succeed.  ``rank`` attributes the loss to a rank when
    known (fault injection sets it; a raw error classified here leaves
    it None).  Surfaces classified and is not retried until the
    ``elastic`` slice brings the shrink."""

    def __init__(self, message: str, *, site: str = "",
                 rank: Optional[int] = None):
        super().__init__(message, site=site)
        self.rank = rank


# substring evidence for each class (matched case-insensitively),
# checked in order: OOM first (its messages often also contain
# transient-looking words), then relay-down, then the transient bucket;
# anything else is a program error.  The OOM tokens are anchored
# ("out of memory"): as a global classifier gating retry decisions, a
# transient error that merely mentions memory must stay retryable.
_OOM_TOKENS = ("resource_exhausted", "out of memory")
# device-loss evidence is checked BEFORE the transient bucket: the raw
# backend text for a dead chip often also carries transient-looking
# words ("unavailable"), and retrying on the dead device cannot land
_DEVICE_LOST_TOKENS = ("device_lost", "device lost", "data_loss",
                       "device failure", "hardware failure")
_RELAY_TOKENS = ("relay not listening", "connection refused",
                 "econnrefused", "failed to connect")
# no bare "exceeded": deterministic errors phrase limits that way too
# ("maximum recursion depth exceeded") and must not become retryable
_TRANSIENT_TOKENS = ("unavailable", "deadline_exceeded", "aborted",
                     "socket closed", "connection reset", "wedged",
                     "timed out", "timeout")


def classify(err) -> type:
    """Map an exception or raw error text onto the taxonomy.  Already
    classified errors keep their class."""
    if isinstance(err, ResilienceError):
        return type(err)
    text = (err if isinstance(err, str)
            else f"{type(err).__name__}: {err}").lower()
    for tokens, cls in ((_OOM_TOKENS, DeviceOOM),
                        (_DEVICE_LOST_TOKENS, DeviceLostError),
                        (_RELAY_TOKENS, RelayDownError),
                        (_TRANSIENT_TOKENS, TransientBackendError)):
        if any(t in text for t in tokens):
            return cls
    return ProgramError


def classified(err, *, site: str = "") -> ResilienceError:
    """Return ``err`` as a taxonomy instance: pass-through when already
    classified, else wrap (keeping the original as ``__cause__``)."""
    if isinstance(err, ResilienceError):
        if site and not err.site:
            err.site = site
        return err
    cls = classify(err)
    msg = err if isinstance(err, str) else f"{type(err).__name__}: {err}"
    out = cls(msg, site=site)
    if isinstance(err, BaseException):
        out.__cause__ = err
    return out


# ---------------------------------------------------------------------------
# retry with deterministic backoff
# ---------------------------------------------------------------------------

def backoff_schedule(attempts: int, *, base: float = 0.05,
                     factor: float = 2.0, max_delay: float = 30.0,
                     jitter: float = 0.25, seed: int = 0) -> list:
    """Exponential backoff delays with DETERMINISTIC jitter: a pure
    function of its arguments (seeded ``random.Random``), so tests — and
    SPMD processes sharing a seed — reproduce every delay exactly.
    Jitter multiplies each delay by a factor in [1-jitter, 1+jitter]."""
    rng = random.Random(seed)
    out = []
    for i in range(max(0, attempts)):
        d = min(max_delay, base * (factor ** i))
        out.append(d * (1.0 + jitter * (2.0 * rng.random() - 1.0)))
    return out


class ProbeTimer:
    """Bounded seeded-backoff probe timer: delays ride
    :func:`backoff_schedule` (deterministic jitter, so tests reproduce
    every probe time) from ``base`` doubling to ``cap``, bounded at
    ``budget`` probes, so a resource that never comes back is not probed
    forever (the pacing of the ``elastic`` and ``serve/`` slices)."""

    def __init__(self, base: float, cap: float, budget: int, *,
                 seed: int = 0):
        self.budget = int(budget)
        self._delays = backoff_schedule(
            self.budget, base=max(0.0, float(base)), factor=2.0,
            max_delay=max(0.0, float(cap)), seed=seed)
        self.probes = 0
        self._next = time.monotonic() + (self._delays[0]
                                         if self._delays else 0.0)

    def exhausted(self) -> bool:
        return self.probes >= self.budget

    def due(self, now: Optional[float] = None) -> bool:
        return not self.exhausted() and \
            (time.monotonic() if now is None else now) >= self._next

    def advance(self, now: Optional[float] = None) -> None:
        """One probe taken: schedule the next."""
        now = time.monotonic() if now is None else now
        self.probes += 1
        if self.probes < self.budget:
            self._next = now + self._delays[self.probes]


class TokenBudget:
    """Shared retry token bucket.

    Per-call retry loops compose multiplicatively under a failure that
    hits everything at once.  One bucket shared by every retry loop
    bounds the total: a retry spends a token (:meth:`spend`), a
    successful request refills ``ratio`` of one (:meth:`note_success`,
    capped at ``capacity``).  While things are healthy the bucket stays
    full; when everything fails it drains in ``capacity`` retries and
    every later failure surfaces classified in one attempt.

    Thread-safe; ``capacity=0`` disarms retries outright.  Pass one to
    :func:`retry` via ``budget=``."""

    def __init__(self, capacity: float, ratio: float = 0.1):
        self.capacity = max(0.0, float(capacity))
        self.ratio = max(0.0, float(ratio))
        self._tokens = self.capacity
        self._lock = threading.Lock()
        self.spent = 0
        self.denied = 0

    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def spend(self, n: float = 1.0) -> bool:
        """Take ``n`` tokens; False (and nothing taken) when the
        bucket cannot cover them — the caller must NOT retry."""
        with self._lock:
            if self._tokens < n:
                self.denied += 1
                return False
            self._tokens -= n
            self.spent += 1
            return True

    def note_success(self) -> None:
        """A request landed: bank ``ratio`` of a token (capped)."""
        with self._lock:
            self._tokens = min(self.capacity, self._tokens + self.ratio)

    def snapshot(self) -> dict:
        with self._lock:
            return {"tokens": round(self._tokens, 3),
                    "capacity": self.capacity, "ratio": self.ratio,
                    "spent": self.spent, "denied": self.denied}


def retry(fn: Callable, *, attempts: int = 3, base: float = 0.05,
          factor: float = 2.0, max_delay: float = 30.0,
          jitter: float = 0.25, seed: int = 0,
          retry_on: Sequence[type] = (TransientBackendError,),
          sleep: Callable = time.sleep, on_retry: Callable = None,
          deadline_s: Optional[float] = None,
          budget: Optional[TokenBudget] = None):
    """Run ``fn()`` with classified retries.

    Every raised error is classified first; only instances of
    ``retry_on`` classes are retried (default: transients only; an OOM
    or a lost device must be handled, not hammered).  Delays come from
    :func:`backoff_schedule`, so the timing is deterministic given
    ``seed``.  ``on_retry(attempt_index, error, delay)`` observes each
    retry.  The final failure is re-raised classified.

    ``deadline_s``: a retry whose backoff delay would land past the
    budget (measured from the first attempt) is not taken; the
    classified error surfaces instead.

    ``budget``: a shared :class:`TokenBudget`; each retry spends one
    token first, and an exhausted bucket re-raises the classified error
    at once (counted as ``resilience.retry_budget_denied``).

    Each retry records a ``retry`` event (category ``resilience``) and
    the ``resilience.retries`` counter while tracing is armed.  A
    :class:`DeviceLostError` is not retried: the shrink that makes it
    retryable comes with the ``elastic`` slice."""
    if attempts < 1:
        # a config-derived attempts=0 must fail loudly, not silently
        # skip the protected call and hand back None
        raise ValueError(f"retry needs attempts >= 1, got {attempts}")
    delays = backoff_schedule(attempts - 1, base=base, factor=factor,
                              max_delay=max_delay, jitter=jitter, seed=seed)
    t0 = time.monotonic()
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:
            ce = classified(e)
            recoverable = isinstance(ce, tuple(retry_on))
            if i == attempts - 1 or not recoverable:
                if ce is e:
                    raise  # already classified: keep its cause chain
                raise ce from e
            if deadline_s is not None and \
                    time.monotonic() - t0 + delays[i] > deadline_s:
                if ce is e:
                    raise
                raise ce from e
            if budget is not None and not budget.spend():
                from .. import obs as _obs
                _obs.count("resilience.retry_budget_denied")
                if ce is e:
                    raise
                raise ce from e
            if on_retry is not None:
                on_retry(i, ce, delays[i])
            from .. import obs as _obs
            _obs.event("retry", cat="resilience", attempt=i,
                       error=type(ce).__name__, site=ce.site,
                       delay_s=round(delays[i], 4), shrunk=False)
            _obs.count("resilience.retries")
            sleep(delays[i])


# ---------------------------------------------------------------------------
# deadline watchdog + dispatch-trace escalation
# ---------------------------------------------------------------------------

def dump_dispatch_trace(file=None, limit: int = 40) -> int:
    """Print the tail of the active spmd_guard dispatch trace — the
    information a hang postmortem cannot give you (which program the
    process was enqueueing when it stopped making progress).  Returns
    the number of entries printed (0 when no guard is active)."""
    from . import spmd_guard
    file = file or sys.stderr
    g = spmd_guard.active()
    if g is None or not g.trace:
        print("resilience: no active spmd_guard dispatch trace "
              "(run inside spmd_guard.guard() for a dispatch postmortem)",
              file=file)
        return 0
    tail = g.trace[-limit:]
    start = len(g.trace) - len(tail)
    print(f"resilience: last {len(tail)} of {len(g.trace)} recorded "
          "dispatches before the deadline expired:", file=file)
    for i, entry in enumerate(tail, start=start):
        print(f"  [{i}] {entry}", file=file)
    return len(tail)


def dump_obs_tail(file=None) -> int:
    """Print the tail of the obs trace ring (while tracing is armed):
    the sibling of :func:`dump_dispatch_trace`, with the spans, site
    visits and injected faults leading up to the failure.
    Returns the number of events printed (0 while tracing is off)."""
    tail = _obs_tail()
    if not tail:
        return 0
    file = file or sys.stderr
    print(f"resilience: last {len(tail)} obs trace event(s) before "
          "the failure:", file=file)
    for ev in tail:
        args = ev.get("args") or {}
        extra = " ".join(f"{k}={v}" for k, v in args.items())
        dur = f" dur={ev['dur']}us" if "dur" in ev else ""
        print(f"  [{ev.get('ts', 0)}] {ev.get('name')}"
              f" ({ev.get('cat', '')}){dur} {extra}".rstrip(),
              file=file)
    return len(tail)


def with_deadline(fn: Callable, timeout_s: float, *, site: str = "",
                  dump: bool = True, file=None):
    """Run ``fn()`` under a watchdog: its value (or its exception) when
    it finishes within ``timeout_s``; :class:`DeadlineExpired` — after
    an spmd_guard dispatch-trace dump — when it hangs.  The worker is a
    daemon thread, so a truly wedged call cannot pin process exit."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # must cross the thread boundary
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        from .. import obs as _obs
        _obs.event("deadline.expired", cat="resilience", site=site,
                   timeout_s=timeout_s)
        if dump:
            dump_dispatch_trace(file)
            dump_obs_tail(file)
        name = site or getattr(fn, "__name__", "call")
        raise DeadlineExpired(
            f"{name} exceeded its {timeout_s:.1f}s deadline "
            "(hung first touch or kernel build?)", site=site)
    if "error" in box:
        raise box["error"]
    return box.get("value")


