"""``DR_GPU_SANITIZE=1``: runtime invariant checks (counterpart of
``dr_tpu/utils/sanitize.py``).

* **Recompile detection.**  Every first insert into a ``TappedCache`` is
  a compile; ``spmd_guard.compile_count()`` counts them unconditionally
  (one int add).  Armed, each inserted key is canonicalized
  (``spmd_guard._canon``: pin identities neutralized, so two runtimes of
  the same geometry collide) and an epoch in which the same canonical
  key is inserted more than ``DR_GPU_SANITIZE_RECOMPILE_LIMIT``
  (default 2) times fails: a value-keyed recompile storm.
  :func:`zero_recompile` is the strict region form: no insert at all may
  occur inside.
* **Finite flush** (:func:`is_finite` / :func:`check_finite`): every
  inexact row and scalar a deferred-plan run produced must be
  NaN/Inf-free; ``plan.Plan.flush`` checks after each run (a run whose
  inputs were already non-finite is exempt).  The plan's footprint
  verifier (``plan/plansan.py``) arms too.
* **Canon portability**: every dispatch key recorded under an active
  guard must canonicalize without a process-local ``0x...`` address (an
  address in the canon would make ``spmd_guard.verify()`` report a false
  divergence across processes).  Checked at every cache insert and at
  record time under an active guard.  A key holding a ``torch.device``
  fails the same check: the same program on ``cuda`` and ``cpu`` ranks
  must record the same trace.

Arming: :func:`install` runs at ``import dr_tpu_torch`` (a cheap env
check, a no-op unless ``DR_GPU_SANITIZE=1``); tests give each case its
own epoch with :func:`reset_epoch` / :func:`check_recompiles`.
"""

from __future__ import annotations

import re
import threading
from collections import Counter
from contextlib import contextmanager
from typing import Dict, Optional

from .env import env_flag, env_int

__all__ = ["SanitizeError", "enabled", "install", "installed",
           "reset_epoch", "check_recompiles", "zero_recompile",
           "check_finite", "is_finite", "recompile_counts",
           "watch_containers"]


class SanitizeError(AssertionError):
    """A runtime invariant the static rules mirror was violated."""


def enabled() -> bool:
    return env_flag("DR_GPU_SANITIZE")


_installed = False
_epoch: Counter = Counter()          # canonical key -> compiles this epoch

#: canon strings are process-portable by construction; a hex address
#: can only leak in through repr() of an unpinned rich object in a
#: cache key — the divergence-false-positive class this check names.
_ADDR_RE = re.compile(r"0x[0-9a-fA-F]{6,}")


def _canon(key) -> str:
    from . import spmd_guard
    return spmd_guard._canon(key)


def _on_compile(key) -> None:
    canon = _canon(key)
    _on_record(key, canon)   # every key is canonicalized here anyway
    _epoch[canon] += 1


def _on_record(key, canon: str) -> None:
    if "device(type=" in canon:
        raise SanitizeError(
            f"dispatch key holds a torch.device: {canon[:200]!r}; the "
            "same program on other devices would record another trace "
            "(key the rank list by pinned_id(runtime))")
    m = _ADDR_RE.search(canon)
    if m:
        raise SanitizeError(
            "dispatch key canonicalizes with a process-local address "
            f"({m.group(0)}): {canon[:200]!r} — spmd_guard.verify() "
            "would report a false divergence across ranks; pin the "
            "object (core.pinning) or key on portable structure")


def install() -> bool:
    """Arm the hooks when ``DR_GPU_SANITIZE=1``; idempotent, returns
    whether the sanitizer is armed."""
    global _installed
    if _installed or not enabled():
        return _installed
    from . import spmd_guard
    spmd_guard._compile_hook = _on_compile
    spmd_guard._canon_check_hook = _on_record
    _installed = True
    return True


def installed() -> bool:
    return _installed


def reset_epoch() -> None:
    """Start a fresh recompile-counting epoch (one per test)."""
    _epoch.clear()


def recompile_counts() -> Dict[str, int]:
    """Canonical-key compile counts for the current epoch."""
    return dict(_epoch)


def check_recompiles(limit: Optional[int] = None) -> None:
    """Fail the epoch if any canonical program compiled more than
    ``limit`` times (default ``DR_GPU_SANITIZE_RECOMPILE_LIMIT``, 2:
    one benign duplicate allowed for two-runtime tests; a storm is
    many)."""
    if limit is None:
        limit = env_int("DR_GPU_SANITIZE_RECOMPILE_LIMIT", 2)
    bad = {k: c for k, c in _epoch.items() if c > limit}
    if bad:
        worst = sorted(bad.items(), key=lambda kv: -kv[1])[:3]
        lines = "; ".join(f"{c}x {k[:160]}" for k, c in worst)
        raise SanitizeError(
            f"recompile storm: {len(bad)} canonical program(s) "
            f"compiled more than {limit}x in one epoch: value-keyed "
            "dispatch keys; key on structure instead.  "
            f"Worst: {lines}")


@contextmanager
def zero_recompile(what: str = "region"):
    """Assert that no dispatch-cache insert happens inside the region:
    a second pass over work already dispatched once must hit every
    cache.  Works unarmed too (the raw counter is always on)."""
    from . import spmd_guard
    c0 = spmd_guard.compile_count()
    yield
    grew = spmd_guard.compile_count() - c0
    if grew:
        raise SanitizeError(
            f"{what}: {grew} compile(s) inside a zero-recompile "
            "region: a dispatch misses its cache (value-keyed key or "
            "drifting key structure)")


# ---------------------------------------------------------------------------
# container-access watching (the observation channel of the plan's
# footprint verifier, plan/plansan.watch)
# ---------------------------------------------------------------------------

#: module-global fast gates for instrumented containers: a read pays
#: one None check while no watcher is armed anywhere; armed, the
#: dispatchers below route to the per-thread watcher.
_access_hook = None
_born_hook = None
_watch_tls = threading.local()
_watch_lock = threading.Lock()
_watchers = 0


def _dispatch_access(kind: str, cont) -> None:
    h = getattr(_watch_tls, "access", None)
    if h is not None:
        h(kind, cont)


def _dispatch_born(cont) -> None:
    h = getattr(_watch_tls, "born", None)
    if h is not None:
        h(cont)


@contextmanager
def watch_containers(access, born=None):
    """Arm a container-access watcher on this thread for the enclosed
    block: instrumented containers report every read
    (``access("r", cont)``), every rebind (``access("w", cont)``), and
    every container creation (``born(cont)``).  Nests (the previous
    watcher is restored); other threads stay unobserved.
    ``distributed_vector`` reports through it (its ``_rows``)."""
    global _access_hook, _born_hook, _watchers
    prev = (getattr(_watch_tls, "access", None),
            getattr(_watch_tls, "born", None))
    _watch_tls.access, _watch_tls.born = access, born
    with _watch_lock:
        _watchers += 1
        _access_hook = _dispatch_access
        _born_hook = _dispatch_born
    try:
        yield
    finally:
        _watch_tls.access, _watch_tls.born = prev
        with _watch_lock:
            _watchers -= 1
            if not _watchers:
                _access_hook = None
                _born_hook = None


def is_finite(arr) -> bool:
    """True when ``arr`` has no NaN/Inf (integer and bool dtypes
    vacuously).  Waits for the device: callers gate on
    :func:`installed`."""
    import torch
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(arr)
    if not (t.is_floating_point() or t.is_complex()):
        return True
    return bool(torch.isfinite(t).all())


def check_finite(arr, what: str) -> None:
    """Raise unless every element of ``arr`` is finite.  Callers gate
    on :func:`installed`: this waits for the device."""
    if not is_finite(arr):
        raise SanitizeError(
            f"non-finite values in {what} after a plan-flush run: a "
            "fused-chain bug, or an overflow/NaN the chain mints from "
            "finite inputs; the deferred plan path has no NaN-sentinel "
            "semantics (run such chains eagerly)")
