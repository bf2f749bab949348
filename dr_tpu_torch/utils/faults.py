"""Deterministic fault-injection registry (counterpart of
``dr_tpu/utils/faults.py``).

Instrumented modules call :func:`fire` at NAMED injection sites; when an
injection is armed for that site, the registered fault class is raised
(or, for the behavioral kind ``truncate``, returned for the site to act
on).  With nothing armed, ``fire`` is one module-global check.

The site table is the JAX package's, site for site and kind for kind, so
a fault spec parses the same in both packages.  Where each site fires in
the port:

=====================  ===============================================
site                   where it fires
=====================  ===============================================
runtime.init           ``parallel/runtime.init``
dispatch.cache         every ``TappedCache`` lookup (``utils/spmd_guard``)
device.lost            every ``TappedCache`` lookup
collectives.shift      ``communicator.shift_forward / shift_backward``
collectives.alltoall   ``communicator.alltoall``
collectives.ppermute   ``parallel/pipeline.fire_ppermute``: the sparse
                       ring gemv, ring attention, the join's partition
                       ring, the re-layout's ring exchange
halo.exchange          ``span_halo.exchange / exchange_n``
halo.reduce            ``span_halo.reduce``
redistribute.exchange  the collective re-layout's dispatch
checkpoint.write       ``checkpoint.save``, between the write and the
                       rename (``truncate`` tears the file)
checkpoint.read        ``checkpoint.load / read``
kernel.build           ``ops/kernels``: every build and every launch of
                       a CUDA kernel
plan.flush             ``plan.Plan.flush``, before anything of the
                       queue runs
sanitize.verify        ``plan.Plan.flush``, right after ``plan.flush``
                       (armed or not)
mesh.shrink            ``elastic.rescue_session``, before the runtime
                       flips
device.recover         ``runtime.probe_recovered`` (the grow's probe)
mesh.grow              ``elastic.grow_session``, before the rebuild
serve.accept           ``serve.Server``'s accept loop, each connection
serve.request          ``serve.Server``, each request frame at intake
serve.flush            ``serve.Server``, each batch inside its retried
                       body
serve.drain            ``serve.Server.drain`` and the ``drain`` wire op
serve.journal          ``serve.Journal`` append / replay / compact
arena.map              ``serve.Arena.alloc`` and ``.map``
arena.release          ``serve.Arena.release``
router.route           ``serve.RouterClient.route``, each lookup,
                       before any replica is touched
router.probe           ``serve.RouterClient``, each half-open probe of
                       an open breaker
=====================  ===============================================

``runtime.probe`` and ``fallback.warn`` never fire in the port: it has
no device probe and no fallback.

Exception kinds map onto the taxonomy of ``utils/resilience``:
``transient`` -> TransientBackendError, ``relay_down`` ->
RelayDownError, ``oom`` -> DeviceOOM (the message carries
RESOURCE_EXHAUSTED), ``program`` -> ProgramError, ``device_lost`` ->
DeviceLostError (the message carries DEVICE_LOST).

Spec grammar (``DR_GPU_FAULT_SPEC``, parsed at import; call
:func:`reload_env` after changing the variable in-process)::

    spec  := entry (';' entry)*            (',' also splits)
    entry := site ':' kind ['*' times] ['@' after]
    site  := registered site name, '*' globs allowed
    times := int or 'inf'   (default 1: fire once, then pass clean)
    after := int            (clean passes before the first firing)

Example::

    DR_GPU_FAULT_SPEC="halo.exchange:transient*2;checkpoint.write:truncate@1"

Programmatic API: :func:`inject` / :func:`injected` (context manager) /
:func:`clear`.  While any injection is armed, or ``DR_GPU_FAULT_COUNT=1``
(:func:`arm_counting`), the registry also counts site visits
(:func:`stats`).
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from fnmatch import fnmatchcase
from typing import Dict, List, Optional, Tuple

from .env import env_flag, env_str

__all__ = ["fire", "inject", "injected", "clear", "sites", "stats",
           "parse_spec", "reload_env", "arm_counting", "pending",
           "EXCEPTION_KINDS", "BEHAVIORAL_KINDS", "SITES", "PORT_PENDING"]

#: site -> fault kinds it supports (exception kinds raise at the site;
#: behavioral kinds are returned from fire() for the site to act on).
SITES: Dict[str, Tuple[str, ...]] = {
    "runtime.probe": ("transient", "relay_down"),
    "runtime.init": ("transient", "program"),
    "dispatch.cache": ("transient", "program"),
    "collectives.shift": ("transient", "oom", "program"),
    "collectives.alltoall": ("transient", "oom", "program"),
    "collectives.ppermute": ("transient", "oom", "program"),
    "halo.exchange": ("transient", "oom", "program"),
    "halo.reduce": ("transient", "oom", "program"),
    "checkpoint.write": ("transient", "truncate", "program"),
    "checkpoint.read": ("transient", "program"),
    "plan.flush": ("transient", "program"),
    "serve.accept": ("transient", "program"),
    "serve.request": ("transient", "oom", "program"),
    "serve.flush": ("transient", "relay_down", "program"),
    "device.lost": ("device_lost",),
    "mesh.shrink": ("transient", "program"),
    "device.recover": ("transient", "program"),
    "mesh.grow": ("transient", "program"),
    "redistribute.exchange": ("transient", "oom", "program"),
    "arena.map": ("transient", "program"),
    "arena.release": ("transient", "program"),
    "router.route": ("transient", "program"),
    "router.probe": ("transient", "program"),
    "serve.drain": ("transient", "program"),
    "serve.journal": ("transient", "program"),
    # a CUDA tensor's wrapper raises the classified error: no plain
    # version runs instead (ops/kernels.py)
    "kernel.build": ("transient", "program"),
    "sanitize.verify": ("transient", "program"),
    "fallback.warn": (),
}

#: the sites that never fire in the port (``None``: it has no such
#: code); every other site fires
PORT_PENDING: Dict[str, Optional[str]] = {
    "runtime.probe": None, "fallback.warn": None,
}

EXCEPTION_KINDS = ("transient", "relay_down", "oom", "program",
                   "device_lost")
BEHAVIORAL_KINDS = ("truncate",)
_ALL_KINDS = EXCEPTION_KINDS + BEHAVIORAL_KINDS


class _Injection:
    __slots__ = ("site", "kind", "remaining", "skip", "fired")

    def __init__(self, site: str, kind: str, times, after: int):
        self.site = site
        self.kind = kind
        self.remaining = times  # int or None (= unbounded)
        self.skip = after
        self.fired = 0

    def __repr__(self):  # pragma: no cover - debugging aid
        times = "inf" if self.remaining is None else self.remaining
        return (f"_Injection({self.site}:{self.kind}*{times}"
                f"@{self.skip}, fired={self.fired})")


_specs: List[_Injection] = []
_counts: Dict[str, int] = {}
_counting = False
#: hot-path gate: fire() returns immediately unless something is armed
_armed = False

#: installed by ``obs.recorder.arm()``: every fire() visit becomes a
#: trace event (site hook) and every triggered injection is stamped
#: into the trace (fault hook), so an injected fault appears in the
#: trace next to the dispatch it poisoned.  None keeps the untraced
#: fire() one extra ``is not None`` test.
_obs_site_hook = None
_obs_fault_hook = None


def _rearm() -> None:
    global _armed
    _armed = bool(_specs) or _counting


def sites() -> Dict[str, Tuple[str, ...]]:
    """The registered injection-site table (copy)."""
    return dict(SITES)


def stats() -> Dict[str, int]:
    """Per-site visit counts since the last :func:`clear` (collected
    only while armed — chaos runs, not production dispatch)."""
    return dict(_counts)


def pending() -> List[str]:
    """Human-readable list of injections that have not exhausted."""
    return [repr(s) for s in _specs
            if s.remaining is None or s.remaining > 0]


def arm_counting(on: bool = True) -> None:
    """Count site visits even with no injection armed (the chaos arm's
    coverage assertion; ``DR_GPU_FAULT_COUNT=1`` sets this at import)."""
    global _counting
    _counting = on
    _rearm()


def inject(site: str, kind: str, *, times: Optional[int] = 1,
           after: int = 0) -> None:
    """Arm ``kind`` at ``site`` (glob patterns allowed): the next
    ``after`` matching visits pass clean, then ``times`` visits fault
    (``times=None`` = every visit).  Unknown sites/kinds — and kinds no
    matched site SUPPORTS (e.g. ``truncate`` anywhere but
    checkpoint.write) — are errors: a typo in a chaos spec must not
    read as a clean sweep."""
    if kind not in _ALL_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; "
                         f"known: {', '.join(_ALL_KINDS)}")
    matched = [s for s in SITES if fnmatchcase(s, site)]
    if not matched:
        raise ValueError(f"fault site {site!r} matches no registered "
                         f"site; known: {', '.join(sorted(SITES))}")
    if not any(kind in SITES[s] for s in matched):
        there = sorted(set().union(*(SITES[s] for s in matched)))
        raise ValueError(
            f"fault kind {kind!r} is unsupported at every site matching "
            f"{site!r} (supported there: {', '.join(there or ['none'])})")
    _specs.append(_Injection(site, kind, times, int(after)))
    _rearm()


@contextmanager
def injected(site: str, kind: str, *, times: Optional[int] = 1,
             after: int = 0):
    """Scoped :func:`inject`: the injection is removed on exit (other
    armed injections are untouched)."""
    inject(site, kind, times=times, after=after)
    sp = _specs[-1]
    try:
        yield sp
    finally:
        try:
            _specs.remove(sp)
        except ValueError:  # a clear() inside the block already took it
            pass
        _rearm()


def clear() -> None:
    """Disarm every injection and zero the visit counters."""
    global _counting
    _specs.clear()
    _counts.clear()
    _counting = False
    _rearm()


def fire(site: str, **ctx) -> Optional[str]:
    """Hot-path hook at a named injection site.

    No-op (one global check) when nothing is armed.  Armed: counts the
    visit, and if an injection matches, raises its classified exception
    — or returns the behavioral kind string (e.g. ``"truncate"``) for
    the site to act on.  Returns None on a clean pass."""
    if _obs_site_hook is not None:
        _obs_site_hook(site, ctx)
    if not _armed:
        return None
    _counts[site] = _counts.get(site, 0) + 1
    for sp in _specs:
        if sp.remaining is not None and sp.remaining <= 0:
            continue
        if not fnmatchcase(site, sp.site):
            continue
        if sp.kind not in SITES.get(site, ()):
            continue  # glob spec: fire only where the kind is supported
        if sp.skip > 0:
            sp.skip -= 1
            continue
        if sp.remaining is not None:
            sp.remaining -= 1
        sp.fired += 1
        return _trigger(site, sp.kind, ctx)
    return None


def _trigger(site: str, kind: str, ctx: dict) -> Optional[str]:
    if _obs_fault_hook is not None:
        _obs_fault_hook(site, kind)
    from . import resilience as R
    tag = f"injected fault '{kind}' at site {site}"
    if ctx:
        tag += f" ({', '.join(f'{k}={v!r}' for k, v in sorted(ctx.items()))})"
    if kind == "transient":
        raise R.TransientBackendError(f"UNAVAILABLE: {tag}", site=site)
    if kind == "relay_down":
        raise R.RelayDownError(f"relay not listening: {tag}", site=site)
    if kind == "oom":
        raise R.DeviceOOM(f"RESOURCE_EXHAUSTED: {tag}", site=site)
    if kind == "device_lost":
        # rank attribution rides the fire() ctx (DR_GPU_FAULT_SPEC has
        # no rank field: env-injected losses leave rank None)
        rank = ctx.get("rank")
        raise R.DeviceLostError(f"DEVICE_LOST: {tag}", site=site,
                                rank=rank if isinstance(rank, int)
                                else None)
    if kind == "program":
        raise R.ProgramError(tag, site=site)
    return kind  # behavioral: the site acts on it


# ---------------------------------------------------------------------------
# env spec
# ---------------------------------------------------------------------------

def parse_spec(text: str) -> List[Tuple[str, str, Optional[int], int]]:
    """Parse the ``DR_GPU_FAULT_SPEC`` grammar into
    ``(site, kind, times, after)`` tuples.  Raises ValueError on a
    malformed ENTRY (reload_env downgrades that to a warning so a typo
    cannot brick an unrelated run, but never silently arms nothing)."""
    out = []
    for raw in text.replace(",", ";").split(";"):
        entry = raw.strip()
        if not entry:
            continue
        if ":" not in entry:
            raise ValueError(f"fault spec entry {entry!r}: expected "
                             "site:kind[*times][@after]")
        site, rest = entry.split(":", 1)
        after = 0
        if "@" in rest:
            rest, a = rest.rsplit("@", 1)
            after = int(a)
        times: Optional[int] = 1
        if "*" in rest:
            rest, t = rest.split("*", 1)
            times = None if t.strip() == "inf" else int(t)
        out.append((site.strip(), rest.strip(), times, after))
    return out


def reload_env() -> int:
    """(Re)install injections from ``DR_GPU_FAULT_SPEC`` (clears any
    previously armed set first).  Returns the number installed.
    Malformed entries warn and are skipped — but a spec that arms
    NOTHING despite being nonempty also warns, so a typo'd chaos run
    cannot read as a clean sweep."""
    clear()
    if env_flag("DR_GPU_FAULT_COUNT"):
        arm_counting()
    text = env_str("DR_GPU_FAULT_SPEC")
    if not text.strip():
        return 0
    installed = 0
    try:
        entries = parse_spec(text)
    except ValueError as e:
        warnings.warn(f"DR_GPU_FAULT_SPEC ignored: {e}", stacklevel=2)
        return 0
    for site, kind, times, after in entries:
        try:
            inject(site, kind, times=times, after=after)
            installed += 1
        except ValueError as e:
            warnings.warn(f"DR_GPU_FAULT_SPEC entry skipped: {e}",
                          stacklevel=2)
    if installed == 0:
        warnings.warn("DR_GPU_FAULT_SPEC set but armed no injections",
                      stacklevel=2)
    return installed


reload_env()
