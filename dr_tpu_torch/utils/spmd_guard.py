"""SPMD dispatch-order guard (counterpart of ``dr_tpu/utils/spmd_guard.py``).

Every process of a multi-process run must issue the same collective
programs in the same order; a violation does not crash, it deadlocks or
mismatches data silently.  While a guard is active, every dispatch of
the port records a canonical form of its dispatch key::

    from dr_tpu_torch.utils import spmd_guard
    with spmd_guard.guard() as g:
        ... run the section on every process ...
        g.verify()          # collective: raises on divergence

The dispatch tap.  The JAX package looks up a compiled program in a
:class:`TappedCache` at every dispatch.  The port is eager and compiles
nothing, but keeps the same module caches (the algorithm layer's shared
cache in ``algorithms/elementwise``; ``distributed_vector``,
``dense_matrix``, ``mdarray``, the communicator, ``halo``,
``redistribute`` and ring attention), looked up once per dispatch at the
point where the JAX package looks up its program, with a key of the
same shape: the leading tag, the geometry, the dtype, and
``pinned_id(op)`` for a user callable.  The value is what the call can
reuse (index tensors, a plan) or ``True``.  A first insert of a key is
the port's "compile", counted by :func:`compile_count`; an ``nvcc``
build is not (that is the ``kernel.build`` fault site).  A key holds no
``torch.device`` and no data pointer: the rank list enters as
``pinned_id(runtime)``, as the JAX mesh does, so the same program on
``cuda:0`` ranks and on ``cpu`` ranks canonicalizes to the same trace.

``verify()`` compares digests across processes with
``torch.distributed.all_gather_object`` when ``torch.distributed`` is
initialised, and on a mismatch gathers the traces and reports the first
divergent dispatch.  Without it (the port's single-controller runs) the
one process is compared with itself.

Canonicalization: ``pinned_id`` values (process-local identities, typed
``core.pinning.PinnedId``) become a placeholder, or the code identity of
a pinned callable; every other int is structural and compared verbatim.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from contextlib import contextmanager
from typing import List, Optional

from ..core.pinning import PinnedId, _pins
from . import faults

__all__ = ["guard", "active", "record", "note_compile", "DivergenceError",
           "TappedCache", "SpmdGuard", "first_divergence", "dispatch_count",
           "compile_count", "dtype_name"]


class DivergenceError(RuntimeError):
    pass


def dtype_name(dtype) -> str:
    """A dtype as the JAX package's keys spell it (``"float32"``, not
    ``"torch.float32"``)."""
    return str(dtype).replace("torch.", "")


def _hash_code(h, code) -> None:
    """Feed a code object into ``h`` process-portably: bytecode,
    referenced names (sin vs cos differ only here), and constants,
    recursing into nested code objects (their repr embeds a
    process-local address)."""
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    h.update(repr((code.co_varnames, code.co_argcount)).encode())
    for c in code.co_consts:
        if hasattr(c, "co_code"):
            _hash_code(h, c)
        else:
            h.update(repr(c).encode())
        h.update(b"\0")


def _canon_callable(obj) -> str:
    """Process-portable identity of a callable: qualname plus a hash of
    its code, so two different lambdas (both ``<lambda>``) diverge."""
    name = getattr(obj, "__qualname__", getattr(obj, "__name__", "fn"))
    code = getattr(obj, "__code__", None)
    if code is None:
        return name
    h = hashlib.sha1()
    _hash_code(h, code)
    return f"{name}#{h.hexdigest()[:8]}"


def _canon(x) -> str:
    if isinstance(x, tuple):
        return "(" + ",".join(_canon(e) for e in x) + ")"
    if isinstance(x, PinnedId):
        # a pinned callable keeps its code identity ("same geometry,
        # different op" stays a divergence); other identities (the
        # runtime's rank list) canonicalize away
        obj = _pins.get(int(x))
        if callable(obj):
            return _canon_callable(obj)
        return "ptr"
    if callable(x):
        return _canon_callable(x)
    return repr(x)


def _cache_cap() -> int:
    """Per-cache entry bound (``DR_GPU_PROG_CACHE_CAP``, default 512,
    floor 8): a stream of one-shot layouts must not grow a cache without
    bound."""
    from .env import env_int
    return env_int("DR_GPU_PROG_CACHE_CAP", 512, floor=8)


class TappedCache(OrderedDict):
    """Dispatch cache whose lookups double as the guard's dispatch tap:
    every dispatch does one ``get`` / ``setdefault`` / :meth:`tap` on its
    module's cache (hit or miss), so its dispatches land on the verified
    trace.  The tap records nothing when no guard is active; the LRU
    bookkeeping costs one extra dict operation per dispatch.

    Also a bounded LRU (:func:`_cache_cap`): hits refresh recency and
    inserts evict the oldest entries, deterministically given the
    dispatch sequence.  Instances register with ``core.pinning`` so that
    when a pin is evicted, the entries whose keys reference that
    identity are purged here."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from ..core.pinning import register_cache
        register_cache(self)

    def tap(self, key, build=None):
        """The one lookup of a dispatch: the cached value of ``key``, or
        on a miss ``build()`` (``True`` when ``build`` is None) stored
        under it, which counts as a compile."""
        val = self.get(key)
        if val is None:
            val = True if build is None else build()
            self[key] = val
        return val

    def get(self, key, default=None):
        # the dispatch moment doubles as the 'dispatch.cache' injection
        # site (utils/faults): a per-process fault here drops exactly
        # one dispatch from the trace, the divergence class the guard
        # exists to catch.  fire() precedes record(): a faulted dispatch
        # touched no tensor, so it must not appear on the verified trace
        # either.  'device.lost' rides the same moment: a device death
        # surfaces at whatever dispatch touches it next.
        faults.fire("dispatch.cache")
        faults.fire("device.lost")
        record(key)
        try:
            self.move_to_end(key)  # hit-refresh in one lookup
        except KeyError:
            pass
        return super().get(key, default)

    def setdefault(self, key, default=None):
        faults.fire("dispatch.cache")
        faults.fire("device.lost")
        record(key)
        # inline rather than super().setdefault(): OrderedDict routes
        # that through the overridden __setitem__, double-counting the
        # insert on the compile counter
        if key in self:
            val = super().__getitem__(key)
        else:
            _note_insert(key)
            super().__setitem__(key, default)
            val = default
        self.move_to_end(key)
        self._evict()
        return val

    def __setitem__(self, key, value):
        if key not in self:
            _note_insert(key)
        super().__setitem__(key, value)
        self.move_to_end(key)
        self._evict()

    def _evict(self) -> None:
        cap = _cache_cap()
        while len(self) > cap:
            self.popitem(last=False)


def first_divergence(base, other):
    """Locate the first divergent dispatch between two traces:
    ``(index, base_entry, other_entry)``; a pure length mismatch after a
    matching prefix returns ``(min_len, None, None)``; identical traces
    return None."""
    n = min(len(base), len(other))
    for i in range(n):
        if base[i] != other[i]:
            return i, base[i], other[i]
    if len(base) != len(other):
        return n, None, None
    return None


def _distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _gather_traces(g) -> Optional[list]:
    """None when every process holds the same (digest, length); else
    every process's trace, in rank order."""
    import torch.distributed as dist
    n = dist.get_world_size()
    allv = [None] * n
    dist.all_gather_object(allv, (g.digest(), len(g.trace)))
    if all(v == allv[0] for v in allv):
        return None
    traces = [None] * n
    dist.all_gather_object(traces, list(g.trace))
    return traces


class SpmdGuard:
    def __init__(self):
        self.trace: List[str] = []

    def record(self, key) -> None:
        c = _canon(key)
        if _canon_check_hook is not None:
            _canon_check_hook(key, c)
        self.trace.append(c)

    def digest(self) -> str:
        h = hashlib.sha1()
        for t in self.trace:
            h.update(t.encode())
            h.update(b"\0")
        return h.hexdigest()

    def verify(self) -> None:
        """Collective check (every process must call it at the same
        point: it is itself a dispatch in the protocol).  Without an
        initialised ``torch.distributed`` there is one process, which
        agrees with itself."""
        if not _distributed():
            return
        traces = _gather_traces(self)
        if traces is None:
            return
        import torch.distributed as dist
        me = dist.get_rank()
        base = traces[0]
        for p, tr in enumerate(traces[1:], start=1):
            div = first_divergence(base, tr)
            if div is None:
                continue
            i, be, te = div
            if be is not None:
                raise DivergenceError(
                    f"SPMD dispatch divergence at index {i}: "
                    f"process 0 dispatched {be} but process "
                    f"{p} dispatched {te} (I am process {me})")
            raise DivergenceError(
                f"SPMD dispatch-count divergence: process 0 made "
                f"{len(base)} dispatches, process {p} made "
                f"{len(tr)} (first {i} agree; I am process {me})")
        raise DivergenceError(
            "SPMD digest mismatch with identical traces: a "
            "canonicalization bug")


_active: Optional[SpmdGuard] = None

#: process-lifetime dispatch counter: every TappedCache lookup (= every
#: dispatch) increments it, guard active or not.  One int add on the hot
#: path.
_dispatches: int = 0


def dispatch_count() -> int:
    """Monotonic count of tapped dispatches in this process."""
    return _dispatches


#: process-lifetime count of tapped-cache inserts.  A first insert of a
#: key is the port's compile moment, so this counter is the recompile
#: detector's raw signal: ``utils.sanitize.zero_recompile`` diffs it,
#: and the armed sanitizer's hook canonicalizes each inserted key to
#: catch value-keyed recompile storms.
_compiles: int = 0

#: set by utils.sanitize.install() when DR_GPU_SANITIZE=1: receives
#: every inserted key.  None keeps the insert path one int add.
_compile_hook = None

#: set by utils.sanitize.install(): receives (key, canon) for every
#: dispatch recorded under an active guard (canon-portability check).
_canon_check_hook = None

#: installed by ``obs.recorder.arm()``: receive every tapped dispatch /
#: cache insert (= compile) as a trace event.  None keeps the
#: tracing-off hot path one ``is not None`` test.
_obs_dispatch_hook = None
_obs_compile_hook = None


def compile_count() -> int:
    """Monotonic count of tapped-cache inserts (= the port's compiles)."""
    return _compiles


def _note_insert(key) -> None:
    global _compiles
    _compiles += 1
    if _compile_hook is not None:
        _compile_hook(key)
    if _obs_compile_hook is not None:
        _obs_compile_hook(key)


def note_compile(key) -> None:
    """Report a compile the insert tap cannot see: the stencils'
    per-block-count entries live under one tapped outer key, as the JAX
    package's inner program dicts do; call this at each such first use
    so the sanitizer's recompile budget covers them too."""
    _note_insert(key)


def active() -> Optional[SpmdGuard]:
    return _active


def record(key) -> None:
    """Called by every TappedCache on each dispatch lookup."""
    global _dispatches
    _dispatches += 1
    if _obs_dispatch_hook is not None:
        _obs_dispatch_hook(key)
    if _active is not None:
        _active.record(key)


@contextmanager
def guard():
    global _active
    prev = _active
    g = SpmdGuard()
    _active = g
    try:
        yield g
    finally:
        _active = prev
