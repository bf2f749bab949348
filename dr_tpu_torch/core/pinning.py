"""Identity-stable cache keys (counterpart of ``dr_tpu/core/pinning.py``).

The port's dispatch caches (``utils/spmd_guard.TappedCache``) key on the
identity of Python objects: user callables, the runtime's rank list.  A
raw ``id()`` is only stable while the object lives; once collected, the
id can be recycled by a later allocation and alias a different object's
cache entry.  ``pinned_id`` returns the id and pins the object, so a
live cache key is never recycled.

Pins are a bounded LRU (``DR_GPU_PIN_CAP``, default 65536, floor 1024).
Eviction is amortized: the table may overshoot the cap by 25% before a
batch eviction brings it back.  Every dispatch rebuilds its key through
``pinned_id``, so a hot object's pin stays recent.  When a pin is
evicted, every registered cache drops the entries whose keys reference
that identity (``register_cache``), so a recycled id never aliases a
stale entry.
"""

import weakref
from collections import OrderedDict

from ..utils.env import env_int

_pins: "OrderedDict[int, object]" = OrderedDict()
_caches: list = []  # weakref.ref of registered program caches


class PinnedId(int):
    """An ``int`` that knows it is an object identity.  Hashing and
    equality are inherited (cache keys behave exactly as before); the
    distinct TYPE lets consumers that compare keys ACROSS processes
    (utils/spmd_guard) canonicalize identities away without guessing
    from magnitude: ids are process-local, structure is not."""

    __slots__ = ()


def register_cache(cache) -> None:
    """Program caches register so pin eviction can purge the entries
    that reference the evicted identity (utils/spmd_guard.TappedCache
    does this on construction).  Held by weakref: dict subclasses are
    unhashable, so a WeakSet cannot hold them — a ref list can."""
    _caches.append(weakref.ref(cache))


def _key_mentions(key, idents) -> bool:
    if isinstance(key, PinnedId):
        return int(key) in idents
    if isinstance(key, (tuple, list, frozenset)):
        return any(_key_mentions(part, idents) for part in key)
    return False


def _purge(idents) -> None:
    live = []
    for ref in _caches:
        cache = ref()
        if cache is None:
            continue  # cache itself was collected; drop the ref
        live.append(ref)
        stale = [k for k in cache if _key_mentions(k, idents)]
        for k in stale:
            del cache[k]
    _caches[:] = live


def release(obj) -> None:
    """Unpin ``obj`` and drop every cache entry whose key references it
    (the elastic layer calls this for a runtime a shrink or a grow
    replaced: no key over its ranks can match again, and a plan entry
    holds a CUDA graph and its private memory pool)."""
    i = id(obj)
    if _pins.get(i) is obj:
        del _pins[i]
    _purge({i})


def pinned_id(obj):
    """Stable identity key for ``obj`` (None passes through)."""
    if obj is None:
        return None
    i = id(obj)
    _pins[i] = obj          # insert or refresh
    _pins.move_to_end(i)
    cap = env_int("DR_GPU_PIN_CAP", 65536, floor=1024)
    # Amortized batch eviction: let the table overshoot by 25%, then
    # evict down to cap with ONE scan of the registered caches for the
    # whole batch.  Per-dispatch purge cost for identity-churning
    # workloads is O(total cached keys / (cap/4)) instead of a full
    # scan per dispatch.  The trigger depends only on dict length, so
    # SPMD processes evicting in dispatch order stay identical.
    if len(_pins) > cap + (cap >> 2):
        evicted = set()
        while len(_pins) > cap:
            old, _ = _pins.popitem(last=False)
            evicted.add(old)
        _purge(evicted)
    return PinnedId(i)
