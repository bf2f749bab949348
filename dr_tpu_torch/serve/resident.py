"""Per-tenant resident container cache for the serving daemon
(counterpart of ``dr_tpu/serve/resident.py``).

Every inline request rebuilds its operands as fresh containers —
host->device placement per request, the dominant cost for repeated ops
over the SAME data.  ``put`` builds the container ONCE on the daemon's
dispatch thread and parks it under ``(tenant, name)``; later requests
reference it by name (``refs`` in the frame header) and skip the
rebuild entirely.  ``get`` reads it back, ``drop`` evicts.

Semantics:

* **content-tagged** — ``put`` returns a content tag (sha1 over raw
  bytes + dtype + shape); re-putting identical content under the same
  name is a HIT (no rebuild, the tag proves it), re-putting different
  content replaces the entry;
* **LRU bytes budget** — ``DR_GPU_SERVE_RESIDENT_BYTES`` bounds the
  cache; inserts evict least-recently-used entries, and a single
  value larger than the whole budget is a classified
  :class:`ProgramError` (site ``serve.request``);
* **tenant-scoped** — names are namespaced by tenant: one tenant can
  neither read nor evict-by-name another's data (the LRU sweep is
  global — capacity is a shared resource, isolation is for CONTENT);
* **elastic ride-along** — resident containers are ordinary
  registered containers: a mid-session shrink rescues/restores them
  with everything else, a lost one is POISONED and every later use
  raises the classified ``DeviceLostError`` to the requesting client
  (never a silent wrong answer); grow-backs re-admit them through the
  standard container walk.

Observability: ``serve.resident.hits`` / ``.misses`` / ``.evictions``
counters and the ``serve.resident.bytes`` gauge ride the metrics
registry into ``stats``.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np

from ..obs import metrics as _om
from ..utils import resilience
from ..utils.env import env_int

__all__ = ["ResidentCache", "ResidentStub", "Entry"]

_c_hits = _om.counter("serve.resident.hits")
_c_misses = _om.counter("serve.resident.misses")
_c_evictions = _om.counter("serve.resident.evictions")
_g_bytes = _om.gauge("serve.resident.bytes")


class Entry:
    __slots__ = ("cont", "nbytes", "tag", "shape", "dtype")

    def __init__(self, cont, nbytes, tag, shape, dtype):
        self.cont = cont
        self.nbytes = int(nbytes)
        self.tag = tag
        self.shape = tuple(shape)
        self.dtype = dtype


class ResidentStub(np.ndarray):
    """A shape/dtype stand-in the intake path substitutes for a
    resident reference: validators see an ordinary ndarray of the
    resident's geometry, while the handlers' ``_vec`` resolves
    ``_dr_resident`` to the cached container and never reads the stub
    cells (``np.empty`` — allocation is virtual, content is garbage by
    design)."""

    def __new__(cls, entry: Entry):
        obj = np.empty(entry.shape, entry.dtype).view(cls)
        obj._dr_resident = entry.cont
        return obj


def _content_tag(arr: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr))  # the buffer: no copy
    return h.hexdigest()[:16]


class ResidentCache:
    """The daemon's ``(tenant, name) -> Entry`` LRU.  Thread-safe:
    intake (reader threads) resolves references while the dispatch
    thread puts/evicts."""

    def __init__(self, budget: int = None):
        self.budget = (env_int("DR_GPU_SERVE_RESIDENT_BYTES", 1 << 28)
                       if budget is None else int(budget))
        self._lock = threading.Lock()
        self._entries: "OrderedDict" = OrderedDict()
        self.bytes = 0
        self.puts = 0
        self.put_hits = 0
        self.evictions = 0

    # ------------------------------------------------------------- reads
    def get(self, tenant: str, name: str):
        """The entry, or None (counts the hit/miss either way)."""
        key = (tenant, name)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                _c_misses.add()
                return None
            self._entries.move_to_end(key)
            _c_hits.add()
            return entry

    def require(self, tenant: str, name: str) -> Entry:
        entry = self.get(tenant, name)
        if entry is None:
            raise resilience.ProgramError(
                f"serve: no resident container {name!r} for tenant "
                f"{tenant!r} — put() it first (or it was evicted/"
                "dropped)", site="serve.request")
        return entry

    # ------------------------------------------------------------ writes
    def put(self, tenant: str, name: str, arr) -> "tuple[Entry, bool]":
        """Build-and-park (or re-tag) ``arr`` under ``(tenant,
        name)``; returns ``(entry, cached)`` — ``cached`` True when
        identical content was already resident and no rebuild ran.
        Runs on the dispatch thread (the container build is device
        work)."""
        arr = np.ascontiguousarray(np.asarray(arr, np.float32))
        tag = _content_tag(arr)
        key = (tenant, name)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.tag == tag:
                self._entries.move_to_end(key)
                self.put_hits += 1
                _c_hits.add()
                return entry, True
        if arr.nbytes > self.budget:
            raise resilience.ProgramError(
                f"serve: resident value of {arr.nbytes} bytes exceeds "
                f"the cache budget DR_GPU_SERVE_RESIDENT_BYTES="
                f"{self.budget}", site="serve.request")
        from ..containers.distributed_vector import distributed_vector
        cont = distributed_vector.from_array(arr)
        entry = Entry(cont, arr.nbytes, tag, arr.shape, arr.dtype)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old.nbytes
            self._entries[key] = entry
            self.bytes += entry.nbytes
            self.puts += 1
            # LRU sweep: evict oldest until under budget (never the
            # entry just inserted — it is the newest by construction)
            while self.bytes > self.budget and len(self._entries) > 1:
                _k, victim = self._entries.popitem(last=False)
                self.bytes -= victim.nbytes
                self.evictions += 1
                _c_evictions.add()
            _g_bytes.set(self.bytes)
        return entry, False

    def drop(self, tenant: str, name: str) -> bool:
        with self._lock:
            entry = self._entries.pop((tenant, name), None)
            if entry is None:
                return False
            self.bytes -= entry.nbytes
            _g_bytes.set(self.bytes)
            return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes = 0
            _g_bytes.set(0)

    # -------------------------------------------------------------- admin
    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self.bytes,
                    "budget": self.budget, "puts": self.puts,
                    "put_hits": self.put_hits,
                    "evictions": self.evictions}
