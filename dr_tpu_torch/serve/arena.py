"""Shared-memory tensor arena for the serving data plane (counterpart of
``dr_tpu/serve/arena.py``).

The inline wire serializes every tensor into the socket frame: npy
encode, kernel copy in, kernel copy out, npy decode — four traversals
of the payload per direction.  The arena moves the bulk bytes ONCE:
the daemon owns a ``multiprocessing.shared_memory`` segment, clients
write npy payloads straight into leased slots, and the protocol frame
carries only metadata plus an arena handle (move bytes once, bound
peak memory).

Handle lifecycle::

    arena_alloc (wire op) ──> slot leased (refs=1, generation bumped)
        client writes npy bytes at the slot's offset
    request frame carries {"slot", "generation", "len"}
        daemon maps (generation checked), decodes, releases
    reply results ride daemon-allocated slots the same way;
        the client releases them (piggybacked on its next frame,
        or wholesale when its connection closes)

Safety contract:

* **generation tags** — every lease of a slot id bumps its generation;
  a handle whose generation does not match the live lease (a recycled
  slot) is a classified :class:`ProgramError` (site ``arena.map``) —
  a stale handle can NEVER read another request's bytes;
* **ref-counted slots** — ``release`` drops a reference, the range is
  recycled at zero; every slot is owned by the connection that leased
  it, and a client crash releases its slots wholesale (the daemon's
  disconnect teardown), so a dead client cannot leak the arena dry;
* **exhaustion is a transient** — an ``alloc`` that does not fit
  raises :class:`TransientBackendError` (site ``arena.map``); the
  client absorbs it by falling back to the inline wire for that
  request (the inline wire is a transport, not a route off the device:
  the arena is an optimization, never a correctness dependency);
* ``arena.map`` / ``arena.release`` are registered fault sites: the
  chaos tests drive both against a live daemon.

Observability: ``serve.arena.mapped_bytes`` / ``serve.arena.maps`` /
``serve.arena.fallbacks`` counters and the ``serve.arena.in_use``
gauge ride the metrics registry into ``stats``.  A fallback to the
inline wire is counted and logged through ``drlog``.
"""

from __future__ import annotations

import io
import threading
from typing import Optional

import numpy as np

from ..obs import metrics as _om
from ..utils import faults as _faults
from ..utils import resilience
from ..utils.env import env_int
from ..utils.logging import drlog

__all__ = ["Arena", "ClientArena", "attach", "npy_bytes", "load_npy",
           "ALIGN"]

#: slot alignment (cache-line multiple; npy headers are 64-padded too)
ALIGN = 64

#: segment names CREATED by this process (Arena.__init__): an attach
#: to one of these must NOT unregister it from the resource tracker —
#: in-process clients (tests, the smoke run) would steal the creator's entry
#: and the final unlink would log a tracker KeyError
_OWNED: set = set()
#: one attach at a time: the tracker keeps a SET of names, so two
#: threads' register, register, unregister, unregister of one segment
#: would unregister a name it no longer holds and log a KeyError
_attach_lock = threading.Lock()

_c_maps = _om.counter("serve.arena.maps")
_c_mapped_bytes = _om.counter("serve.arena.mapped_bytes")
_c_fallbacks = _om.counter("serve.arena.fallbacks")
_g_in_use = _om.gauge("serve.arena.in_use")


def npy_bytes(arr) -> bytes:
    """``arr`` in npy format (``allow_pickle=False`` — the same
    no-pickles rule as the inline wire)."""
    bio = io.BytesIO()
    np.save(bio, np.asarray(arr), allow_pickle=False)
    return bio.getvalue()


def load_npy(buf) -> np.ndarray:
    """Decode one npy payload from ``buf`` (bytes/memoryview)."""
    try:
        return np.load(io.BytesIO(bytes(buf)), allow_pickle=False)
    except Exception as e:
        raise resilience.ProgramError(
            f"arena: undecodable npy payload ({e!r})", site="arena.map")


class _Slot:
    __slots__ = ("sid", "offset", "nbytes", "generation", "refs",
                 "owner")

    def __init__(self, sid, offset, nbytes, generation, owner):
        self.sid = sid
        self.offset = offset
        self.nbytes = nbytes
        self.generation = generation
        self.refs = 1
        self.owner = owner


class Arena:
    """The daemon-side arena: ONE shared-memory segment plus the slot
    table.  Thread-safe (reader threads lease/map, the dispatch thread
    writes replies, disconnect teardown releases wholesale)."""

    def __init__(self, nbytes: Optional[int] = None):
        from multiprocessing import shared_memory
        self.size = (env_int("DR_GPU_SERVE_ARENA_BYTES", 1 << 26)
                     if nbytes is None else int(nbytes))
        self._shm = shared_memory.SharedMemory(create=True,
                                               size=self.size)
        self.name = self._shm.name
        _OWNED.add(self.name)
        self._lock = threading.Lock()
        self._slots: dict = {}          # sid -> _Slot
        self._gens: dict = {}           # sid -> last generation leased
        self._free = [(0, self.size)]   # sorted (offset, size) ranges
        #: released slot ids, recycled FIRST: generations actually
        #: engage (a stale handle meets its old sid at a new
        #: generation) and _gens stays bounded by the slot high-water
        #: mark instead of growing one entry per alloc forever
        self._free_sids: list = []
        self._next_sid = 0
        self.in_use = 0
        self.high_water = 0
        self.allocs = 0
        self.exhaustions = 0

    # ------------------------------------------------------------ ranges
    def _take_range(self, need: int) -> Optional[int]:
        """First-fit over the free list (caller holds the lock)."""
        for i, (off, size) in enumerate(self._free):
            if size >= need:
                if size == need:
                    del self._free[i]
                else:
                    self._free[i] = (off + need, size - need)
                return off
        return None

    def _give_range(self, off: int, size: int) -> None:
        """Insert and coalesce (caller holds the lock)."""
        free = self._free
        lo, hi = 0, len(free)
        while lo < hi:
            mid = (lo + hi) // 2
            if free[mid][0] < off:
                lo = mid + 1
            else:
                hi = mid
        free.insert(lo, (off, size))
        # coalesce with neighbours
        if lo + 1 < len(free) and off + size == free[lo + 1][0]:
            free[lo] = (off, size + free[lo + 1][1])
            del free[lo + 1]
        if lo > 0 and free[lo - 1][0] + free[lo - 1][1] == off:
            free[lo - 1] = (free[lo - 1][0],
                            free[lo - 1][1] + free[lo][1])
            del free[lo]

    # ------------------------------------------------------------- leases
    def alloc(self, nbytes: int, owner=None) -> dict:
        """Lease a slot of at least ``nbytes``; returns the handle the
        wire carries (``slot`` / ``generation`` / ``offset`` /
        ``nbytes``).  Exhaustion raises the classified transient the
        client's inline fallback absorbs."""
        _faults.fire("arena.map", op="alloc", nbytes=int(nbytes))
        need = max(ALIGN, (int(nbytes) + ALIGN - 1) // ALIGN * ALIGN)
        with self._lock:
            off = self._take_range(need)
            if off is None:
                self.exhaustions += 1
                raise resilience.TransientBackendError(
                    f"arena: exhausted ({self.in_use}/{self.size} bytes"
                    f" leased, {need} requested) — fall back to the "
                    "inline wire and release outstanding handles",
                    site="arena.map")
            if self._free_sids:
                sid = self._free_sids.pop()
            else:
                sid = self._next_sid
                self._next_sid += 1
            gen = self._gens.get(sid, 0) + 1
            self._gens[sid] = gen
            self._slots[sid] = _Slot(sid, off, need, gen, owner)
            self.in_use += need
            self.high_water = max(self.high_water, self.in_use)
            self.allocs += 1
            _g_in_use.set(self.in_use)
            return {"slot": sid, "generation": gen, "offset": off,
                    "nbytes": need}

    def _live(self, handle: dict, site: str) -> _Slot:
        try:
            sid = int(handle["slot"])
            gen = int(handle["generation"])
        except (KeyError, TypeError, ValueError):
            raise resilience.ProgramError(
                f"arena: malformed handle {handle!r}", site=site)
        slot = self._slots.get(sid)
        if slot is None or slot.generation != gen or slot.refs <= 0:
            raise resilience.ProgramError(
                f"arena: stale handle (slot {sid} generation {gen} is "
                "not leased — the slot was released and recycled)",
                site=site)
        return slot

    def view(self, handle: dict, length: Optional[int] = None):
        """The slot's writable memoryview (generation-checked)."""
        with self._lock:
            slot = self._live(handle, "arena.map")
            n = slot.nbytes if length is None else int(length)
            if n < 0 or n > slot.nbytes:
                raise resilience.ProgramError(
                    f"arena: declared length {n} exceeds the slot's "
                    f"{slot.nbytes}-byte lease", site="arena.map")
            return self._shm.buf[slot.offset:slot.offset + n]

    def map(self, handle: dict) -> np.ndarray:
        """Decode the npy payload a handle points at (the daemon-side
        request intake path).  Fault site ``arena.map``."""
        _faults.fire("arena.map", op="map")
        n = int(handle.get("len", 0))
        arr = load_npy(self.view(handle, n))
        _c_maps.add()
        _c_mapped_bytes.add(n)
        return arr

    def put(self, data: bytes, owner=None) -> dict:
        """Lease + write in one step (the daemon's reply path); the
        returned handle carries ``len`` = the real payload length."""
        handle = self.alloc(len(data), owner=owner)
        self._shm.buf[handle["offset"]:handle["offset"] + len(data)] = \
            data
        handle["len"] = len(data)
        return handle

    def retain(self, handle: dict) -> None:
        with self._lock:
            self._live(handle, "arena.map").refs += 1

    def release(self, handle: dict) -> None:
        """Drop one reference; the range recycles at zero.  Fault site
        ``arena.release``; a bad handle is classified — a double
        release must not silently free a RE-leased slot."""
        _faults.fire("arena.release")
        with self._lock:
            slot = self._live(handle, "arena.release")
            slot.refs -= 1
            if slot.refs <= 0:
                del self._slots[slot.sid]
                self._free_sids.append(slot.sid)
                self.in_use -= slot.nbytes
                self._give_range(slot.offset, slot.nbytes)
                _g_in_use.set(self.in_use)

    def release_owner(self, owner) -> int:
        """Release every slot ``owner`` holds (disconnect teardown —
        a crashed client cannot leak the arena dry).  Returns the
        count released.  Never raises."""
        freed = 0
        with self._lock:
            for sid in [s for s, slot in self._slots.items()
                        if slot.owner is owner]:
                slot = self._slots.pop(sid)
                self._free_sids.append(sid)
                self.in_use -= slot.nbytes
                self._give_range(slot.offset, slot.nbytes)
                freed += 1
            if freed:
                _g_in_use.set(self.in_use)
        return freed

    # -------------------------------------------------------------- admin
    def stats(self) -> dict:
        with self._lock:
            return {"size": self.size, "in_use": self.in_use,
                    "high_water": self.high_water,
                    "slots": len(self._slots), "allocs": self.allocs,
                    "exhaustions": self.exhaustions}

    def destroy(self) -> None:
        """Close AND unlink the segment (daemon teardown)."""
        _OWNED.discard(self.name)
        try:
            self._shm.close()
            self._shm.unlink()
        except (OSError, FileNotFoundError):  # pragma: no cover
            pass


def attach(name: str):
    """Attach to an existing segment by name.  Python 3.10's
    ``SharedMemory`` registers even ATTACH-mode segments with the
    resource tracker, which then unlinks the daemon's live arena when
    the CLIENT exits — unregister FOREIGN attaches so only the
    creating daemon owns the segment's lifetime (an attach to a
    segment this very process created keeps the creator's one
    registration intact)."""
    from multiprocessing import shared_memory
    with _attach_lock:
        shm = shared_memory.SharedMemory(name=name)
        if name not in _OWNED:
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(shm._name, "shared_memory")
            # best effort: an unregister miss only re-arms the tracker's
            # own (noisy but harmless) cleanup
            except Exception:  # pragma: no cover - tracker internals moved
                pass
    return shm


class ClientArena:
    """The client-side view of a daemon's arena: attach by name, write
    request payloads into leased slots, read reply payloads out.  The
    client LEASES over the wire (``arena_alloc``) and only touches
    bytes here — generation checks stay on the daemon."""

    def __init__(self, name: str, size: int):
        self.name = name
        self.size = int(size)
        self._shm = attach(name)

    def write(self, handle: dict, data: bytes) -> dict:
        """Write ``data`` into the leased slot; returns the handle
        with ``len`` stamped (what the request frame carries)."""
        off, cap = int(handle["offset"]), int(handle["nbytes"])
        if len(data) > cap:
            raise resilience.ProgramError(
                f"arena: payload of {len(data)} bytes exceeds the "
                f"{cap}-byte lease", site="arena.map")
        self._shm.buf[off:off + len(data)] = data
        out = dict(handle)
        out["len"] = len(data)
        return out

    def read(self, handle: dict) -> np.ndarray:
        """Decode the npy payload a REPLY handle points at."""
        off, n = int(handle["offset"]), int(handle["len"])
        if off < 0 or n < 0 or off + n > self.size:
            raise resilience.ProgramError(
                f"arena: reply handle {handle!r} is outside the "
                f"{self.size}-byte segment", site="arena.map")
        return load_npy(self._shm.buf[off:off + n])

    def close(self) -> None:
        try:
            self._shm.close()
        except (OSError, BufferError):  # pragma: no cover
            pass


def note_fallback(reason: str) -> None:
    """Count and log an arena -> inline-wire fallback: the bytes take
    the socket instead of shared memory, the request runs unchanged."""
    _c_fallbacks.add()
    drlog.debug("serve.arena: {}", reason)


def fallbacks() -> int:
    """Arena -> inline-wire fallbacks counted in this process."""
    return _c_fallbacks.value
