"""Persisted tuning database: measured config winners as data
(counterpart of ``dr_tpu/tuning.py``).

A per-op config with a code default (the SpMV format, the join's
merge-route threshold, the relational capacity ratios) can be replaced
by a measured winner without a code edit: :func:`record` writes it,
the dispatch-time pickers read it with :func:`lookup`, the code default
as fallback.

Keying is canon-portable: an entry is
``domain.param@backend=<cpu|cuda>,kind=<device name>,nshards=<p>``.
``kind`` is the CUDA device's name with spaces as ``_`` (``cpu`` for
CPU ranks), so a winner measured on one card model or one rank count
never applies to another, and a CPU record never to a card.  The JAX
package's ``x64`` field has no PyTorch counterpart (a tensor carries
its own dtype; there is no process-wide 64-bit switch) and is not part
of the key.  Lookups match the current context exactly; before
``init()`` the context is the unmatched ``backend="none"``, and
:func:`context` never initialises the runtime or CUDA.

Storage is one JSON file, ``{"version": 1, "entries": {...}}``:
``DR_GPU_TUNING_DB`` names it, else it lives at
``$DR_GPU_TUNING_DIR/tuning_db.json``; with neither set the persisted
layer is off.  Writes are an atomic read-modify-write (temp file and
``os.replace``), last writer wins per key, and reads reload when the
file's mtime moves.  A missing, corrupt or unreadable file applies the
code defaults and warns once per path (:class:`TuningDBWarning`): it
is a config read, so no dispatch changes route because of it.

Two layers answer a lookup, freshest first:

1. the session overlay (:func:`note`): in-process observations, such as
   the capacity ratio an auto relational op measured; never persisted;
2. the persisted entries.

At every picker an explicit ``DR_GPU_*`` pin beats the DB, and the DB
beats the code default; a value of the wrong type in the DB is ignored.

In a multi-process runtime (``init_distributed``) every process holds
the single controller's answer.  A :func:`lookup` is collective: every
process reads its own overlay and store, and one small gather through
``parallel/collectives`` hands every process process 0's answer, so a
route picked from the DB is the same on every process.  A :func:`note`
updates every process's overlay (the noted values are computed from
global counts, equal everywhere).  A :func:`record` writes the file
from process 0 alone, as ``checkpoint.save`` does, and one gather of
its outcome gives every process the same return value; every process
updates its overlay.  The context key names the device model and the
rank count, not a device index, so it is the same on every process of a
host.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Optional

from .parallel import runtime as _rt_mod
from .utils.env import env_str

__all__ = ["lookup", "record", "note", "context", "context_key",
           "db_path", "enabled", "reload", "clear_session",
           "TuningDBWarning"]


class TuningDBWarning(UserWarning):
    """The tuning DB could not be read or written; code defaults apply."""


_lock = threading.Lock()
_cache: Optional[dict] = None
_cache_path: Optional[str] = None
_cache_mtime: float = -1.0
_warned_paths: set = set()
_session: dict = {}
#: CUDA device index -> its name with spaces as "_"
_kinds: dict = {}


def db_path() -> str:
    """The persisted DB file, or "" when no store is armed."""
    p = env_str("DR_GPU_TUNING_DB")
    if p:
        return p
    d = env_str("DR_GPU_TUNING_DIR")
    return os.path.join(d, "tuning_db.json") if d else ""


def enabled() -> bool:
    """True when a persisted store is armed; the session overlay works
    either way."""
    return bool(db_path())


def _kind(dev) -> str:
    if dev.type != "cuda":
        return dev.type
    k = _kinds.get(dev.index)
    if k is None:
        import torch
        k = _kinds[dev.index] = torch.cuda.get_device_name(
            dev.index).replace(" ", "_")
    return k


def context() -> dict:
    """The current runtime's tag: ``backend`` (rank 0's device type),
    ``kind`` (its device name) and ``nshards``.  Never initialises the
    runtime: before ``init()`` it is ``backend="none"``.  A CUDA runtime
    has touched its cards already, so reading the name starts nothing."""
    from .parallel import runtime as _rt
    if not _rt.is_initialized():
        return {"backend": "none", "kind": "none", "nshards": 0}
    r = _rt.runtime()
    d0 = r.devices[0]
    return {"backend": d0.type, "kind": _kind(d0), "nshards": r.nprocs}


def context_key(domain: str, param: str, ctx: Optional[dict] = None) -> str:
    c = context() if ctx is None else ctx
    return (f"{domain}.{param}@backend={c.get('backend', 'none')},"
            f"kind={str(c.get('kind', 'none')).replace(' ', '_')},"
            f"nshards={int(c.get('nshards', 0))}")


def _warn_once(path: str, msg: str) -> None:
    if path not in _warned_paths:
        _warned_paths.add(path)
        warnings.warn(msg, TuningDBWarning, stacklevel=3)


def _load() -> dict:
    """The persisted entries, reloaded when the file's mtime moves (a
    write by another process shows without a restart).  Any read
    failure warns once per path and applies the code defaults."""
    global _cache, _cache_path, _cache_mtime
    path = db_path()
    with _lock:
        try:
            mtime = os.path.getmtime(path) if path else -1.0
        except OSError:
            mtime = -1.0
        if _cache is not None and _cache_path == path \
                and _cache_mtime == mtime:
            return _cache
        _cache_path, _cache_mtime = path, mtime
        _cache = {}
        if not path or mtime < 0:
            return _cache
        try:
            with open(path, encoding="utf-8") as fh:
                raw = json.load(fh)
            ent = raw.get("entries") if isinstance(raw, dict) else None
            if not isinstance(ent, dict):
                raise ValueError("no 'entries' table")
            _cache = ent
        except Exception as e:
            _warn_once(path, f"tuning DB at {path!r} is unreadable "
                             f"({e!r}); code defaults apply")
            _cache = {}
        return _cache


def reload() -> None:
    """Drop the read cache (tests; a long-lived process after a sweep)."""
    global _cache
    with _lock:
        _cache = None


def clear_session() -> None:
    """Drop the in-process overlay."""
    _session.clear()


def _agreed(local_hit: bool, value, default):
    """Process 0's ``(hit, value)`` on every process of a multi-process
    runtime (one gather of its JSON form through ``collectives``); the
    local answer with one controller.  A miss takes each process's own
    ``default`` (the same argument on every process)."""
    rt = _rt_mod.mp_runtime()
    if rt is None:
        return value if local_hit else default
    import torch
    from .parallel import collectives
    mine = None
    if rt.process_index == 0:
        blob = json.dumps([bool(local_hit), value if local_hit else None])
        mine = torch.frombuffer(bytearray(blob.encode()), dtype=torch.uint8)
    [got] = collectives.gather_ranks(
        [mine if rt.owners[r] == rt.process_index else None
         for r in range(rt.nprocs)], torch.device("cpu"), ranks=[0])
    hit, v = json.loads(bytes(got.cpu().numpy()).decode())
    return v if hit else default


def lookup(domain: str, param: str, default=None,
           ctx: Optional[dict] = None):
    """The measured value of ``domain.param`` under the current (or
    given) context, or ``default``: the session overlay first, then the
    persisted store.  Collective in a multi-process runtime: every
    process takes process 0's answer."""
    key = context_key(domain, param, ctx)
    if key in _session:
        return _agreed(True, _session[key], default)
    ent = _load().get(key)
    if isinstance(ent, dict):
        return _agreed(True, ent.get("value", default), default)
    return _agreed(ent is not None, ent, default)


def note(domain: str, param: str, value, ctx: Optional[dict] = None) -> str:
    """Record an in-process observation (session overlay only; every
    process of a multi-process runtime notes its own, the same value).
    Returns the key."""
    key = context_key(domain, param, ctx)
    _session[key] = value
    return key


def record(domain: str, param: str, value, ctx: Optional[dict] = None,
           source: str = "") -> Optional[str]:
    """Persist a measured winner: atomic read-modify-write, last writer
    wins per key, the context baked into the key.  With no store armed
    the value still lands in the session overlay.  Returns the key
    written (None: overlay only).  Collective in a multi-process
    runtime: process 0 writes, every process notes the value and
    returns process 0's outcome."""
    c = context() if ctx is None else ctx
    key = context_key(domain, param, c)
    _session[key] = value
    path = db_path()
    if not path:
        return None
    rt = _rt_mod.mp_runtime()
    wrote = _write(path, key, domain, param, value, c, source) \
        if rt is None or rt.process_index == 0 else False
    return key if _agreed(True, wrote, False) else None


def _write(path, key, domain, param, value, c, source) -> bool:
    """The atomic read-modify-write of one entry; False (warned) when
    the store cannot be written."""
    global _cache
    with _lock:
        try:
            raw = {}
            if os.path.exists(path):
                try:
                    with open(path, encoding="utf-8") as fh:
                        raw = json.load(fh)
                except Exception:
                    raw = {}  # a corrupt store is rebuilt from here on
            ent = raw.get("entries") if isinstance(raw, dict) else None
            if not isinstance(ent, dict):
                ent = {}
            ent[key] = {"value": value, "domain": domain, "param": param,
                        "context": dict(c), "source": source,
                        "recorded_at": round(time.time(), 3)}
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump({"version": 1, "entries": ent}, fh, indent=1,
                          sort_keys=True)
                fh.write("\n")
            os.replace(tmp, path)
            _cache = None
        except OSError as e:
            warnings.warn(f"tuning DB write to {path!r} failed ({e!r}); "
                          "the winner is kept in-process only",
                          TuningDBWarning, stacklevel=3)
            return False
    return True
