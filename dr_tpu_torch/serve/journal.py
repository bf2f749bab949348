"""Crash-safe resident-state journal for the serving daemon
(counterpart of ``dr_tpu/serve/journal.py``; the same record format).

A daemon restart — planned drain or SIGKILL — used to lose every
tenant's resident containers : the cache lived only in process
memory, so a restarted daemon came back empty and every tenant paid
the rebuild again.  This module makes resident state durable with an
APPEND-ONLY journal of ``put``/``drop`` operations under
``DR_GPU_SERVE_STATE_DIR``: each record carries the op header (tenant,
name, content tag, generation) plus the npy payload bytes, written
with flush+fsync so a SIGKILL after the reply can lose at most the
record being written.  On start the daemon replays the journal into
its resident cache — a crashed or drained replica comes back serving
its tenants' residents bit-equal — then COMPACTS it (the live set
rewritten through the checkpoint.save discipline: same-directory temp
file, fsync, ``os.replace``), so the file length is bounded by the
live residents, not the put history.

Failure contract (fault site ``serve.journal``, chaos-swept):

* **torn tail** — a record cut short by a mid-write kill parses as a
  classified :class:`~..utils.resilience.CheckpointCorruptError`
  (:meth:`Journal.scan`); :meth:`Journal.replay` recovers CLEANLY by
  truncating the file back to the last whole record (counted,
  warned, ``_DR_GPU_SERVE_JOURNAL_TRUNCATED`` marker) — every record
  before the tear replays;
* **corrupt payload** — a crc32 mismatch classifies the same way (a
  bit-flipped resident must never be served as a silent wrong
  answer);
* **generation fence** — :meth:`claim` bumps a generation file
  (atomic replace) when a daemon takes ownership of the state next
  to its socket takeover; every append re-reads it, and a STALE
  daemon — one that lost the takeover race but is still running —
  gets a classified :class:`~..utils.resilience.ProgramError` on its
  next append instead of corrupting the new owner's journal.  The
  daemon treats a fenced journal as fatal: it can never serve.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import struct
import zlib

import numpy as np

from ..utils import faults as _faults
from ..utils import resilience

__all__ = ["Journal", "journal_path", "reset_state"]

#: record prefix: header length (bytes), payload length (bytes),
#: payload crc32 — little-endian u32 each
_PREFIX = struct.Struct("<III")
#: header byte cap: a garbage prefix must not allocate gigabytes
_MAX_HEADER = 1 << 20

#: journal files touched by this process (the tests' fixtures unlink
#: them between tests via reset_state — a test's resident
#: state must not leak into the next test's daemon start)
_touched: set = set()


def journal_path(state_dir: str, socket_path: str) -> str:
    """The journal file for the daemon on ``socket_path``: one file
    per socket under ``state_dir``, named from the socket path so
    replicas on ``<base>.r<i>`` sockets keep disjoint state.  The
    FULL path rides a hash suffix — two unrelated daemons whose
    sockets merely share a basename (one state dir, two run
    directories) must not share a journal or fence each other."""
    full = str(socket_path)
    slug = re.sub(r"[^A-Za-z0-9._-]+", "_",
                  os.path.basename(full)) or "daemon"
    tag = hashlib.sha1(full.encode("utf-8")).hexdigest()[:8]
    return os.path.join(str(state_dir), f"{slug}-{tag}.journal")


def reset_state() -> None:
    """Unlink every journal (and generation) file this process
    touched — the between-test hygiene hook (serve.reset)."""
    for path in list(_touched):
        for p in (path, path + ".gen", path + ".tmp"):
            try:
                if os.path.exists(p):
                    os.unlink(p)
            except OSError:  # pragma: no cover - teardown best effort
                pass
    _touched.clear()


class Journal:
    """One daemon's append-only resident-state journal."""

    def __init__(self, state_dir: str, socket_path: str):
        self.path = journal_path(state_dir, socket_path)
        self.gen_path = self.path + ".gen"
        os.makedirs(str(state_dir), exist_ok=True)
        self.generation = None
        self.fenced = False
        self.appends = 0
        self.replayed = 0
        self.truncated_bytes = 0
        #: (tenant, name) -> tag of entries known durable — lets a
        #: content-identical re-put skip the duplicate append while a
        #: journal that LOST the entry (truncated tail) still re-adds
        self._live: dict = {}
        _touched.add(self.path)

    # ---------------------------------------------------------- generation
    def read_generation(self) -> int:
        try:
            with open(self.gen_path, "r", encoding="utf-8") as fh:
                return int(fh.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def claim(self) -> int:
        """Take ownership of the state: bump the generation file
        (atomic temp+fsync+replace).  Called right after the socket
        takeover — socket ownership and journal ownership must be the
        same decision, or two daemons could both append."""
        gen = self.read_generation() + 1
        tmp = self.gen_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(str(gen))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.gen_path)
        self.generation = gen
        self.fenced = False
        return gen

    def _check_fence(self) -> None:
        """A newer daemon claimed the state since we did: this process
        is STALE and must never write (or serve) again."""
        if self.generation is None:
            raise resilience.ProgramError(
                "serve.journal: append before claim()",
                site="serve.journal")
        if self.read_generation() != self.generation:
            self.fenced = True
            raise resilience.ProgramError(
                f"serve.journal: generation fence — this daemon holds "
                f"generation {self.generation} but "
                f"{self.read_generation()} is current (a newer daemon "
                "took over the socket and the state); a stale daemon "
                "must stop serving", site="serve.journal")

    # -------------------------------------------------------------- append
    def append(self, op: str, tenant: str, name: str, tag: str = "",
               payload: bytes = b"") -> None:
        """Append one durable ``put``/``drop`` record: fence check,
        then write + flush + fsync — after this returns, a SIGKILL
        cannot lose the record."""
        _faults.fire("serve.journal", op=op, name=name)
        self._check_fence()
        header = json.dumps(
            {"op": op, "tenant": tenant, "name": name, "tag": tag,
             "gen": self.generation}).encode("utf-8")
        with open(self.path, "ab") as fh:
            fh.write(_PREFIX.pack(len(header), len(payload),
                                  zlib.crc32(payload)))
            fh.write(header)
            if payload:
                fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        self.appends += 1
        key = (tenant, name)
        if op == "put":
            self._live[key] = tag
        else:
            self._live.pop(key, None)

    def has(self, tenant: str, name: str, tag: str) -> bool:
        """True when a content-identical ``put`` is already durable
        (the re-put fast path skips the duplicate append)."""
        return self._live.get((tenant, name)) == tag

    # --------------------------------------------------------------- read
    def scan(self):
        """Parse every record STRICTLY: yields ``(header, payload,
        end_offset)`` tuples; a torn or corrupt record raises the
        classified :class:`CheckpointCorruptError` (carrying
        ``offset`` — the start of the bad record, i.e. the last good
        end)."""
        out = []
        if not os.path.exists(self.path):
            return out
        with open(self.path, "rb") as fh:
            data = fh.read()
        off = 0
        while off < len(data):
            if off + _PREFIX.size > len(data):
                raise self._corrupt(off, "torn record prefix")
            hlen, plen, crc = _PREFIX.unpack_from(data, off)
            if not 0 < hlen <= _MAX_HEADER:
                raise self._corrupt(off, f"header length {hlen}")
            end = off + _PREFIX.size + hlen + plen
            if end > len(data):
                raise self._corrupt(off, "torn record body")
            try:
                header = json.loads(
                    data[off + _PREFIX.size:
                         off + _PREFIX.size + hlen].decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                raise self._corrupt(off, f"unreadable header ({e})")
            payload = data[off + _PREFIX.size + hlen:end]
            if zlib.crc32(payload) != crc:
                raise self._corrupt(off, "payload crc mismatch")
            out.append((header, payload, end))
            off = end
        return out

    def _corrupt(self, offset: int, why: str):
        err = resilience.CheckpointCorruptError(
            f"serve.journal: {self.path} is corrupt at byte {offset} "
            f"({why}) — truncate back to the last whole record to "
            "recover", site="serve.journal")
        err.offset = offset
        return err

    def replay(self) -> dict:
        """Replay into the live map ``{(tenant, name): (tag, payload
        bytes)}`` applying puts and drops in order.  A torn/corrupt
        TAIL recovers cleanly: the file is truncated back to the last
        whole record (``truncated_bytes`` counts the loss) and every
        record before it replays."""
        _faults.fire("serve.journal", op="replay")
        try:
            records = self.scan()
        except resilience.CheckpointCorruptError as e:
            good = getattr(e, "offset", 0)
            size = os.path.getsize(self.path)
            self.truncated_bytes += size - good
            with open(self.path, "r+b") as fh:
                fh.truncate(good)
            records = self.scan()  # the prefix is whole by construction
        live: dict = {}
        for header, payload, _end in records:
            key = (str(header.get("tenant", "default")),
                   str(header.get("name", "")))
            if header.get("op") == "put":
                live[key] = (str(header.get("tag", "")), payload)
            else:
                live.pop(key, None)
        self.replayed = len(live)
        self._live = {k: tag for k, (tag, _p) in live.items()}
        return live

    def compact(self, live: dict) -> None:
        """Rewrite the journal as exactly the live set, atomically
        (temp + fsync + ``os.replace`` — the checkpoint.save
        discipline): the file stays bounded by the resident set, and
        a kill mid-compaction leaves the previous journal intact."""
        _faults.fire("serve.journal", op="compact")
        self._check_fence()
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "wb") as fh:
                for (tenant, name), (tag, payload) in live.items():
                    header = json.dumps(
                        {"op": "put", "tenant": tenant, "name": name,
                         "tag": tag, "gen": self.generation}
                    ).encode("utf-8")
                    fh.write(_PREFIX.pack(len(header), len(payload),
                                          zlib.crc32(payload)))
                    fh.write(header)
                    fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._live = {k: tag for k, (tag, _p) in live.items()}

    # -------------------------------------------------------------- admin
    def stats(self) -> dict:
        return {"path": self.path, "generation": self.generation,
                "appends": self.appends, "replayed": self.replayed,
                "truncated_bytes": self.truncated_bytes,
                "fenced": self.fenced, "live": len(self._live)}


def decode_payload(payload: bytes) -> np.ndarray:
    """One journal payload back to its array (npy, no pickles — the
    same rule as the wire and the arena)."""
    return np.load(io.BytesIO(payload), allow_pickle=False)
