"""Wire protocol for the serving daemon: length-prefixed JSON + npy
(counterpart of ``dr_tpu/serve/protocol.py``; the same frames byte for
byte, so a client of either package can speak to a daemon of the other).

One frame is::

    u32 header_len (big-endian) | header (UTF-8 JSON) | payload bytes

The header's ``nbytes`` list gives the byte length of each npy payload
that follows (``numpy.save`` format, ``allow_pickle=False`` both ways —
a client must never be able to smuggle pickles into the resident
daemon).  Request headers carry ``op`` / ``params`` / ``tenant`` /
``deadline_s`` / optional ``id``; reply headers carry ``ok`` plus
either result fields (``scalar``, echoed ``id``) or a serialized
classified error.

Failure semantics: a clean EOF BETWEEN frames is a normal disconnect
(``recv_frame`` returns ``(None, None)``); EOF MID-frame is a torn
frame and raises a classified :class:`TransientBackendError` — the
wire-level analog of the torn checkpoint write.  Oversized or
malformed headers raise :class:`ProgramError` (deterministic, not
retryable).  Errors cross the wire as ``{"cls", "message", "site"}``
and :func:`raise_error` re-raises them as the matching taxonomy class,
so a client sees the SAME classified exception the daemon caught.
"""

from __future__ import annotations

import io
import json
import struct

import numpy as np

from ..utils import resilience

__all__ = ["send_frame", "recv_frame", "error_header", "raise_error",
           "MAX_HEADER", "MAX_PAYLOAD"]

#: header / single-payload byte caps: a garbage length prefix must not
#: make the daemon allocate gigabytes before the JSON parse can reject
MAX_HEADER = 1 << 20
MAX_PAYLOAD = 1 << 28


def _recv_exact(sock, n: int):
    """Exactly ``n`` bytes from ``sock``, or None on EOF at offset 0;
    a mid-read EOF raises the torn-frame transient."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise resilience.TransientBackendError(
                f"serve: connection closed mid-frame ({len(buf)}/{n} "
                "bytes read — torn wire frame)", site="serve.request")
        buf += chunk
    return bytes(buf)


def send_frame(sock, header: dict, arrays=()) -> None:
    """Serialize and send one frame (header + npy payloads)."""
    payloads = []
    for a in arrays:
        bio = io.BytesIO()
        np.save(bio, np.asarray(a), allow_pickle=False)
        payloads.append(bio.getvalue())
    header = dict(header)
    header["nbytes"] = [len(p) for p in payloads]
    hb = json.dumps(header).encode("utf-8")
    if len(hb) > MAX_HEADER:
        raise resilience.ProgramError(
            f"serve: frame header is {len(hb)} bytes (cap {MAX_HEADER})",
            site="serve.request")
    sock.sendall(struct.pack(">I", len(hb)) + hb + b"".join(payloads))


def recv_frame(sock):
    """Receive one frame: ``(header, [np.ndarray, ...])``.

    ``(None, None)`` on a clean EOF before any frame byte; classified
    errors on torn/oversized/malformed frames (see module docstring).
    """
    raw = _recv_exact(sock, 4)
    if raw is None:
        return None, None
    (hlen,) = struct.unpack(">I", raw)
    if hlen == 0 or hlen > MAX_HEADER:
        raise resilience.ProgramError(
            f"serve: frame header length {hlen} outside (0, {MAX_HEADER}]",
            site="serve.request")
    hb = _recv_exact(sock, hlen)
    if hb is None:
        # EOF right after the length prefix: a torn frame (retryable
        # connection drop), NOT a malformed header
        raise resilience.TransientBackendError(
            "serve: connection closed after the length prefix "
            "(torn wire frame)", site="serve.request")
    try:
        header = json.loads(hb.decode("utf-8"))
    except Exception as e:
        raise resilience.ProgramError(
            f"serve: malformed frame header ({e!r})", site="serve.request")
    if not isinstance(header, dict):
        raise resilience.ProgramError(
            "serve: frame header is not a JSON object",
            site="serve.request")
    arrays = []
    for nb in header.get("nbytes", []):
        nb = int(nb)
        if nb <= 0 or nb > MAX_PAYLOAD:
            raise resilience.ProgramError(
                f"serve: payload length {nb} outside (0, {MAX_PAYLOAD}]",
                site="serve.request")
        blob = _recv_exact(sock, nb)
        if blob is None:
            raise resilience.TransientBackendError(
                "serve: connection closed before its declared payload "
                "(torn wire frame)", site="serve.request")
        try:
            arrays.append(np.load(io.BytesIO(blob), allow_pickle=False))
        except Exception as e:
            raise resilience.ProgramError(
                f"serve: undecodable npy payload ({e!r})",
                site="serve.request")
    return header, arrays


def error_header(err, **extra) -> dict:
    """Reply header carrying ``err`` classified for the wire."""
    ce = resilience.classified(err)
    hdr = {"ok": False,
           "error": {"cls": type(ce).__name__, "message": str(ce),
                     "site": ce.site}}
    hdr.update(extra)
    return hdr


def raise_error(header: dict):
    """Re-raise the classified error a reply header carries.  An
    unknown class name degrades to :class:`ProgramError` — the
    deterministic bucket — instead of guessing retryability."""
    info = header.get("error") or {}
    cls = getattr(resilience, str(info.get("cls", "")), None)
    if not (isinstance(cls, type)
            and issubclass(cls, resilience.ResilienceError)):
        cls = resilience.ProgramError
    raise cls(str(info.get("message", "serve: unspecified daemon error")),
              site=str(info.get("site", "")))
