"""``drlog``: the framework logger (counterpart of
``dr_tpu/utils/logging.py``; reference ``lib::drlog``,
``include/dr/details/logger.hpp:7-49``).

One global logger with a file sink (the reference writes ``dr.{rank}.log``
per MPI rank: with one controller the process writes one file, and in a
multi-process runtime ``set_file`` puts the process index before the
extension, so each process writes its own),
``debug(fmt, ...)`` with a call-site prefix, and a disabled mode that
costs one flag test.  Set ``DR_GPU_LOG`` to a non-empty value to log to
standard error, or call ``set_file(path)``.  While tracing is armed
(``dr_tpu_torch.obs``), every debug line is also a ``log.debug`` event
of the trace, whether the sink is on or not.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, TextIO

from ..obs import recorder as _obs
from .env import env_str

__all__ = ["drlog", "Logger"]


class Logger:
    def __init__(self):
        self._sink: Optional[TextIO] = None
        self._enabled = bool(env_str("DR_GPU_LOG"))

    def set_file(self, path: str) -> None:
        """Append to ``path`` from now on (README.rst:101-107); in a
        multi-process runtime to ``<root>.<process index><ext>``."""
        from ..parallel import runtime as _rt
        rt = _rt.mp_runtime()
        if rt is not None:
            root, ext = os.path.splitext(path)
            path = f"{root}.{rt.process_index}{ext}"
        self.close()
        self._sink = open(path, "a")
        self._enabled = True

    def enabled(self) -> bool:
        return self._enabled

    def debug(self, fmt: str, *args, **kw) -> None:
        """``debug(fmt, ...)`` with the caller's file:line as prefix
        (logger.hpp:13-28); while tracing is armed, also a ``log.debug``
        instant event with ``loc`` and the first 200 characters of the
        message."""
        traced = _obs._armed
        if not self._enabled and not traced:
            return
        frame = sys._getframe(1)
        loc = (f"{os.path.basename(frame.f_code.co_filename)}:"
               f"{frame.f_lineno}")
        msg = fmt.format(*args, **kw) if (args or kw) else fmt
        if traced:
            _obs.event("log.debug", cat="log", loc=loc, msg=msg[:200])
        if not self._enabled:
            return
        line = f"[{loc}] {msg}\n"
        if self._sink is not None:
            self._sink.write(line)
            self._sink.flush()
        else:
            sys.stderr.write("drlog " + line)

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None


#: the global logger (the reference's ``lib::drlog``)
drlog = Logger()
