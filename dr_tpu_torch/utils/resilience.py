"""The classified failure taxonomy (counterpart of
``dr_tpu/utils/resilience.py``), as far as the ported algorithms raise
it: :class:`ProgramError`, a deterministic program or user error that no
retry can cure (a relational result larger than its output containers),
and its :class:`CheckpointCorruptError`, a truncated, corrupt or
newer-format checkpoint file.

Not carried over yet: the other classes, retry, deadlines and the trace
tail a classified error carries; they come with the faults layer.
"""

from __future__ import annotations

__all__ = ["ResilienceError", "ProgramError", "CheckpointCorruptError"]


class ResilienceError(RuntimeError):
    """Base of the classified failure taxonomy.  ``site`` names the site
    that raised (empty when there is none)."""

    def __init__(self, message: str, *, site: str = ""):
        super().__init__(message)
        self.site = site


class ProgramError(ResilienceError):
    """Deterministic program/user error: retrying is futile; surface."""


class CheckpointCorruptError(ProgramError):
    """A checkpoint file is truncated, corrupt or foreign: the classified
    answer to a torn write (``utils/checkpoint.py``)."""
