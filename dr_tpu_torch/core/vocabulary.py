"""Core vocabulary: the ``rank`` / ``segments`` / ``local`` customization
points and the range concepts as predicates.

Counterpart of ``dr_tpu/core/vocabulary.py`` (reference
``include/dr/details/ranges.hpp:38-161``, ``concepts/concepts.hpp``):
a ``__dr_rank__``/``__dr_segments__``/``__dr_local__`` method on the
object first, then a ``singledispatch`` registration, then the
documented fallback.  ``local()`` of a segment is a view of the rank's
row tensor on that rank's device.
"""

from __future__ import annotations

from functools import singledispatch
from typing import Any

__all__ = ["rank", "segments", "local", "rank_dispatch",
           "segments_dispatch", "local_dispatch", "is_remote_range",
           "is_distributed_range", "is_remote_contiguous_range",
           "is_distributed_contiguous_range", "has_rank", "has_segments"]


@singledispatch
def rank_dispatch(obj: Any):
    raise TypeError(f"rank() is not available for {type(obj).__name__}")


@singledispatch
def segments_dispatch(obj: Any):
    raise TypeError(f"segments() is not available for {type(obj).__name__}")


@singledispatch
def local_dispatch(obj: Any):
    raise TypeError(f"local() is not available for {type(obj).__name__}")


def rank(obj: Any) -> int:
    """Owning rank of a remote range / segment."""
    if getattr(type(obj), "disable_rank", False):
        raise TypeError(f"rank() disabled for {type(obj).__name__}")
    fn = getattr(obj, "__dr_rank__", None)
    if fn is not None:
        return fn() if callable(fn) else fn
    return rank_dispatch(obj)


def segments(obj: Any):
    """The remote sub-ranges of a distributed range; an empty list is
    the misalignment signal (a zip of misaligned ranges)."""
    fn = getattr(obj, "__dr_segments__", None)
    if fn is not None:
        return list(fn())
    return list(segments_dispatch(obj))


def local(obj: Any):
    """Device-local values of a remote range/segment; the identity for
    host objects."""
    fn = getattr(obj, "__dr_local__", None)
    if fn is not None:
        return fn()
    try:
        return local_dispatch(obj)
    except TypeError:
        return obj


def has_rank(obj: Any) -> bool:
    try:
        rank(obj)
        return True
    except TypeError:
        return False


def has_segments(obj: Any) -> bool:
    return (getattr(obj, "__dr_segments__", None) is not None
            or segments_dispatch.dispatch(type(obj))
            is not segments_dispatch.dispatch(object))


def _is_sized(obj: Any) -> bool:
    try:
        len(obj)
        return True
    except TypeError:
        return False


def is_remote_range(obj: Any) -> bool:
    return _is_sized(obj) and has_rank(obj)


def is_distributed_range(obj: Any) -> bool:
    if not _is_sized(obj) or not has_segments(obj):
        return False
    return all(is_remote_range(s) for s in segments(obj))


def is_remote_contiguous_range(obj: Any) -> bool:
    if not is_remote_range(obj):
        return False
    loc = local(obj)
    return hasattr(loc, "shape") or hasattr(loc, "__array__")


def is_distributed_contiguous_range(obj: Any) -> bool:
    return is_distributed_range(obj) and all(
        is_remote_contiguous_range(s) for s in segments(obj))
