"""The public re-layout API (counterpart of the ``redistribute`` part of
``dr_tpu/utils/elastic.py``).

Only ``redistribute`` and the in-place state swap are ported; the
elastic shrink and grow, the rescue and the runtime registry come with
the host-side layers (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

__all__ = ["redistribute"]


def redistribute(container, new_dist=None, *, runtime=None):
    """Re-lay ``container`` out in place under ``new_dist`` on ``runtime``
    (default: the global runtime) and return it.

    A ``distributed_vector`` goes through ``parallel/redistribute``: one
    collective exchange when source and target share the device list,
    the host-staged route otherwise; the two leave the same rows.
    ``new_dist`` (a ``block_distribution``, a sizes sequence, or None for
    the even layout) is a vector contract: matrices and mdarrays re-block
    with their default partition on the target runtime, through a
    checkpoint snapshot and rebuild.  In place on purpose: every
    reference to the container (views, halos) stays valid."""
    from ..containers.distributed_vector import distributed_vector
    from ..parallel import runtime as _rt

    rt = runtime or _rt.runtime()
    if isinstance(container, distributed_vector):
        from ..parallel import redistribute as _rdx
        return _rdx.redistribute_vector(container, new_dist, rt)
    if new_dist is not None:
        raise ValueError(
            "explicit block distributions are a distributed_vector "
            "contract; matrices re-block with their default partition "
            "on the target runtime")
    from . import checkpoint as _ck
    meta, arrays = _ck.snapshot(container)
    fresh = _ck.rebuild(meta, arrays, runtime=rt, reblock=True)
    _swap_state(container, fresh)
    return container


def _swap_state(container, fresh) -> None:
    """Adopt ``fresh``'s state into ``container`` in place: the same
    logical value on a new layout.  Only matrices and mdarrays come here
    (a vector re-plans itself through ``_rebind``), and none of them
    holds a reference to itself that the swap would leave on ``fresh``."""
    container.__dict__.clear()
    container.__dict__.update(fresh.__dict__)
