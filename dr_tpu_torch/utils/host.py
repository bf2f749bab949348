"""Host materialization that is valid on every process (counterpart of
``dr_tpu/utils/host.py``).

With one controller every rank's rows live in the process, and a host
read is a device-to-host copy.  In a multi-process runtime
(``collectives.init_distributed``) each process holds only its own
ranks' rows, so a global read gathers every rank's cells into host
memory through the collectives and assembles them in rank order: the
analogue of the reference's gather-to-root, except that the result is
valid on every process (the JAX package's ``process_allgather``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..containers.distributed_vector import (_host_numpy, _plan_flush,
                                             distributed_vector)
from ..parallel import collectives

__all__ = ["to_host"]


def to_host(arr) -> np.ndarray:
    """The global value of ``arr`` as a numpy array, on every process.

    ``arr`` is a ``distributed_vector`` (its logical value), a list of
    per-rank shards (concatenated along axis 0 in rank order; None for
    a rank another process owns), a tensor, or anything with a
    ``to_array()`` (a view; a tuple for a zip)."""
    cpu = torch.device("cpu")
    if isinstance(arr, distributed_vector):
        _plan_flush("materialize", arr)
        arr._tap("extract")
        parts, live = arr._owned_parts()
        if not live:
            return _host_numpy(torch.zeros((0,), dtype=arr.dtype))
        return _host_numpy(torch.cat(
            collectives.gather_ranks(parts, cpu, live)))
    if isinstance(arr, (list, tuple)) and arr and all(
            a is None or isinstance(a, torch.Tensor) for a in arr):
        return _host_numpy(torch.cat(
            collectives.gather_ranks(list(arr), cpu)))
    if isinstance(arr, torch.Tensor):
        return _host_numpy(arr)
    if hasattr(arr, "to_array"):
        a = arr.to_array()
        if isinstance(a, tuple):
            return tuple(_host_numpy(x) for x in a)
        return _host_numpy(a)
    return np.asarray(arr)
