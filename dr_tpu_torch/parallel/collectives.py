"""Collectives over rank rows: the single-process counterparts of
``lax.ppermute`` / ``lax.all_gather`` / ``lax.psum``.

Every rank's value is a tensor on that rank's device; a collective is a
set of tensor copies (``Tensor.to``) and sums between them.  Ranks that
share a device exchange by plain reference, ranks on different devices
by a device-to-device copy.  The ``communicator``/``rma_window`` layer
of ``dr_tpu/parallel/collectives.py`` is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

__all__ = ["ring_shift", "all_gather", "psum"]


def ring_shift(sends: Sequence[torch.Tensor], devices, step: int,
               periodic: bool) -> List[Optional[torch.Tensor]]:
    """``recv[r] = sends[r - step]`` (``step`` is +1 for the forward
    ring, -1 for the backward one), moved to rank r's device.  Without
    ``periodic`` the ranks whose source falls off the end receive None
    (the ``ppermute`` pairs of ``dr_tpu.parallel.halo._ring_perms``)."""
    p = len(sends)
    out: List[Optional[torch.Tensor]] = []
    for r in range(p):
        src = r - step
        if not periodic and not 0 <= src < p:
            out.append(None)
            continue
        out.append(sends[src % p].to(devices[r], non_blocking=True))
    return out


def all_gather(values: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Stack one scalar (or equal-shape tensor) per rank on ``device``."""
    return torch.stack([v.to(device, non_blocking=True) for v in values])


def psum(values: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Sum of the per-rank values, in rank order, on ``device``."""
    acc = values[0].to(device, non_blocking=True)
    for v in values[1:]:
        acc = acc + v.to(device, non_blocking=True)
    return acc
