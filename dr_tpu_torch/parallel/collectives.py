"""Collectives over rank rows: the single-process counterparts of
``lax.ppermute`` / ``lax.all_gather`` / ``lax.all_to_all`` /
``lax.psum``.

Every rank's value is a tensor on that rank's device; a collective is a
set of tensor copies (``Tensor.to``) and sums between them.  Ranks that
share a device exchange by plain reference, ranks on different devices
by a device-to-device copy.  :func:`ordered_minimum` /
:func:`ordered_maximum` are the min/max combines of partials (the
reduce fold, the halo's ghost-to-owner fold) with XLA's ordering.  The ``communicator``/``rma_window`` layer
of ``dr_tpu/parallel/collectives.py`` is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["ring_shift", "ppermute", "all_gather", "all_to_all", "psum",
           "ordered_minimum", "ordered_maximum"]


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


def ppermute(sends: Sequence[Optional[torch.Tensor]],
             pairs: Sequence[Tuple[int, int]],
             devices) -> List[Optional[torch.Tensor]]:
    """``recv[dst] = sends[src]`` moved to ``devices[dst]`` for every
    ``(src, dst)`` pair (``lax.ppermute``); an entry no pair reaches is
    None."""
    out: List[Optional[torch.Tensor]] = [None] * len(devices)
    for src, dst in pairs:
        out[dst] = sends[src].to(devices[dst], non_blocking=True)
    return out


def all_gather(values: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Stack one scalar (or equal-shape tensor) per rank on ``device``."""
    return torch.stack([v.to(device, non_blocking=True) for v in values])


def all_to_all(sends: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    """``lax.all_to_all`` over the leading axis: every rank sends a
    ``(p, ...)`` tensor, and rank d receives row d of every sender,
    stacked in sender order, on ``devices[d]``."""
    return [torch.stack([s[d].to(dev, non_blocking=True) for s in sends])
            for d, dev in enumerate(devices)]


def psum(values: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Sum of the per-rank values, in rank order, on ``device``."""
    acc = values[0].to(device, non_blocking=True)
    for v in values[1:]:
        acc = acc + v.to(device, non_blocking=True)
    return acc


def ordered_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise min as XLA's: -0.0 below +0.0, NaN propagates
    (``torch.minimum`` returns either zero)."""
    if not a.is_floating_point():
        return torch.minimum(a, b)
    take_b = torch.isnan(b) | (b < a) | ((b == a) & torch.signbit(b))
    return torch.where(take_b, b, a)


def ordered_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max as XLA's: +0.0 above -0.0, NaN propagates."""
    if not a.is_floating_point():
        return torch.maximum(a, b)
    take_b = torch.isnan(b) | (b > a) | ((b == a) & ~torch.signbit(b))
    return torch.where(take_b, b, a)
