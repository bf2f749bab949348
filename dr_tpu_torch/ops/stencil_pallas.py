"""K2: temporally blocked 1-D stencil, ``T`` weighted steps per pass.

Counterpart of ``dr_tpu/ops/stencil_pallas.py``.  ``blocked_stencil_row``
steps the owned cells of one padded row ``tsteps`` times; the ghosts
must hold >= ``tsteps * r`` fresh neighbour values and pass through
stale.  Geometry is the JAX kernel's: seg and halo are multiples of
``ROW_ALIGN`` (1024), so the port accepts and refuses the same calls.

Routes: a CUDA row takes ``csrc/stencil_blocked.cu``; a CPU row takes
:func:`plain_blocked`, which steps the whole row ``tsteps`` times with
the same separately rounded products and sums (bit-identical to the
kernel).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import kernels

__all__ = ["blocked_stencil_row", "plain_blocked", "LANES", "ROW_ALIGN"]

LANES = 128
SUBLANES = 8
ROW_ALIGN = LANES * SUBLANES  # 1024, the JAX kernel's tile alignment
_MAX_RADIUS = 8               # the kernel's template range


def plain_blocked(row: torch.Tensor, seg: int, halo: int, weights: tuple,
                  tsteps: int) -> torch.Tensor:
    """Plain PyTorch version: ``tsteps`` steps over the whole row (the
    cells within ``t*r`` of the row ends go stale, which the halo margin
    keeps away from the owned cells), then the owned cells are taken."""
    r = (len(weights) - 1) // 2
    L = row.shape[-1]
    x = row[0].clone()
    y = x.clone()
    for _ in range(tsteps):
        acc = y[r:L - r]
        torch.mul(x[0:L - 2 * r], weights[0], out=acc)
        for d in range(1, 2 * r + 1):
            acc.add_(x[d:L - 2 * r + d] * weights[d])
        x, y = y, x
    out = row.clone()
    out[0, halo:halo + seg] = x[halo:halo + seg]
    return out


def _kernel_blocked(row: torch.Tensor, seg: int, halo: int, weights: tuple,
                    tsteps: int) -> torch.Tensor:
    r = (len(weights) - 1) // 2
    if row.dtype != torch.float32 or not row.is_contiguous():
        raise ValueError("the K2 kernel takes a contiguous float32 row")
    if not 1 <= r <= _MAX_RADIUS:
        raise ValueError(f"the K2 kernel takes radius 1..{_MAX_RADIUS}")
    out = torch.empty_like(row)
    out[..., :halo] = row[..., :halo]            # ghosts pass through stale
    out[..., halo + seg:] = row[..., halo + seg:]
    w = (ctypes.c_float * len(weights))(*weights)  # read on the host
    kernels.launch("stencil_blocked", "dr_stencil_blocked", row.device,
                   row.data_ptr(), out.data_ptr(), w, r, halo, seg,
                   row.shape[-1], tsteps, kernels.stream_of(row))
    return out


def blocked_stencil_row(row, seg: int, halo: int, weights: Sequence[float],
                        tsteps: int) -> torch.Tensor:
    """Apply ``tsteps`` fused stencil steps to one padded (1, W) row;
    returns a NEW row (owned cells stepped, ghosts stale)."""
    width = row.shape[-1]
    r = (len(weights) - 1) // 2
    assert width == 2 * halo + seg
    assert halo % ROW_ALIGN == 0 and seg % ROW_ALIGN == 0, (
        f"blocked stencil needs seg ({seg}) and halo ({halo}) aligned "
        f"to {ROW_ALIGN}")
    assert halo >= tsteps * r, "halo narrower than the fused time block"
    w = tuple(float(x) for x in weights)
    if kernels.on_cuda(row):
        return _kernel_blocked(row, seg, halo, w, tsteps)
    return plain_blocked(row, seg, halo, w, tsteps)
