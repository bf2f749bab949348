"""The plain 1-D stencil step as one pass over a row.

Replaces no TPU kernel: the JAX package's step
(``dr_tpu/algorithms/stencil.py``) is one XLA loop fusion of the
shifted-slice multiply-and-add, which the port ran as ``2r + 1``
multiplies and ``2r`` adds of torch ops over whole-row temporaries.

:func:`step_row` steps the cells ``[hprev + a, hprev + b)`` of one padded
``(1, W)`` row with a weight vector and returns a NEW out row: the
stepped cells written, every other cell copied through from the old out
row.  The cells the step reads past the valid owned ones come from the
exchange's received ghost slices where they are given
(``parallel/halo.ghost_slices``), else from the row's own ghosts; the
in row is never written.

Routes: a CUDA row takes ``csrc/stencil_step.cu``; a CPU row takes
:func:`plain_step_row`, which writes the ghost slices into a copy of the
row and sums the shifted slices with :func:`plain_step`, the same
separately rounded products and sums in the same order (bit-identical
to the kernel).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import kernels
from .. import obs as _obs

__all__ = ["step_row", "plain_step", "plain_step_row", "radius",
           "MAX_RADIUS"]

MAX_RADIUS = 8  # the kernel's template range


def radius(weights) -> int:
    return (len(weights) - 1) // 2


def plain_step(shifted, weights):
    """The weighted sum of the shifted neighbourhood tensors as torch
    ops: each product and each sum rounded on its own, left to right."""
    acc = shifted[0] * weights[0]
    for wi, s in zip(weights[1:], shifted[1:]):
        acc = acc + s * wi
    return acc


def plain_step_row(row, out, weights, hprev: int, valid: int, a: int,
                   b: int, got_p=None, got_n=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`step_row`."""
    r = radius(weights)
    x = row[0].clone()
    vend = hprev + valid
    if got_p is not None:
        x[:hprev] = got_p[0]
    if got_n is not None:
        x[vend: vend + got_n.shape[-1]] = got_n[0]
    lo, hi = hprev + a, hprev + b
    vals = plain_step([x[lo - r + d: hi - r + d] for d in range(2 * r + 1)],
                      weights)
    with _obs.span("rows.copy", cat="rows"):
        new = out.clone()
    new[0, lo:hi] = vals
    return new


def _kernel_step_row(row, out, weights, hprev, valid, a, b, got_p, got_n):
    r = radius(weights)
    for t in (row, out, got_p, got_n):
        if t is not None and (t.dtype != torch.float32
                              or not t.is_contiguous()
                              or t.device != row.device):
            raise ValueError("the stencil_step kernel takes contiguous "
                             "float32 rows and ghosts on one device")
    if not 1 <= r <= MAX_RADIUS:
        raise ValueError(f"the stencil_step kernel takes radius "
                         f"1..{MAX_RADIUS}")
    lo, hi = hprev + a, hprev + b
    new = torch.empty_like(out)
    w = (ctypes.c_float * len(weights))(*weights)  # read on the host
    kernels.launch("stencil_step", "dr_stencil_step", row.device,
                   row.data_ptr(), kernels.ptr(got_p), kernels.ptr(got_n),
                   new.data_ptr(), w, r, hprev, hprev + valid, lo, hi,
                   kernels.stream_of(row))
    # the ghosts and unstepped cells pass through, queued after the
    # launch so that the card starts the pass without waiting for them
    with _obs.span("rows.copy", cat="rows"):
        new[:, :lo] = out[:, :lo]
        new[:, hi:] = out[:, hi:]
    return new


def step_row(row, out, weights: Sequence[float], hprev: int, valid: int,
             a: int, b: int, got_p: Optional[torch.Tensor] = None,
             got_n: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One weighted step of the owned cells ``[a, b)`` of ``row`` (its
    owned cells start at ``hprev``, ``valid`` of them hold data) into a
    new copy of ``out``; ``got_p`` / ``got_n`` are the ``(1, width)``
    ghost slices an exchange received for the row (None: its own
    ghosts stand).  ``2r + 1`` weights, ``hprev`` and the ghosts at
    least ``r`` wide."""
    w = tuple(float(x) for x in weights)
    r = radius(w)
    assert len(w) == 2 * r + 1, "an odd number of weights"
    assert row.shape == out.shape and row.dim() == 2 and row.shape[0] == 1
    assert hprev >= r and 0 <= a and b <= valid
    assert hprev + valid + r <= row.shape[-1]
    if a >= b:  # nothing of this rank is stepped
        with _obs.span("rows.copy", cat="rows"):
            return out.clone()
    if kernels.on_cuda(*(t for t in (row, out, got_p, got_n)
                         if t is not None)):
        return _kernel_step_row(row, out, w, hprev, valid, a, b, got_p,
                                got_n)
    return plain_step_row(row, out, w, hprev, valid, a, b, got_p, got_n)
