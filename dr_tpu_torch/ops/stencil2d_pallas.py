"""K5: temporally blocked 2-D (3x3) stencil, ``T`` steps per pass.

Counterpart of ``dr_tpu/ops/stencil2d_pallas.py``.
``blocked_stencil2d_padded`` steps the owned rows of a row-padded
``(m + 2*pad, n)`` array ``T`` times and returns a new array of the same
layout, so passes chain without re-padding.  Interior cells take the 3x3
weighted sum; edge rows and columns (logical row 0 and m-1, column 0 and
n-1) are frozen (Dirichlet), so the pad rows never reach an owned cell.
They pass through unchanged.

Geometry is the JAX kernel's: 3x3 weights, ``n % 128 == 0``,
``pad >= T`` and, when ``band`` is given, ``m % band == 0``, so the
port accepts and refuses the same calls.  The band height only shapes
the TPU kernel's VMEM tiles: here it is checked and not used, and the
JAX package's ``pick_band`` (a VMEM budget rule) is not carried over.
The CUDA kernel picks its own tiles.

Routes: a CUDA array takes ``csrc/stencil2d_blocked.cu`` (f32 only; it
contracts products to FMAs, so it matches the plain version within a
tolerance, not to the bit); a CPU array takes :func:`plain_blocked2d`,
which steps the owned rows ``T`` times with separately rounded products
and sums in the JAX kernel's order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels

__all__ = ["blocked_stencil2d_padded", "blocked_stencil2d",
           "plain_blocked2d", "LANES", "MAX_T"]

LANES = 128  # the JAX kernel's lane width: n must be a multiple
MAX_T = 64   # steps per kernel launch (the register window's margins)


def _taps(weights):
    w = np.asarray(weights, dtype=np.float64)
    assert w.shape == (3, 3), "blocked 2-D stencil takes 3x3 weights"
    return w


def plain_blocked2d(xp: torch.Tensor, m: int, weights, tsteps: int,
                    pad: int) -> torch.Tensor:
    """Plain PyTorch version: ``tsteps`` steps of the interior of the
    owned rows, ``acc = w*u`` then ``acc = acc + w*u`` over the nonzero
    taps in (di, dj) order; everything else passes through."""
    w = _taps(weights)
    n = xp.shape[1]
    x, y = xp.clone(), xp.clone()
    if m <= 2 or n <= 2:
        return x
    taps = [(di, dj, float(w[di, dj])) for di in range(3) for dj in range(3)
            if w[di, dj] != 0.0]
    for _ in range(tsteps):
        acc = None
        for di, dj, wij in taps:
            term = x[pad + di:pad + m - 2 + di, dj:n - 2 + dj] * wij
            acc = term if acc is None else acc + term
        if acc is None:
            acc = x.new_zeros((m - 2, n - 2))
        y[pad + 1:pad + m - 1, 1:n - 1] = acc
        x, y = y, x
    return x


def _kernel_blocked2d(xp: torch.Tensor, m: int, w: np.ndarray,
                      tsteps: int, pad: int) -> torch.Tensor:
    if xp.dtype != torch.float32 or not xp.is_contiguous():
        raise ValueError("the K5 kernel takes a contiguous float32 array")
    n = xp.shape[1]
    full = bool(w[0, 0] or w[0, 2] or w[2, 0] or w[2, 2])
    wt = (ctypes.c_float * 9)(*w.reshape(-1).tolist())  # read on the host
    cur = xp
    left = tsteps
    while left > 0:
        T = min(left, MAX_T)
        out = torch.empty_like(xp)
        out[:pad] = cur[:pad]                    # pad rows pass through
        out[pad + m:] = cur[pad + m:]
        kernels.launch("stencil2d_blocked", "dr_stencil2d_blocked",
                       xp.device, cur.data_ptr(), out.data_ptr(), wt,
                       int(full), m, n, pad, T, kernels.stream_of(xp))
        cur = out
        left -= T
    return cur if cur is not xp else xp.clone()


def blocked_stencil2d_padded(xp, m: int, weights, tsteps: int, pad: int,
                             *, band: int = None) -> torch.Tensor:
    """One ``tsteps``-step pass over a row-padded (m + 2*pad, n) array;
    returns a NEW array in the same padded layout."""
    n = xp.shape[1]
    if band is not None:
        assert m % band == 0, "band height must divide the row count"
    w = _taps(weights)
    assert n % LANES == 0 and pad >= tsteps, (
        f"blocked 2-D stencil needs n ({n}) a multiple of {LANES} and "
        f"pad ({pad}) >= time steps ({tsteps})")
    assert xp.shape[0] == m + 2 * pad, "array is not row-padded by pad"
    if kernels.on_cuda(xp):
        return _kernel_blocked2d(xp, m, w, tsteps, pad)
    return plain_blocked2d(xp, m, w, tsteps, pad)


def blocked_stencil2d(x, weights, tsteps: int, *,
                      band: int = None) -> torch.Tensor:
    """Apply ``tsteps`` fused 3x3 stencil steps to a 2-D array with frozen
    (Dirichlet) edges; returns the stepped array.  One-shot convenience
    over :func:`blocked_stencil2d_padded`."""
    m = x.shape[0]
    xp = F.pad(x, (0, 0, tsteps, tsteps))
    out = blocked_stencil2d_padded(xp, m, weights, tsteps, tsteps,
                                   band=band)
    return out[tsteps:tsteps + m]
