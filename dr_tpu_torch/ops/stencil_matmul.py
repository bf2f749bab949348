"""K1: temporally-blocked 1-D stencil as one composed operator.

Counterpart of ``dr_tpu/ops/stencil_matmul.py``.  ``k`` steps of a
radius-``r`` stencil compose into one linear operator, the k-fold
convolution of the taps (half-width ``R = k*r``), computed in float64
on the host.  ``matmul_stencil_row`` applies it to the owned cells of
one padded row whose ghosts hold >= R fresh neighbour values; ghost
cells pass through stale.

Routes: a CUDA row takes the hand-written kernel
(``csrc/stencil_matmul.cu``, a direct banded sum over the composed
taps); a CPU row takes :func:`plain_apply`, the JAX package's P-form —
the lane-blocked row ``(width/128, 128)`` times the stacked band
operator ``(128, (2D+1)*128)`` in float32, then ``2D+1`` shifted adds.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from . import kernels

__all__ = ["LANES", "composed_taps", "max_ksteps", "band_cols",
           "matmul_stencil_row", "plain_apply"]

LANES = 128
_CHUNK_ROWS = 2 ** 16  # lane rows per plain matmul chunk (bounds memory)
_V = 8                 # taps padding multiple of the kernel's window
_BAND_COLS = 4         # lane columns the composed band may reach


def composed_taps(weights: Sequence[float], k: int) -> np.ndarray:
    """k-fold convolution of the stencil taps (float64, length 2*k*r+1)."""
    c = np.array([1.0], dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    for _ in range(k):
        c = np.convolve(c, w)
    return c


def max_ksteps(radius: int) -> int:
    """Largest supported block: the band half-width ``k*r`` may reach
    ``_BAND_COLS`` lane columns each side (the JAX package's default)."""
    return _BAND_COLS * LANES // radius


def band_cols(k: int, radius: int) -> int:
    """D: lane columns the composed band reaches each side."""
    return -(-(k * radius) // LANES)


@functools.lru_cache(maxsize=64)
def _operator(weights: tuple, k: int) -> np.ndarray:
    """(128, (2D+1)*128) stacked band operator [A_-D | ... | A_+D],
    transposed for ``rows @ W``; float64."""
    c = composed_taps(weights, k)
    R = (len(c) - 1) // 2
    D = -(-R // LANES)
    a = np.arange(LANES)[:, None]
    b = np.arange(LANES)[None, :]
    blocks = []
    for d in range(-D, D + 1):
        A = np.zeros((LANES, LANES), dtype=np.float64)
        s = b + LANES * d - a
        inband = np.abs(s) <= R
        A[inband] = c[(s + R)[inband]]
        blocks.append(A)
    return np.ascontiguousarray(np.concatenate(blocks, axis=0).T)


_taps_cache: dict = {}


def _device_taps(weights: tuple, k: int, device) -> torch.Tensor:
    """The composed taps as f32 on ``device``, zero-padded to a multiple
    of the kernel's window (cached: uploaded once per device)."""
    key = (weights, k, device)
    t = _taps_cache.get(key)
    if t is None:
        c = composed_taps(weights, k).astype(np.float32)
        pad = (-len(c)) % _V
        t = torch.from_numpy(np.concatenate(
            [c, np.zeros(pad, np.float32)])).to(device)
        _taps_cache[key] = t
    return t


def plain_apply(row: torch.Tensor, seg: int, halo: int, weights: tuple,
                ksteps: int) -> torch.Tensor:
    """Plain PyTorch version of the apply (the JAX P-form, chunked)."""
    width = row.shape[-1]
    r = (len(weights) - 1) // 2
    D = band_cols(ksteps, r)
    W = torch.from_numpy(_operator(weights, ksteps)).to(row.device,
                                                        torch.float32)
    hc, segc = halo // LANES, seg // LANES
    R0 = row.reshape(width // LANES, LANES)
    out = R0.clone()
    for lo in range(0, segc, _CHUNK_ROWS):
        cr = min(_CHUNK_ROWS, segc - lo)
        src = R0[hc - D + lo: hc + lo + cr + D].to(torch.float32)
        P = src @ W
        acc = P[0:cr, 0:LANES].clone()
        for i in range(1, 2 * D + 1):
            acc += P[i:cr + i, i * LANES:(i + 1) * LANES]
        out[hc + lo: hc + lo + cr] = acc.to(row.dtype)
    return out.reshape(row.shape)


def _kernel_apply(row: torch.Tensor, seg: int, halo: int, weights: tuple,
                  ksteps: int) -> torch.Tensor:
    if row.dtype != torch.float32 or not row.is_contiguous():
        raise ValueError("the K1 kernel takes a contiguous float32 row")
    width = row.shape[-1]
    R = ksteps * ((len(weights) - 1) // 2)
    taps = _device_taps(weights, ksteps, row.device)
    out = torch.empty_like(row)
    out[..., :halo] = row[..., :halo]            # ghosts pass through stale
    out[..., halo + seg:] = row[..., halo + seg:]
    kernels.launch("stencil_matmul", "dr_stencil_matmul", row.device,
                   row.data_ptr(), out.data_ptr(), taps.data_ptr(), halo,
                   seg, width, R, taps.numel(), kernels.stream_of(row))
    return out


def matmul_stencil_row(row, seg: int, halo: int, weights: Sequence[float],
                       ksteps: int) -> torch.Tensor:
    """Apply ``ksteps`` composed stencil steps to one padded (1, W) row.

    ``row``: (1, halo + seg + halo); ghosts pre-exchanged with width
    >= ksteps * r; seg and halo multiples of 128.  Returns a NEW row:
    owned cells stepped, ghost cells stale."""
    r = (len(weights) - 1) // 2
    width = row.shape[-1]
    assert width == 2 * halo + seg
    assert seg % LANES == 0 and halo % LANES == 0, \
        "matmul stencil needs seg and halo aligned to 128 lanes"
    assert halo >= ksteps * r, "halo narrower than the composed block"
    w = tuple(float(x) for x in weights)
    if kernels.on_cuda(row):
        return _kernel_apply(row, seg, halo, w, ksteps)
    return plain_apply(row, seg, halo, w, ksteps)
