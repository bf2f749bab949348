"""K1: temporally-blocked 1-D stencil as one composed operator.

Counterpart of ``dr_tpu/ops/stencil_matmul.py``.  ``k`` steps of a
radius-``r`` stencil compose into one linear operator, the k-fold
convolution of the taps (half-width ``R = k*r``), computed in float64
on the host.  ``matmul_stencil_row`` applies it to the owned cells of
one padded row whose ghosts hold >= R fresh neighbour values; ghost
cells pass through stale.

Routes: a CUDA row takes the hand-written kernel
(``csrc/stencil_matmul.cu``), which replaces the TPU kernel
``_pallas_apply``: its lane-blocked product on Hopper's tensor cores
(``wgmma``), 64-cell blocks times 64 x 64 Toeplitz blocks of the
operator.  It is bound by those products at the bf16 tensor-core rate.
Its arithmetic is the TPU kernel's (three bf16 products of hi and lo
halves, f32 accumulation) where the band is wide enough for that to
hold the port's 1e-5 check, and six products of three parts (f32-level)
for narrow bands (:func:`kernel_parts`); the taps come pre-split from
:func:`split_taps`, the data is split once a tile in the kernel.  A CPU
row takes :func:`plain_apply`, the JAX package's P-form — the
lane-blocked row ``(width/128, 128)`` times the stacked band operator
``(128, (2D+1)*128)`` in float32, then ``2D+1`` shifted adds.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from . import kernels
from .. import obs as _obs

__all__ = ["LANES", "composed_taps", "max_ksteps", "band_cols",
           "split_taps", "kernel_parts", "matmul_stencil_row",
           "plain_apply"]

LANES = 128
_CHUNK_ROWS = 2 ** 16  # lane rows per plain matmul chunk (bounds memory)
_TAP_OFF = 128         # zero taps ahead of the band in the kernel's table
_HIGH_NORM = 0.15      # widest ||taps||_2 the two-part split takes
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


def _flush(x: torch.Tensor) -> torch.Tensor:
    """f32 subnormals to zeros of their sign, as the TPU (and XLA's CPU
    backend, under which the JAX package's tests run) computes."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, x * 0.0,
                       x)


def split_taps(weights: Sequence[float], k: int, parts: int = 2):
    """The f32 composed taps split into ``parts`` bf16 parts: part 0
    rounded to nearest even from the f32 tap, each next part the same
    rounding of the f32 residual, taken with subnormal operands and
    results flushed to zero.  Two parts are the TPU kernel's split of
    its operator (``_bf16_split``); three rebuild every normal f32 tap
    exactly."""
    c = torch.from_numpy(composed_taps(weights, k).astype(np.float32))
    out = []
    for _ in range(parts):
        b = c.to(torch.bfloat16)
        out.append(b)
        c = _flush(_flush(c) - _flush(b.to(torch.float32)))
    return tuple(out)


def kernel_parts(weights: Sequence[float], k: int) -> int:
    """How many bf16 parts the kernel splits taps and data into.  Two
    (three products, the TPU kernel's HIGH emulation) where the composed
    taps' 2-norm is at most ``_HIGH_NORM``: each product is off by ~2^-16
    of itself, so a cell's error is ~2^-16 ||c||_2 per unit of data and
    measures under the port's 1e-5 check at unit scale.  Narrower bands
    (a few steps, where it does not) take three parts and six products,
    f32-level."""
    c = composed_taps(weights, k).astype(np.float32).astype(np.float64)
    return 2 if float(np.sqrt(np.sum(c * c))) <= _HIGH_NORM else 3


_taps_cache: dict = {}


def _tap_table(weights: tuple, k: int, parts: int) -> torch.Tensor:
    """The kernel's tap table: (parts, L) bf16, each part with
    ``_TAP_OFF`` zeros ahead of the 2R+1 taps and zeros behind, so every
    operator fragment the kernel builds reads inside it."""
    split = split_taps(weights, k, parts)
    n = len(split[0])
    t = torch.zeros((parts, -(-(_TAP_OFF + n + 126) // 8) * 8),
                    dtype=torch.bfloat16)
    for i, part in enumerate(split):
        t[i, _TAP_OFF:_TAP_OFF + n] = part
    return t


def _device_taps(weights: tuple, k: int, device):
    """(parts, table on ``device``) for the kernel (cached: uploaded once
    per device)."""
    key = (weights, k, device)
    got = _taps_cache.get(key)
    if got is None:
        parts = kernel_parts(weights, k)
        got = _taps_cache[key] = (parts, _tap_table(weights, k, parts)
                                  .to(device))
    return got


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
    with _obs.span("rows.copy", cat="rows"):
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
    if (row.dtype != torch.float32 or not row.is_contiguous()
            or row.data_ptr() % 16 != 0):
        raise ValueError("the K1 kernel takes a contiguous float32 row "
                         "starting on a 16-byte boundary")
    width = row.shape[-1]
    R = ksteps * ((len(weights) - 1) // 2)
    if R > _BAND_COLS * LANES:
        raise ValueError(f"the K1 kernel takes a band half-width up to "
                         f"{_BAND_COLS * LANES}, not {R}")
    parts, taps = _device_taps(weights, ksteps, row.device)
    with _obs.span("rows.copy", cat="rows"):
        out = torch.empty_like(row)
        out[..., :halo] = row[..., :halo]        # ghosts pass through stale
        out[..., halo + seg:] = row[..., halo + seg:]
    kernels.launch("stencil_matmul", "dr_stencil_matmul", row.device,
                   row.data_ptr(), out.data_ptr(), taps.data_ptr(), halo,
                   seg, width, R, taps.shape[1], parts,
                   kernels.stream_of(row))
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
