"""Monotone signed-integer order keys of floats, the one format the sort
(K6's keys, ``algorithms/sort.py``) and K7's float min/max columns
(``ops/segred_pallas.py``) share.

A float's bits ``b`` map to ``b ^ ((b >> (w - 1)) & (2^(w-1) - 1))`` in
its width ``w`` (bf16/f16 widened exactly to f32 first, f64 in 64 bits):
the keys then order as the floats do, -0.0 (key -1) just below +0.0
(key 0).  This is the JAX package's uint32 key with its sign bit
flipped.  Where a NaN goes is the caller's choice of ``nan_key``: the
sort puts it after +inf, a min/max fold past every other key so that it
propagates.
"""

from __future__ import annotations

import torch

__all__ = ["key_dtype", "to_keys", "from_keys", "with_canonical_nan"]

#: the quiet NaN of each float dtype, as bits (PyTorch's f32 -> bf16
#: conversion does not keep a NaN's sign, so NaNs are written as bits)
_NAN_BITS = {torch.float64: (torch.int64, 0x7FF8000000000000),
             torch.float32: (torch.int32, 0x7FC00000),
             torch.float16: (torch.int16, 0x7E00),
             torch.bfloat16: (torch.int16, 0x7FC0)}


def key_dtype(dtype: torch.dtype) -> torch.dtype:
    """The key dtype of a float dtype: int64 for f64, else int32."""
    return torch.int64 if dtype == torch.float64 else torch.int32


def _flip(b: torch.Tensor) -> torch.Tensor:
    """The map between bits and keys; it is its own inverse."""
    top = torch.iinfo(b.dtype).max
    return b ^ ((b >> (b.element_size() * 8 - 1)) & top)


def to_keys(x: torch.Tensor, nan_key: int) -> torch.Tensor:
    """Order keys of the float tensor ``x``; every NaN becomes
    ``nan_key``."""
    b = x.view(torch.int64) if x.dtype == torch.float64 \
        else x.float().view(torch.int32)
    return torch.where(torch.isnan(x), nan_key, _flip(b))


def from_keys(k: torch.Tensor, dtype: torch.dtype,
              nan_key: int) -> torch.Tensor:
    """Inverse of :func:`to_keys`: floats of ``dtype``, the quiet NaN
    where ``k == nan_key``."""
    x = _flip(k).view(torch.float64 if k.dtype == torch.int64
                      else torch.float32)
    return with_canonical_nan(x.to(dtype), k == nan_key)


def with_canonical_nan(x: torch.Tensor, nan: torch.Tensor) -> torch.Tensor:
    """``x`` with the quiet NaN of its dtype where ``nan`` is set."""
    ity, bits = _NAN_BITS[x.dtype]
    return torch.where(nan, bits, x.view(ity)).view(x.dtype)
