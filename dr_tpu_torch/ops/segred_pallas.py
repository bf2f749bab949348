"""K7: segmented reduce of sum/prod/min/max columns over int32 ids.

Counterpart of ``dr_tpu/ops/segred_pallas.py``.  Element i of every
column folds into segment ``segid[i]``; ids outside ``[0, nseg)``
contribute nothing, and empty segments hold the monoid's identity
(+inf / dtype max for min, -inf / dtype min for max, 0 for sum, 1 for
prod).  ``segid=None`` puts every element in segment 0 (``reduce``'s
single-segment use, which then reads no ids).

Every eligible monoid is order-free at the bit level, so the result does
not depend on the order of the combines: min/max over any dtype (with
-0.0 below +0.0 and NaN propagating, as XLA's min/max), integer sum and
product modulo 2^32.  Float sum/prod are not (association changes
rounding) and are ineligible, as in the JAX package.

Both routes fold signed 32-bit keys: an integer column widens to int32
(the result is narrowed back modulo its width, which keeps the low bits
of a wrapped sum or product); a bool column is 0/1, its sum folded as
max ("any", torch's bool sum) and its product as min ("all"); a float
column takes the order
keys of ``ops/order_keys.py`` (bf16/f16 widened exactly to f32), -0.0
(key -1) below +0.0 (key 0), and a NaN maps to INT32_MIN for min and
INT32_MAX for max, past every other key, so the fold propagates it.

Routes: CUDA tensors take ``csrc/segred.cu`` (one launch a call with
no ids or few segments, two with many; see its note); CPU tensors take
:func:`plain_segmented`.  The JAX package's ``n <= 2^15`` cap was the
VMEM footprint of its ``(128, n)`` mask and is dropped; the
``nseg <= 2^15`` cap stays (the kernel's per-block key table).
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels, order_keys
from .. import obs as _obs

__all__ = ["OPS", "KERNEL_DTYPES", "eligible", "identity", "segmented",
           "plain_segmented"]

OPS = ("sum", "prod", "min", "max")
#: monoids whose combine is order-free only over exact dtypes
_EXACT_ONLY = ("sum", "prod")
MAX_SEGMENTS = 1 << 15
MAX_COLS = 4

#: column dtypes the CUDA kernel takes (codes of csrc/segred.cu): every
#: dtype of at most 4 bytes (the JAX package's 8-byte columns are
#: interpret-only)
KERNEL_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
                 torch.int32: 3, torch.int8: 4, torch.uint8: 5,
                 torch.int16: 6, torch.bool: 7}
_OP_CODE = {op: i for i, op in enumerate(OPS)}


def eligible(n: int, nseg: int, cols) -> bool:
    """``cols`` is a sequence of ``(dtype, op)`` monoid columns.  Any
    ``n``; ``1 <= nseg <= 2^15``; float sum/prod are ineligible."""
    if n < 0 or not 1 <= nseg <= MAX_SEGMENTS:
        return False
    for dt, op in cols:
        if op not in OPS:
            return False
        if op in _EXACT_ONLY and (dt.is_floating_point or dt.is_complex):
            return False
    return True


def identity(op: str, dtype: torch.dtype):
    """The identity an empty segment holds, as a Python scalar."""
    if op == "sum":
        return 0
    if op == "prod":
        return 1
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    if dtype == torch.bool:
        return op == "min"
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


# ------------------------------------------------------------ plain version

def _nan_key(op: str, kdt: torch.dtype) -> int:
    """The key of a NaN: past every other key, so the fold propagates it."""
    info = torch.iinfo(kdt)
    return info.min if op == "min" else info.max


def _narrow(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int32 result back to a narrower integer (or bool) column's
    dtype, modulo its width (exact for min/max; the low bits of a wrapped
    sum or product)."""
    if dtype == torch.bool:
        return k != 0
    if dtype == torch.uint8:
        return (k & 0xFF).to(dtype)
    shift = 32 - 8 * dtype.itemsize
    return ((k << shift) >> shift).to(dtype)


_SCATTER = {"sum": "sum", "prod": "prod", "min": "amin", "max": "amax"}
#: a bool column's sum is "any" and its product "all"
_BOOL_OP = {"sum": "max", "prod": "min"}


def _columns(cols):
    """``cols`` with a bool column's sum and product as max and min."""
    return tuple((v, _BOOL_OP.get(op, op) if v.dtype == torch.bool else op)
                 for v, op in cols)


def _whole(op: str, x: torch.Tensor) -> torch.Tensor:
    if op == "sum":
        return x.sum(dtype=x.dtype)
    if op == "prod":
        return x.prod(dtype=x.dtype)
    return x.amin() if op == "min" else x.amax()


def plain_segmented(segid, nseg: int, cols):
    """Plain PyTorch version of :func:`segmented`: reductions of the
    order keys (floats) or of the values widened to int32 (integers and
    bool; sums and products wrap modulo the column's width)."""
    outs = []
    for v, op in _columns(cols):
        acc = torch.full((nseg,), identity(op, v.dtype), dtype=v.dtype,
                         device=v.device)
        if v.dtype.is_floating_point:  # min/max: eligible() leaves no other
            nk = _nan_key(op, order_keys.key_dtype(v.dtype))
            src, acc = order_keys.to_keys(v, nk), order_keys.to_keys(acc, nk)
        elif v.dtype.itemsize < 4:
            src, acc = v.to(torch.int32), acc.to(torch.int32)
        else:
            src = v
        if segid is None:
            if src.numel():
                acc[0] = _whole(op, src)
        else:
            ids = segid.to(torch.int64)
            keep = (ids >= 0) & (ids < nseg)
            # a boolean mask's selection reads its count on the host
            with _obs.span("sync.segred.mask", cat="sync"):
                ids, src = ids[keep], src[keep]
            acc.scatter_reduce_(0, ids, src, _SCATTER[op], include_self=True)
        if v.dtype.is_floating_point:
            acc = order_keys.from_keys(acc, v.dtype, nk)
        elif v.dtype.itemsize < 4:
            acc = _narrow(acc, v.dtype)
        outs.append(acc)
    return tuple(outs)


# ------------------------------------------------------------------ kernel

#: the kernel's workspace, one a (device index, stream): zeroed when
#: made, zero again after every call (csrc/segred.cu), so a call on one
#: stream never shares a ticket or a key table with a call on another
_WORKSPACES: dict = {}


def _workspace(dev: torch.device, stream: int) -> torch.Tensor:
    ws = _WORKSPACES.get((dev.index, stream))
    if ws is None:
        ints = kernels.library("segred").dr_segred_workspace_ints()
        ws = _WORKSPACES[(dev.index, stream)] = torch.zeros(
            ints, dtype=torch.int32, device=dev)
    return ws


def _kernel_segmented(segid, nseg, cols, counter="segred"):
    """One ``dr_segred`` call (one launch, two with many segments),
    counted under ``counter`` (K8 counts its bincounts as ``hist``)."""
    cols = _columns(cols)
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"the K7 kernel takes 1 to {MAX_COLS} columns")
    dev = cols[0][0].device
    n = cols[0][0].numel()
    for v, op in cols:
        if v.dtype not in KERNEL_DTYPES:
            raise ValueError(f"the K7 kernel takes columns of at most 4 "
                             f"bytes, not {v.dtype}")
        if op in _EXACT_ONLY and v.dtype.is_floating_point:
            raise ValueError(f"the K7 kernel takes {op} over integer and "
                             f"bool columns only")
        if v.dim() != 1 or v.numel() != n or not v.is_contiguous() \
                or v.device != dev:
            raise ValueError("K7 columns must be contiguous 1-D tensors of "
                             "one length on one device")
    if segid is not None and (segid.dtype != torch.int32
                              or segid.shape != (n,)
                              or not segid.is_contiguous()):
        raise ValueError("segid must be a contiguous int32 tensor of the "
                         "columns' length")
    k = len(cols)
    outs = [torch.empty(nseg, dtype=v.dtype, device=dev) for v, _ in cols]
    vals = (ctypes.c_longlong * k)(*[v.data_ptr() for v, _ in cols])
    optrs = (ctypes.c_longlong * k)(*[o.data_ptr() for o in outs])
    dtypes = (ctypes.c_int * k)(*[KERNEL_DTYPES[v.dtype] for v, _ in cols])
    ops = (ctypes.c_int * k)(*[_OP_CODE[op] for _, op in cols])
    stream = kernels.stream_of(outs[0])
    kernels.launch("segred", "dr_segred", dev, kernels.ptr(segid), n, nseg,
                   k, vals, dtypes, ops, optrs,
                   _workspace(dev, stream).data_ptr(), stream,
                   counter=counter)
    return tuple(outs)


def segmented(segid, nseg: int, cols):
    """Segmented reduce of every ``(values, op)`` column in ``cols`` over
    int32 ``segid`` (or None: all in segment 0) into ``nseg`` segments;
    returns a tuple of ``(nseg,)`` tensors of the columns' dtypes.
    Caller checks :func:`eligible` first."""
    tensors = [v for v, _ in cols] + ([segid] if segid is not None else [])
    if kernels.on_cuda(*tensors):
        return _kernel_segmented(segid, nseg, cols)
    return plain_segmented(segid, nseg, cols)
