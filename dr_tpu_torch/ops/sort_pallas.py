"""K6: bitonic sort of a batch of key blocks, keys-only or (key, gid) pairs.

Counterpart of ``dr_tpu/ops/sort_pallas.py``.  The sample sort's local
phase (``algorithms/sort.py`` phase 1) sorts each rank's block of
monotone order keys; blocks up to ``2^15`` keys (padded to a power of
two of at least 256) take this kernel, every rank of one device in one
call on a ``(b, n)`` batch (the JAX package's one block a call, with the
batch written out).  Keys are the port's signed int32 encoding (the JAX
package's uint32 key with its sign bit flipped: the same order); the KV
variant sorts ``(key, gid)`` pairs by the full pair order, a total order
(valid gids are distinct, pad pairs are identical), so any correct
sorting network gives the same bits as ``torch.sort`` of the same
encoding.  Pads are the dtype max, and ``INT32_MAX`` for the gid, which
sort to the tail and are sliced off.

Routes: CUDA tensors take ``csrc/bitonic_sort.cu`` (one launch a call,
one CUDA block a row, two for pairs at 2^15); CPU tensors take
:func:`plain_sort_keys` / :func:`plain_sort_kv`, which also serve the
sort's large blocks (the JAX package's ``lax.sort`` route) and its
8-byte keys (interpret-only in the JAX package) on any device.
"""

from __future__ import annotations

import torch

from . import kernels

__all__ = ["MAX_ELEMS", "eligible", "padded", "check_batch", "sort_keys",
           "sort_kv", "plain_sort_keys", "plain_sort_kv"]

LANES = 128
#: cap on the padded block: the network is O(M log^2 M) compare-exchanges
#: in one CUDA block's registers and shared memory (two for pairs at the
#: cap)
MAX_ELEMS = 1 << 15
_GMAX = torch.iinfo(torch.int32).max


def padded(n: int) -> int:
    """The network's power-of-two width for ``n`` keys (at least 256)."""
    m = 2 * LANES
    while m < n:
        m *= 2
    return m


def eligible(n: int, key_dtype: torch.dtype) -> bool:
    """A block of ``n`` int32 keys within the cap takes this module
    (8-byte keys are interpret-only in the JAX package, and take
    ``torch.sort`` here on every device)."""
    return key_dtype == torch.int32 and 1 <= n and padded(n) <= MAX_ELEMS


def plain_sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """``torch.sort`` of the keys along the last dimension (equal keys
    are identical bits)."""
    return torch.sort(keys).values


def plain_sort_kv(keys: torch.Tensor, gid: torch.Tensor):
    """Sort (key, gid) pairs by the full pair order along the last
    dimension.  int32 keys sort once, packed as
    ``key * 2^32 + (gid + 2^31)`` in an int64; int64 keys sort stably by
    gid, then stably by key."""
    if keys.dtype == torch.int32:
        packed = (keys.to(torch.int64) << 32) | \
            (gid.to(torch.int64) + (1 << 31))
        packed = torch.sort(packed).values
        return ((packed >> 32).to(torch.int32),
                ((packed & 0xFFFFFFFF) - (1 << 31)).to(torch.int32))
    order = torch.sort(gid, stable=True).indices
    order = order.gather(-1, torch.sort(keys.gather(-1, order),
                                        stable=True).indices)
    return keys.gather(-1, order), gid.gather(-1, order)


def check_batch(keys: torch.Tensor, gid=None):
    """``(b, n)`` of a K6 call on ``keys`` (one block ``(n,)`` or a
    batch ``(b, n)``) and ``gid``; raises ValueError on what the kernel
    does not take: other dtypes than int32, other ranks than 1 and 2, an
    empty batch, blocks past the cap, a non-contiguous tensor, a gid of
    another shape or device.  Depends on no device."""
    if keys.dtype != torch.int32 or (gid is not None
                                     and gid.dtype != torch.int32):
        raise ValueError(f"the K6 kernel takes int32 keys and gids, not "
                         f"{keys.dtype}")
    if keys.dim() not in (1, 2):
        raise ValueError(f"the K6 kernel takes a block (n,) or a batch "
                         f"(b, n), not {tuple(keys.shape)}")
    b, n = (1, keys.shape[0]) if keys.dim() == 1 else tuple(keys.shape)
    if b < 1 or n < 1 or padded(n) > MAX_ELEMS:
        raise ValueError(f"the K6 kernel takes 1 or more blocks of 1 to "
                         f"{MAX_ELEMS} keys, not {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("the K6 kernel takes a contiguous batch")
    if gid is not None and (gid.shape != keys.shape
                            or not gid.is_contiguous()
                            or gid.device != keys.device):
        raise ValueError("gid must be contiguous, of the keys' shape and on "
                         "their device")
    return b, n


def _kernel_sort(keys, gid):
    b, n = check_batch(keys, gid)
    M = padded(n)
    kout = torch.empty((b, M), dtype=torch.int32, device=keys.device)
    gout = torch.empty((b, M), dtype=torch.int32, device=keys.device) \
        if gid is not None else None
    kernels.launch("bitonic_sort", "dr_bitonic_sort", keys.device,
                   keys.data_ptr(), kernels.ptr(gid), n, M, b,
                   kout.data_ptr(), kernels.ptr(gout),
                   kernels.stream_of(keys))
    rows = 0 if keys.dim() == 1 else slice(None)  # a block stays 1-D
    return kout[rows, :n], (gout[rows, :n] if gout is not None else None)


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of an integer key block ``(n,)``, or of each row of
    a batch ``(b, n)``.  Caller checks :func:`eligible` first."""
    if kernels.on_cuda(keys):
        return _kernel_sort(keys, None)[0]
    return plain_sort_keys(keys)


def sort_kv(keys: torch.Tensor, gid: torch.Tensor):
    """Ascending sort of (key, gid) pairs by the full pair order, in a
    block ``(n,)`` or each row of a batch ``(b, n)``; ``gid`` is the
    payload plan's int32 index channel."""
    if kernels.on_cuda(keys, gid):
        return _kernel_sort(keys, gid)
    return plain_sort_kv(keys, gid)
