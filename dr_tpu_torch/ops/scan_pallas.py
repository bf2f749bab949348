"""K4: inclusive f32 add-scan of a 1-D tensor, carry seeded.

Counterpart of ``dr_tpu/ops/scan_pallas.py``.  ``carry`` (an f32 device
scalar, default 0) seeds the running sum: the distributed scan passes
each rank's exclusive cross-rank carry here, so no separate fixup pass
touches the data.  Sums are f32 for f32/bf16/f16 input; the output has
the input's dtype.

Routes: CUDA tensors take ``csrc/scan.cu`` (one launch: each block
reads a tile once, finds its prefix by a fixed-order look-back over the
tiles before it, and writes the tile once; the same bits on every run);
CPU tensors take :func:`plain_cumsum`.
"""

from __future__ import annotations

import torch

from . import kernels

__all__ = ["chunked_cumsum", "plain_cumsum"]

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_TILE_BYTES = 32768   # bytes of x a tile of csrc/scan.cu holds
_WS_HEAD = 16         # its ticket's 64-bit words; then two status words a tile


def plain_cumsum(x: torch.Tensor, carry=None) -> torch.Tensor:
    """Plain PyTorch version: f32 cumsum plus the carry, in x's dtype."""
    out = torch.cumsum(x.to(torch.float32), 0)
    if carry is not None:
        out = out + carry
    return out.to(x.dtype)


def _kernel_cumsum(x, carry):
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the K4 kernel takes f32/f16/bf16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the K4 kernel takes a contiguous input")
    if carry is not None and (carry.dtype != torch.float32
                              or carry.device != x.device):
        raise ValueError("carry must be an f32 scalar on the input's device")
    n, size = x.numel(), x.element_size()
    shift = x.data_ptr() % 16 // size   # x's offset within 16 bytes
    ws = torch.zeros(_WS_HEAD + 2 * -(-(n + shift) // (_TILE_BYTES // size)),
                     dtype=torch.int64, device=x.device)
    # the output shares x's offset within 16 bytes, so the kernel's
    # 16-byte loads and stores line up in both
    out = torch.empty(n + shift, dtype=x.dtype, device=x.device)[shift:]
    kernels.launch("chunked_cumsum", "dr_chunked_cumsum", x.device,
                   x.data_ptr(), n, _DTYPE_CODE[x.dtype], kernels.ptr(carry),
                   ws.data_ptr(), ws.numel(), out.data_ptr(),
                   kernels.stream_of(x))
    return out


def chunked_cumsum(x, *, carry=None) -> torch.Tensor:
    """Inclusive add-scan of a 1-D float tensor, seeded with ``carry``
    (None, a number, or an f32 scalar tensor on x's device)."""
    assert x.dim() == 1
    if carry is not None and not isinstance(carry, torch.Tensor):
        carry = torch.tensor(float(carry), dtype=torch.float32,
                             device=x.device)
    if kernels.on_cuda(x):
        return _kernel_cumsum(x, carry)
    return plain_cumsum(x, carry)
