"""K3: streamed dot product ``sum(x * (y + salt))`` with f32 accumulation.

Counterpart of ``dr_tpu/ops/reduce_pallas.py``.  ``salt`` is a device
scalar added to ``y`` inside the kernel: ``dot_n`` feeds each round's
result back through it, so the loop re-reads both operands every round
and never waits for the host.

Routes: CUDA tensors take ``csrc/dot.cu`` (per-block partials into a
scratch tensor, then a one-block sum — fixed order, no atomics); CPU
tensors take :func:`plain_dot`.
"""

from __future__ import annotations

import torch

from . import kernels

__all__ = ["chunked_dot", "plain_dot", "NPARTS"]

#: blocks of the first stage: fixed, so the summation order (and the
#: result) does not depend on the card
NPARTS = 1024
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _salt_tensor(salt, device):
    if salt is None or isinstance(salt, torch.Tensor):
        return salt
    return torch.tensor(float(salt), dtype=torch.float32, device=device)


def plain_dot(x: torch.Tensor, y: torch.Tensor, salt=None) -> torch.Tensor:
    """Plain PyTorch version: the f32 sum of ``x * (y + salt)``."""
    yf = y.to(torch.float32)
    if salt is not None:
        yf = yf + salt
    return (x.to(torch.float32) * yf).sum()


def _kernel_dot(x, y, salt):
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the K3 kernel takes f32/f16/bf16, not {x.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("the K3 kernel takes contiguous inputs")
    if salt is not None and (salt.dtype != torch.float32
                             or salt.device != x.device):
        raise ValueError("salt must be an f32 scalar on the inputs' device")
    partials = torch.empty(NPARTS, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    kernels.launch("chunked_dot", "dr_chunked_dot", x.device,
                   x.data_ptr(), y.data_ptr(), x.numel(), _DTYPE_CODE[x.dtype],
                   kernels.ptr(salt), partials.data_ptr(), NPARTS,
                   out.data_ptr(), kernels.stream_of(x))
    return out


def chunked_dot(x, y, *, salt=None) -> torch.Tensor:
    """``sum(x * (y + salt))`` of two equal-length 1-D tensors as an f32
    device scalar, in one read-only pass.  ``salt``: None, a number or
    an f32 scalar tensor on the inputs' device."""
    assert y.shape == x.shape and x.dtype == y.dtype and x.dim() == 1
    salt = _salt_tensor(salt, x.device)
    if kernels.on_cuda(x, y):
        return _kernel_dot(x, y, salt)
    return plain_dot(x, y, salt)
