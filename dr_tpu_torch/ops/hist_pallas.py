"""K8: the histogram's bincount, an int32 sum of counts per bucket id.

Counterpart of ``dr_tpu/ops/hist_pallas.py`` (``bincount`` :32).  The
JAX package's K8 has no kernel body of its own: it is K7 with one int32
sum column, kept as its own arm so that a histogram routes and counts on
its own.  The port keeps that shape: a CUDA tensor takes K7's kernel
(``csrc/segred.cu``, entry point ``dr_segred``) with ids = the bucket ids,
``nseg = bins`` and the counts as one ``sum`` column, and the launch is
counted as ``kernels.launches["hist"]``, not as ``segred``.  A CPU tensor
takes :func:`plain_bincount`.  An integer sum is order-free, so the two
agree bit for bit.

On the card each element of a histogram's unsorted ids is one shared-
memory atomic (K7's run-length fold only helps runs of equal ids); the
ids and counts are read 16 bytes at a time, and a call makes one launch
where the blocks' bin tables fit K7's partials (16 bins), two above; the
bound is the bytes of the ids and counts, read once.

Eligibility is ``1 <= bins <= 2^15`` (the kernel's per-block key table)
and any ``n``: the JAX package's ``n <= 2^15`` cap was the VMEM footprint
of its mask and is dropped, as for K7.
"""

from __future__ import annotations

import torch

from . import kernels, segred_pallas

__all__ = ["eligible", "bincount", "plain_bincount"]


def eligible(n: int, bins: int) -> bool:
    return segred_pallas.eligible(n, bins, ((torch.int32, "sum"),))


def plain_bincount(bucket, counts, bins: int):
    """Plain PyTorch version: ``scatter_add_`` of the int32 ``counts``
    into ``bins`` buckets; ids outside ``[0, bins)`` contribute nothing."""
    ids = bucket.to(torch.int64)
    keep = (ids >= 0) & (ids < bins)
    out = torch.zeros(bins, dtype=torch.int32, device=counts.device)
    return out.scatter_add_(0, torch.where(keep, ids, 0),
                            torch.where(keep, counts, 0))


def bincount(bucket, counts, bins: int):
    """Sum int32 ``counts`` into ``bins`` buckets keyed by int32
    ``bucket`` ids; out-of-range ids contribute nothing.  Caller checks
    :func:`eligible` first."""
    if kernels.on_cuda(bucket, counts):
        return segred_pallas._kernel_segmented(
            bucket, bins, ((counts, "sum"),), counter="hist")[0]
    return plain_bincount(bucket, counts, bins)
