"""Dense matrix products over tiled matrices.

Counterpart of ``dr_tpu/algorithms/gemv.py``; this slice ports ``gemm``
only (the sparse gemv/spmm family comes with the sparse containers).
The JAX package computes the product outside any Pallas kernel
(``jnp.matmul`` with f32 accumulation), so here it is one
``torch.matmul`` on the logical arrays: full f32 unless the caller turns
TF32 on (``torch.backends.cuda.matmul.allow_tf32``, off by default).
"""

from __future__ import annotations

import torch

from ..containers.dense_matrix import dense_matrix

__all__ = ["gemm"]


def gemm(a: dense_matrix, b: dense_matrix,
         out: dense_matrix = None) -> dense_matrix:
    """Dense C = A·B on 2-D tiled matrices; returns ``out`` (a new
    matrix in the default partition when None)."""
    m, k = a.shape
    k2, n = b.shape
    assert k == k2
    if out is None:
        out = dense_matrix((m, n), a.dtype, runtime=a.runtime)
    # f32 accumulation for the half types, as preferred_element_type does
    acc = (torch.float32 if a.dtype in (torch.bfloat16, torch.float16)
           else a.dtype)
    prod = torch.matmul(a.to_array().to(acc), b.to_array().to(acc))
    out.assign_array(prod.to(out.dtype))
    return out
