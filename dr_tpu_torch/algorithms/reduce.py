"""Distributed reductions: ``reduce`` / ``transform_reduce`` / ``dot`` /
``dot_n`` (counterpart of ``dr_tpu/algorithms/reduce.py``; reference
``mhp/algorithms/cpu_algorithms.hpp:103-140``, ``shp/algorithms/
reduce.hpp``, ``examples/shp/dot_product.cpp``).

Each rank reduces its owned window cells with a torch reduction (the
JAX package leaves these to XLA), the per-rank partials are folded in
rank order, and the result is valid everywhere.  ``dot_n`` of
f32/bf16/f16 containers runs its rounds through the K3 kernel
(``ops/reduce_pallas.py``) on each rank's owned window cells, whatever
the length, halo or window, with the salt read from a device scalar, so
the loop never waits for the host.

Not ported yet: identityless custom-op folds, and the K7 route the JAX
package takes for min/max/integer monoids (a torch reduction here).
"""

from __future__ import annotations

import operator
from typing import Callable, Optional

import torch

from ._common import MONOID_COMBINE, f32_accumulable, identity_for, \
    window_cols
from .elementwise import _apply_ops, _resolve
from ..containers.distributed_vector import _as_tensor
from ..ops import reduce_pallas
from ..parallel import collectives
from ..views import views as _v

__all__ = ["reduce", "transform_reduce", "dot", "reduce_async",
           "dot_async", "dot_n"]


def _classify_op(op) -> Optional[str]:
    if op is None or op is operator.add or op is torch.add:
        return "add"
    if op is operator.mul or op is torch.mul:
        return "mul"
    if op is min or op is torch.minimum:
        return "min"
    if op is max or op is torch.maximum:
        return "max"
    return None


def _vec_reduce(kind, v: torch.Tensor) -> torch.Tensor:
    """The monoid's reduction of one tensor, in its own dtype."""
    if v.numel() == 0:
        return torch.tensor(identity_for(kind, v.dtype), dtype=v.dtype,
                            device=v.device)
    if kind == "add":
        return v.sum(dtype=v.dtype)
    if kind == "mul":
        return v.prod(dtype=v.dtype)
    return v.min() if kind == "min" else v.max()


def _fused_reduce(chains, kind, zip_op=None) -> torch.Tensor:
    """Per-rank reduction of the window cells of aligned chains (zip
    components combined by ``zip_op`` first), folded in rank order onto
    rank 0's device."""
    c0 = chains[0]
    cont = c0.cont
    parts = []
    for r in range(cont.nshards):
        a, b = window_cols(cont.layout, c0.off, c0.n, r)
        vals = [_apply_ops(c.cont._rows[r][0, a:b], c.ops) for c in chains]
        v = vals[0] if zip_op is None else zip_op(*vals)
        parts.append(_vec_reduce(kind, v))
    dev = cont.runtime.devices[0]
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = MONOID_COMBINE[kind](acc, p.to(dev))
    return acc


def _zip_reduce_chains(r):
    """(chains, zip_op) for a transform over a zip of aligned same-window
    container chains (the dot-product pipeline), else None."""
    if not (isinstance(r, _v.transform) and isinstance(r.base, _v.zip_view)):
        return None
    chains = _resolve(r.base)
    if not chains:
        return None
    c0 = chains[0]
    if not all(c.cont.layout == c0.cont.layout and c.off == c0.off
               and c.n == c0.n and c.cont.runtime is c0.cont.runtime
               for c in chains[1:]):
        return None
    return chains, r.op


def reduce_async(r, op: Callable = None) -> torch.Tensor:
    """Like :func:`reduce` but returns the device scalar without
    waiting (the analog of the reference's ``reduce_async``)."""
    kind = _classify_op(op)
    if kind is None:
        raise NotImplementedError(
            "reduce with an unclassified op (identityless fold) is not "
            "ported yet; use add/mul/min/max")
    chains = _resolve(r) if not isinstance(r, _v.zip_view) else None
    zip_op = None
    if chains is not None and len(chains) != 1:
        chains = None
    if chains is None:
        zipped = _zip_reduce_chains(r)
        if zipped is not None:
            chains, zip_op = zipped
    if chains is not None:
        return _fused_reduce(chains, kind, zip_op)
    arr = r.to_array() if hasattr(r, "to_array") else _as_tensor(r)
    assert not isinstance(arr, tuple), \
        "reduce over a zip needs a transform to combine components"
    return _vec_reduce(kind, arr)


def reduce(r, init=None, op: Callable = None):
    """Collective reduction; returns a host scalar."""
    val = reduce_async(r, op).item()
    if init is not None:
        pyop = op if op is not None else operator.add
        return pyop(init, val)
    return val


def _identity(x):
    return x


def _multiply2(x, y):
    return x * y


def transform_reduce(r, init=None, reduce_op=None, transform_op=None,
                     transform_args=()):
    """reduce(transform(r)); ``transform_args`` bind trailing scalars."""
    return reduce(_v.transform(r, transform_op or _identity,
                               *transform_args), init, reduce_op)


def dot(a, b, init=None):
    """Dot product: zip | transform(*) | reduce (dot_product.cpp:11-18)."""
    return reduce(_v.transform(_v.zip_view(a, b), _multiply2), init,
                  operator.add)


def dot_async(a, b) -> torch.Tensor:
    return reduce_async(_v.transform(_v.zip_view(a, b), _multiply2),
                        operator.add)


def _dot_n_chains(a, b):
    chains = _resolve(_v.zip_view(a, b))
    assert chains is not None and len(chains) == 2, \
        "dot_n needs two aligned container chains"
    c0, c1 = chains
    assert c0.cont.layout == c1.cont.layout and c0.off == c1.off \
        and c0.n == c1.n
    assert not c0.ops and not c1.ops, "dot_n takes plain containers"
    return c0, c1


def _k3_takes(c0, c1) -> bool:
    """K3 serves ``dot_n`` over f32/bf16/f16 operands of one dtype."""
    return f32_accumulable(c0.cont.dtype) and c0.cont.dtype == c1.cont.dtype


def dot_n(a, b, iters: int) -> torch.Tensor:
    """``iters`` chained dot products; each round adds ``carry * 1e-38``
    to one operand (the JAX package's salt), so every round re-reads
    both inputs.  Returns the final device scalar; the loop never
    synchronizes with the host."""
    c0, c1 = _dot_n_chains(a, b)
    cont = c0.cont
    devs = cont.runtime.devices
    s = torch.zeros((), dtype=torch.float32, device=devs[0])
    cols = [window_cols(cont.layout, c0.off, c0.n, r)
            for r in range(cont.nshards)]
    xs = [row[0, lo:hi] for row, (lo, hi) in zip(c0.cont._rows, cols)]
    ys = [row[0, lo:hi] for row, (lo, hi) in zip(c1.cont._rows, cols)]
    if _k3_takes(c0, c1):
        for _ in range(iters):
            salt = s * 1e-38
            local = [reduce_pallas.chunked_dot(x, y, salt=salt.to(x.device))
                     for x, y in zip(xs, ys)]
            s = collectives.psum(local, devs[0])
        return s
    s = s.to(cont.dtype)
    for _ in range(iters):
        parts = [(x * (y + (s * 1e-38).to(y.device))).sum()
                 for x, y in zip(xs, ys)]
        s = collectives.psum(parts, devs[0]).to(cont.dtype)
    return s
