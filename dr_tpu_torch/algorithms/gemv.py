"""Distributed matrix products: sparse ``gemv`` / ``spmm`` and dense
``gemm`` (counterpart of ``dr_tpu/algorithms/gemv.py``; reference
``shp/algorithms/gemv.hpp:16-73``).

``gemv(c, a, b)``: c += A·b.  Every rank contracts its tile of A against
``b`` (the whole of it for row tiles, the tile's column window for 2-D
grids) in the layout the matrix chose at build time, resolved down the
JAX package's fallback chain (:func:`resolved_format`):

* ``csr``: the padded COO, ``vals * b[cols]`` summed per row in a fixed
  order (the tile's entries sorted by row once, then
  ``torch.segment_reduce``);
* ``ell``: a gather of ``b`` through the ``(rows, kmax)`` column tensor
  and a row sum;
* ``bcsr``: one 128-wide slice of ``b`` a dense 8 x 128 block, the
  blocks multiplied and summed;
* ``ring`` (row tiles, forced through :func:`_gemv_as`): ``b`` split
  into one window a rank that rotates around the ring
  (``parallel/pipeline.ring_pipeline``) while each rank contracts the
  bucket of its entries that fall in the window it holds.

Row tiles add each rank's partial into the rows of ``c`` it owns when
``c`` is laid out like the tiles; 2-D grids sum the partials of a tile
row over the grid's columns in column order (``collectives.psum``).
Every sum runs in an order fixed by the shapes alone (no atomics), so
a call gives the same bits every time, and the ring's two schedules
give the same bits.  The JAX package computes all of this outside any
Pallas kernel, and so does the port: torch gathers, products and sums.

``spmm(a, B)`` is the same contraction against ``nv`` right-hand sides;
``gemv_n`` / ``spmm_n`` chain calls with the JAX package's salt (each
round adds ``1e-38`` times a value of the last output to ``b``);
``gemv_phases_n`` truncates the ring after a phase of
:data:`SPMV_PHASES`.

``gemm(a, b)``: dense C = A·B on tiled matrices, one ``torch.matmul``
on the logical arrays (the JAX package's ``jnp.matmul`` with f32
accumulation): full f32 unless the caller turns TF32 on.

Not carried over: the ``DR_TPU_SPMV_FORMAT`` override, the tuning-DB
format lookup and the TPU gather knobs (``DR_TPU_GATHER_MODE`` / ``_W``,
``DR_TPU_SPMM_W``, ``DR_TPU_SPMV_COMBINE``); the plan hooks and the
``fire_ppermute`` fault sites come with the host-side layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import uniform_layout
from ..containers.dense_matrix import dense_matrix
from ..containers.distributed_vector import _as_tensor, distributed_vector
from ..containers.sparse_matrix import sparse_matrix
from ..parallel import collectives
from ..parallel import pipeline as _pl

__all__ = ["gemv", "gemv_n", "gemv_phases_n", "flat_gemv", "gemm", "spmm",
           "spmm_n", "viable_formats", "resolved_format",
           "resolved_spmm_format", "SPMV_PHASES"]

#: the ring SpMV's phase ladder: "local_compute" = every bucket
#: contracted against the rank's own window, no rotation; "rotate" = the
#: full ring, only a scalar written; "combine" = the full call
SPMV_PHASES = ("local_compute", "rotate", "combine")

_BW = sparse_matrix._BCSR_BW
_SALT = 1e-38


def viable_formats(a) -> dict:
    """Which layouts a forced format would run for ``a`` (building the
    ones that pass their gates)."""
    return {"csr": True, "ell": a.ensure_ell(),
            "bcsr": a.ensure_bcsr(), "ring": a.ensure_ring()}


def _resolve(a, fmt: str) -> str:
    """``fmt`` resolved down the dispatch chain: ring, then bcsr, then
    ell unless csr was asked for, then csr."""
    if fmt == "ring" and a.ensure_ring():
        return "ring"
    if fmt == "bcsr" and a.ensure_bcsr():
        return "bcsr"
    if fmt != "csr" and a.ensure_ell():
        return "ell"
    return "csr"


def resolved_format(a) -> str:
    """The layout ``gemv`` / ``gemv_n`` run for ``a``: its autoselected
    format resolved down the fallback chain."""
    return _resolve(a, a.format)


def resolved_spmm_format(a) -> str:
    """The layout ``spmm_n`` runs: only the grouped ones exist there,
    so csr and ring resolve to ELL."""
    return "bcsr" if a.format == "bcsr" and a.ensure_bcsr() else "ell"


# ----------------------------------------------------- one tile's partial

def _acc_dtype(a, x):
    return torch.promote_types(torch.promote_types(a.dtype, x.dtype),
                               torch.float32)


def _csr_local(a, t, x):
    """Tile t's ``(th,) + x.shape[1:]`` partial from the padded COO: the
    tile's products in row order, one ``segment_reduce`` sum a row."""
    c = int(a._tile_nnz[t])
    perm, lengths = a._ensure_csr_order()[t]
    if c == 0:
        return x.new_zeros((a.tile_rows,) + x.shape[1:],
                           dtype=_acc_dtype(a, x))
    vals = a._vals[t][:c]
    contrib = torch.index_select(x, 0, a._cols[t][:c]) * \
        vals.view((c,) + (1,) * (x.dim() - 1))
    return torch.segment_reduce(torch.index_select(contrib, 0, perm), "sum",
                                lengths=lengths, axis=0)


def _ell_local(vals, cols, x):
    """``(rows,) + x.shape[1:]`` row sums of ``vals * x[cols]`` over a
    ``(rows, k)`` ELL block.  Several right-hand sides gather one slot of
    every row at a time, added in slot order: one gather of all the
    rows' ``nv``-wide slices takes ~4x as long on an H100
    (``tools/spmv_probe.py``)."""
    if x.dim() == 1:
        g = torch.index_select(x, 0, cols.reshape(-1)).view(cols.shape)
        return (g * vals).sum(1)
    y = vals[:, :1] * torch.index_select(x, 0, cols[:, 0])
    for j in range(1, cols.shape[1]):
        y = y + vals[:, j:j + 1] * torch.index_select(x, 0, cols[:, j])
    return y


def _bcsr_local(bvals, bcols, x, rows):
    """``(rows,) + x.shape[1:]`` from dense (8, 128) blocks: one 128-row
    slice of ``x`` a block, multiplied and summed over the blocks of a
    block-row and their columns."""
    pad = (-x.shape[0]) % _BW
    xp = F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad)) if pad else x
    nbr, kb = bcols.shape
    g = torch.index_select(xp.reshape((-1, _BW) + x.shape[1:]), 0,
                           bcols.reshape(-1)).view(
                               (nbr, kb, 1, _BW) + x.shape[1:])
    prod = bvals.view(bvals.shape + (1,) * (x.dim() - 1)) * g
    return prod.sum(dim=(1, 3)).reshape((-1,) + x.shape[1:])[:rows]


def _local(a, t, fmt, x):
    """Tile t's partial in layout ``fmt`` (csr / ell / bcsr) against
    ``x``, the tile's column window of the right-hand side(s), on the
    tile's device."""
    if fmt == "bcsr":
        return _bcsr_local(a._bcsr_vals[t], a._bcsr_cols[t], x, a.tile_rows)
    if fmt == "ell":
        return _ell_local(a._ell_vals[t], a._ell_cols[t], x)
    return _csr_local(a, t, x)


# ------------------------------------------------------------ dispatchers

def _rhs(b, n, ndim):
    arr = b.to_array() if hasattr(b, "to_array") else _as_tensor(b)
    assert arr.dim() == ndim and arr.shape[0] == n, \
        f"right-hand side of shape {tuple(arr.shape)} for {n} columns"
    return arr


def _grid_product(a, fmt, x):
    """A·x over any tile grid: each tile's partial against its column
    window, summed over each tile row's columns in column order; the
    ``(m,) + x.shape[1:]`` result on rank 0's device."""
    gp, gq = a.grid_shape
    th, tw = a.tile_rows, a.tile_cols
    pad = gq * tw - x.shape[0]
    xp = F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad)) if pad else x
    devs = a.runtime.devices
    parts = [_local(a, t, fmt, xp[(t % gq) * tw:(t % gq + 1) * tw]
                    .to(devs[t]))
             for t in range(a.nshards)]
    rows = [collectives.psum(parts[i * gq:(i + 1) * gq], devs[0])
            for i in range(gp)]
    return torch.cat(rows)[:a.shape[0]]


def _aligned(c, a) -> bool:
    """Rank r of ``c`` owns exactly tile r's rows."""
    return (isinstance(c, distributed_vector) and a.grid_shape[1] == 1
            and uniform_layout(c.layout) and c.nshards == a.nshards
            and c.segment_size == a.tile_rows and c.runtime is a.runtime)


def _salted(x, c, r):
    """``x`` plus ``1e-38`` times rank r's first owned cell of ``c``:
    chained rounds re-read ``b`` and depend on the last output."""
    row = c._rows[r]
    return x + row[0, c.halo_bounds.prev] * _SALT


def _add_rows(c, r, local):
    prev, seg = c.halo_bounds.prev, c.segment_size
    row = c._rows[r]
    row[0, prev:prev + seg] += local[:seg].to(row.dtype)


def _tile_gemv(c, a, fmt, b, salted=False):
    """c += A·b on the aligned row-tile path, one partial a rank."""
    for r, d in enumerate(a.runtime.devices):
        x = b.to(d)
        _add_rows(c, r, _local(a, r, fmt, _salted(x, c, r) if salted
                               else x))


def _ring_gemv(c, a, b, stop_after=None, salted=False):
    """One ring SpMV into ``c`` (row tiles, ring layout built): rank r
    starts with window r of ``b`` and contracts bucket t against the
    window it holds at step t; ``stop_after`` truncates the call after a
    phase of :data:`SPMV_PHASES`."""
    P, th, bw = a.nshards, a.tile_rows, a._ring_bw
    devs = a.runtime.devices
    pad = P * bw - b.shape[0]
    bp = F.pad(b, (0, pad)) if pad else b
    blocks = []
    for r, d in enumerate(devs):
        x = bp[r * bw:(r + 1) * bw].to(d)
        blocks.append(_salted(x, c, r) if salted else x)
    acc = _acc_dtype(a, b)
    carry = [torch.zeros(th, dtype=acc, device=d) for d in devs]

    def contract(t, r, y, blk):
        return y + _ell_local(a._ring_vals[r][t], a._ring_cols[r][t], blk)

    if stop_after == "local_compute":
        ys = []
        for r in range(P):
            y = carry[r]
            for t in range(P):
                y = contract(t, r, y, blocks[r])
            ys.append(y)
    else:
        ys = _pl.ring_pipeline(devs, carry, blocks, contract)
    for r, y in enumerate(ys):
        if stop_after == "rotate":
            # every row's contraction stays live in the one value written
            row = c._rows[r]
            row[0, c.halo_bounds.prev] += y.sum().to(row.dtype)
        else:
            _add_rows(c, r, y)


def _gemv_as(c, a, b, fmt: str):
    """c += A·b in layout ``fmt`` (csr / ell / bcsr / ring), resolved
    down the fallback chain where its gate refuses it."""
    assert isinstance(a, sparse_matrix)
    m, n = a.shape
    assert len(c) == m, "output length must equal matrix rows"
    b = _rhs(b, n, 1)
    if a._vals is None:
        return c  # empty matrix: nothing to add
    if _aligned(c, a):
        fmt = _resolve(a, fmt)
        if fmt == "ring":
            _ring_gemv(c, a, b)
        else:
            _tile_gemv(c, a, fmt, b)
        return c
    # 2-D grids combine partials in their layout; a row-tiled matrix
    # whose rows c does not own as the tiles do takes the csr partials
    y = _grid_product(a, _resolve(a, fmt) if a.grid_shape[1] > 1
                      else "csr", b)
    c.assign_array(c.to_array() + y.to(c.dtype))
    return c


def gemv(c: distributed_vector, a: sparse_matrix, b) -> distributed_vector:
    """c += A·b (reference gemv semantics: accumulate into ``c``) in the
    matrix's autoselected layout; returns ``c``."""
    return _gemv_as(c, a, b, a.format)


def _fast_args(c, a, b):
    assert isinstance(a, sparse_matrix) and a.grid_shape[1] == 1
    assert _aligned(c, a), "fused gemv needs the aligned fast path"
    return _rhs(b, a.shape[1], 1)


def gemv_n(c: distributed_vector, a: sparse_matrix, b, iters: int):
    """``iters`` chained SpMVs into ``c`` (row tiles, ``c`` laid out like
    the tiles): each round adds ``1e-38`` times the rank's first owned
    cell of ``c`` to ``b``, so every round re-reads ``b`` and waits for
    the last; like ``iters`` gemv calls up to that salt."""
    b = _fast_args(c, a, b)
    fmt = resolved_format(a)
    for _ in range(iters):
        if fmt == "ring":
            _ring_gemv(c, a, b, salted=True)
        else:
            _tile_gemv(c, a, fmt, b, salted=True)
    return c


def gemv_phases_n(c: distributed_vector, a: sparse_matrix, b,
                  stop_after: str, iters: int):
    """``iters`` rounds of the ring SpMV truncated after ``stop_after``
    (:data:`SPMV_PHASES`); one round is exactly the ring ``gemv``.
    Needs the ring layout (``a.ensure_ring()``)."""
    assert stop_after in SPMV_PHASES, (stop_after, SPMV_PHASES)
    have_ring = a.ensure_ring()
    assert have_ring, "gemv_phases_n profiles the ring schedule"
    b = _fast_args(c, a, b)
    stop = None if stop_after == SPMV_PHASES[-1] else stop_after
    for _ in range(iters):
        _ring_gemv(c, a, b, stop_after=stop, salted=iters > 1)
    return c


def flat_gemv(a: sparse_matrix, b) -> torch.Tensor:
    """A·b as an ``(m,)`` tensor on rank 0's device (no output
    container): each tile's csr partial, summed over the tile rows'
    columns.  Any tile grid."""
    b = _rhs(b, a.shape[1], 1)
    if a._vals is None:
        return torch.zeros(a.shape[0], dtype=a.dtype,
                           device=a.runtime.devices[0])
    return _grid_product(a, "csr", b).to(a.dtype)


def spmm(a: sparse_matrix, b) -> torch.Tensor:
    """A·B for a dense ``(n, nv)`` right-hand side; returns the
    ``(m, nv)`` product on rank 0's device.  The grouped layouts (ELL,
    BCSR) contract all ``nv`` columns at once, on row tiles and 2-D
    grids; csr and the layouts their gates refuse take one
    :func:`flat_gemv` a column."""
    assert isinstance(a, sparse_matrix)
    m, n = a.shape
    B = _as_tensor(b.to_array() if hasattr(b, "to_array") else b)
    assert B.dim() == 2 and B.shape[0] == n, \
        f"spmm needs a ({n}, nv) dense right-hand side, got {tuple(B.shape)}"
    if a._vals is None:
        return torch.zeros((m, B.shape[1]), dtype=a.dtype,
                           device=a.runtime.devices[0])
    fmt = a.format  # "ring" has no spmm form: the grouped path
    if fmt != "csr":
        if fmt == "bcsr" and a.ensure_bcsr():
            return _grid_product(a, "bcsr", B)
        if a.ensure_ell():
            return _grid_product(a, "ell", B)
    return torch.stack([flat_gemv(a, B[:, j]) for j in range(B.shape[1])],
                       dim=1)


def spmm_n(a: sparse_matrix, b, iters: int) -> torch.Tensor:
    """``iters`` chained SpMMs (row tiles, a grouped layout): each round
    adds ``1e-38`` times the rank's first output value of the last
    round to ``B``.  Returns the last product, ``(m, nv)`` on rank 0's
    device."""
    assert isinstance(a, sparse_matrix) and a.grid_shape[1] == 1
    m, n = a.shape
    B = _as_tensor(b.to_array() if hasattr(b, "to_array") else b)
    assert B.dim() == 2 and B.shape[0] == n
    fmt = resolved_spmm_format(a)
    have = a.ensure_bcsr() if fmt == "bcsr" else a.ensure_ell()
    assert have, "spmm_n needs a grouped (BCSR/ELL) fast path"
    devs = a.runtime.devices
    Bs = [B.to(d) for d in devs]
    ys = [torch.zeros((a.tile_rows, B.shape[1]), dtype=_acc_dtype(a, B),
                      device=d) for d in devs]
    for _ in range(iters):
        ys = [_local(a, r, fmt, Bs[r] + ys[r][0, 0] * _SALT).to(ys[r].dtype)
              for r in range(a.nshards)]
    return torch.cat([y.to(devs[0]) for y in ys])[:m]


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
