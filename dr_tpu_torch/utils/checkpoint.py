"""Checkpoint and restore of distributed containers (counterpart of
``dr_tpu/utils/checkpoint.py``).

A container round-trips through one ``.npz`` archive: its logical value
and a ``meta`` JSON record of its layout.  The archive format is the JAX
package's, member for member, so a file written by either package loads
in the other.

* ``save()`` is atomic: the archive goes to a temp file in the same
  directory, is fsync'd and ``os.replace``'d into place, so a process
  killed mid-write leaves the previous checkpoint or nothing, never a torn
  file.  ``meta`` carries ``format_version``.
* ``load()`` raises :class:`~.resilience.CheckpointCorruptError` on a
  truncated, corrupt or newer-format file, never a raw zipfile error; a
  missing file stays ``FileNotFoundError``.
* bf16 data is written as the raw 2-byte ``|V2`` member that numpy writes
  for the JAX package's bfloat16 arrays, and a ``|V2`` member loads back
  as bf16 by reinterpreting its bits: a round trip, or a bf16 file the
  JAX package wrote, keeps every bit.

One process drives every rank, so ``save`` writes from it alone.  Not
carried over yet: the ``checkpoint.write`` / ``checkpoint.read`` fault
sites and the elastic layer's checkpoint registry (ROADMAP queue 1
item 3).
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib

import numpy as np
import torch

from ..core.vocabulary import rank
from .resilience import CheckpointCorruptError

__all__ = ["save", "load", "read", "snapshot", "rebuild",
           "FORMAT_VERSION"]

#: bump on any incompatible meta/arrays layout change; load() accepts
#: anything <= this (absent = 0, the unversioned format).
FORMAT_VERSION = 1

#: archive members each kind carries beyond ``meta``
_ARRAY_MEMBERS = {
    "vector": ("data",),
    "dense_matrix": ("data",),
    "mdarray": ("data",),
    "sparse_matrix": ("rows", "cols", "vals"),
}


def _raw_host(t: torch.Tensor) -> np.ndarray:
    """Host numpy of ``t`` with its bits: bf16 as the ``|V2`` array numpy
    writes for a bfloat16 array."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_raw(a: np.ndarray):
    """``a``, with a ``|V2`` member read back as the bf16 tensor it holds."""
    if a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def _member(f, fname: str, name: str):
    """Read one archive member, classifying corruption narrowly: load()
    raises deliberate ValueErrors (layout mismatches) that keep their
    class, so only the member read maps onto CheckpointCorruptError."""
    try:
        return f[name]
    except KeyError as e:
        raise CheckpointCorruptError(
            f"checkpoint {fname} is missing member {name!r}",
            site="checkpoint.read") from e
    except (zipfile.BadZipFile, zlib.error, EOFError, OSError,
            ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {fname} member {name!r} is corrupt: {e}",
            site="checkpoint.read") from e


def _final_path(path) -> str:
    """``np.savez`` appends .npz to bare paths; the atomic write controls
    the name, so normalize it once (load accepts both spellings)."""
    p = str(path)
    return p if p.endswith(".npz") else p + ".npz"


def _write_atomic(final: str, meta: dict, arrays: dict) -> None:
    """Write the archive to ``final`` through a temp file, fsync and
    rename; on any failure the temp file goes and ``final`` is untouched."""
    tmp = final + ".tmp"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, meta=json.dumps(meta), **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def snapshot(container):
    """The host ``(meta, arrays)`` state of ``container``: the front half
    of :func:`save` and of ``redistribute``'s matrix route."""
    from ..containers.distributed_vector import distributed_vector
    from ..containers.dense_matrix import dense_matrix
    from ..containers.sparse_matrix import sparse_matrix
    from ..containers.mdarray import distributed_mdarray

    if isinstance(container, distributed_vector):
        hb = container.halo_bounds
        meta = {"kind": "vector",
                "halo": [hb.prev, hb.next, bool(hb.periodic)]}
        dist = container.distribution
        if dist is not None:
            meta["sizes"] = [int(s) for s in dist.sizes]
        arrays = {"data": _raw_host(container.to_array())}
    elif isinstance(container, dense_matrix):
        meta = {"kind": "dense_matrix",
                "grid": [int(g) for g in container.grid_shape],
                "tile": [int(t) for t in container.partition.tile]}
        arrays = {"data": _raw_host(container.to_array())}
    elif isinstance(container, distributed_mdarray):
        meta = {"kind": "mdarray", "grid": [int(g) for g in container.grid]}
        arrays = {"data": _raw_host(container.to_array())}
    elif isinstance(container, sparse_matrix):
        rows, cols, vals = [], [], []
        for seg in container.__dr_segments__():
            r, c, v = seg.triples()
            if container.dtype == torch.bfloat16:  # triples widen bf16
                v = _raw_host(container._vals[rank(seg)][:len(seg)])
            rows.append(r)
            cols.append(c)
            vals.append(v)
        meta = {"kind": "sparse_matrix",
                "shape": [int(s) for s in container.shape],
                "grid": [int(g) for g in container.grid_shape]}
        arrays = {
            "rows": np.concatenate(rows) if rows else np.zeros(0, np.int64),
            "cols": np.concatenate(cols) if cols else np.zeros(0, np.int64),
            "vals": np.concatenate(vals) if vals else np.zeros(0),
        }
    else:
        raise TypeError(f"cannot checkpoint {type(container).__name__}")
    meta["format_version"] = FORMAT_VERSION
    return meta, arrays


def save(path: str, container) -> None:
    """Write ``container`` to ``path`` (``.npz`` appended if missing),
    atomically."""
    meta, arrays = snapshot(container)
    _write_atomic(_final_path(path), meta, arrays)


def rebuild(meta, arrays, *, runtime=None, reblock=False):
    """Rebuild a container from a ``(meta, arrays)`` snapshot: the back
    half of :func:`load` and of ``redistribute``'s matrix route.

    ``reblock=True`` drops the layout constraints (a vector's explicit
    block distribution) so the state lands on a runtime of another size
    with the default even layout; plain loads keep the mismatch errors."""
    from ..containers.distributed_vector import distributed_vector
    from ..containers.dense_matrix import dense_matrix
    from ..containers.sparse_matrix import sparse_matrix
    from ..containers.mdarray import distributed_mdarray
    from ..parallel.halo import halo_bounds

    kind = meta["kind"]
    if kind == "vector":
        prev, nxt, periodic = meta["halo"]
        hb = halo_bounds(int(prev), int(nxt), bool(periodic)) \
            if (prev or nxt) else None
        sizes = None if reblock else meta.get("sizes")
        if sizes is not None:
            from ..parallel import runtime as _rt
            P = (runtime or _rt.runtime()).nprocs
            if len(sizes) != P:
                raise ValueError(
                    f"checkpointed block_distribution has "
                    f"{len(sizes)} blocks but the current mesh "
                    f"has {P} shards; re-save without an "
                    "explicit distribution to re-block on load")
        return distributed_vector.from_array(
            _from_raw(arrays["data"]), halo=hb, distribution=sizes,
            runtime=runtime)
    if kind == "dense_matrix":
        part = _matrix_partition(meta, runtime, cyclic_ok=True)
        return dense_matrix.from_array(_from_raw(arrays["data"]), part,
                                       runtime=runtime)
    if kind == "mdarray":
        return distributed_mdarray.from_array(_from_raw(arrays["data"]),
                                              runtime=runtime)
    if kind == "sparse_matrix":
        part = _matrix_partition(meta, runtime, cyclic_ok=False)
        return sparse_matrix.from_coo(
            tuple(meta["shape"]), arrays["rows"], arrays["cols"],
            _from_raw(arrays["vals"]), partition=part, runtime=runtime)
    raise ValueError(f"unknown checkpoint kind: {kind}")


def read(path: str):
    """A checkpoint's raw ``(meta, arrays)`` snapshot, without rebuilding
    a container; the same classification as :func:`load`."""
    fname = _final_path(path)
    try:
        f = np.load(fname, allow_pickle=False)
    except (zipfile.BadZipFile, zlib.error, EOFError, ValueError) as e:
        # a truncated or torn archive; FileNotFoundError stays itself
        raise CheckpointCorruptError(
            f"unreadable checkpoint {fname}: {e}",
            site="checkpoint.read") from e
    with f:
        try:
            meta = json.loads(str(_member(f, fname, "meta")))
            kind = meta["kind"]
            version = int(meta.get("format_version", 0))
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"checkpoint {fname} has no readable meta record: {e}",
                site="checkpoint.read") from e
        if version > FORMAT_VERSION:
            raise CheckpointCorruptError(
                f"checkpoint {fname} written by a newer version "
                f"(format_version={version} > {FORMAT_VERSION}); "
                "upgrade to load it", site="checkpoint.read")
        if kind not in _ARRAY_MEMBERS:
            raise ValueError(f"unknown checkpoint kind: {kind}")
        # read every member inside the archive context, so a torn member
        # classifies before rebuild touches a device
        arrays = {name: _member(f, fname, name)
                  for name in _ARRAY_MEMBERS[kind]}
    return meta, arrays


def load(path: str, *, runtime=None, reblock=False):
    meta, arrays = read(path)
    return rebuild(meta, arrays, runtime=runtime, reblock=reblock)


def _matrix_partition(meta, runtime, *, cyclic_ok):
    """The checkpointed partition: exact when the saved grid fits the
    runtime; re-blocked (default grid) when a plain block layout moved to
    another rank count; an error when a cyclic layout cannot be
    represented there."""
    from ..containers.partition import block_cyclic, tile as _tile
    from ..parallel import runtime as _rt

    grid = meta.get("grid")
    tile = meta.get("tile", [_tile.div, _tile.div])
    if grid is None:
        return None
    P = (runtime or _rt.runtime()).nprocs
    gp, gq = int(grid[0]), int(grid[1])
    is_div = tuple(tile) == (_tile.div, _tile.div)
    if gp * gq == P:
        if is_div and not cyclic_ok and gq == 1:
            return None  # default row tiling: the container chooses
        return block_cyclic(tile=tuple(tile), grid=(gp, gq))
    if is_div:
        return None  # plain block layout: re-block on this runtime
    raise ValueError(
        f"checkpointed cyclic partition (grid {gp}x{gq}, tile {tile}) "
        f"does not fit the current {P}-device mesh; re-save with a "
        "block (tile.div) layout to re-block on load")
