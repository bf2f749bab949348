"""dr_tpu_torch's checkpoint against dr_tpu on the CPU: round trips in
the port, files crossing between the packages in both directions, and
the failure model (atomic writes, versioning, classified corrupt-file
errors).

A checkpoint stores values, so every comparison is bit for bit."""

import io
import json
import os
import zipfile

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.utils import checkpoint as jck
from dr_tpu_torch.utils import checkpoint as tck
from dr_tpu_torch.utils.resilience import CheckpointCorruptError


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)


def _rows(v):
    return np.concatenate([r.numpy() for r in v.rows])


def _uneven(n, P, seed):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, n + 1, size=P - 1))
    b = np.concatenate(([0], cuts, [n]))
    return [int(y - x) for x, y in zip(b[:-1], b[1:])]


# ---------------------------------------------------------- round trips

def test_vector_roundtrip(tmp_path, mesh_size):
    _init_both(mesh_size)
    src = np.random.default_rng(0).standard_normal(37).astype(np.float32)
    dv = dt.distributed_vector.from_array(src, halo=dt.halo_bounds(1, 1))
    tck.save(str(tmp_path / "vec.npz"), dv)
    back = tck.load(str(tmp_path / "vec.npz"))
    assert back.halo_bounds == dv.halo_bounds and back.layout == dv.layout
    np.testing.assert_array_equal(_rows(back), _rows(dv))


def test_distribution_roundtrip(tmp_path, mesh_size):
    """Placement survives, not just values (test_distribution.py:236)."""
    _init_both(mesh_size)
    n = 23
    sizes = _uneven(n, mesh_size, seed=6)
    src = np.arange(n, dtype=np.float32)
    dv = dt.distributed_vector.from_array(src, distribution=sizes)
    dt.checkpoint.save(str(tmp_path / "dv_dist"), dv)
    back = dt.checkpoint.load(str(tmp_path / "dv_dist"))
    assert back.layout == dv.layout
    np.testing.assert_array_equal(dt.to_numpy(back), src)
    if mesh_size > 1:  # an explicit distribution needs its rank count
        dt.init(["cpu"] * (mesh_size - 1))
        with pytest.raises(ValueError):
            dt.checkpoint.load(str(tmp_path / "dv_dist"))
        back = dt.checkpoint.load(str(tmp_path / "dv_dist"), reblock=True)
        assert back.distribution is None
        np.testing.assert_array_equal(dt.to_numpy(back), src)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float16,
                                   np.uint8, np.float64])
def test_dtypes_roundtrip(tmp_path, dtype):
    _init_both(4)
    src = (np.random.default_rng(1).standard_normal(29) * 40).astype(dtype)
    tck.save(str(tmp_path / "v"), dt.distributed_vector.from_array(src))
    back = tck.load(str(tmp_path / "v"))
    got = dt.to_numpy(back)
    assert got.dtype == src.dtype
    np.testing.assert_array_equal(got, src)


def test_bf16_roundtrip_and_reference_file(tmp_path):
    """bf16 is written as the raw ``|V2`` member dr_tpu writes, and a
    ``|V2`` member loads back as bf16: every bit kept, in a port round
    trip and from a dr_tpu-written file."""
    _init_both(8)
    bits = np.random.default_rng(2).integers(-2 ** 15, 2 ** 15, 41,
                                             dtype=np.int64).astype(np.int16)
    t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    dv = dt.distributed_vector.from_array(t)
    tck.save(str(tmp_path / "bf"), dv)
    with np.load(str(tmp_path / "bf.npz")) as f:
        assert f["data"].dtype == np.dtype("V2")
    back = tck.load(str(tmp_path / "bf"))
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.to_array().view(torch.int16).numpy(),
                                  bits)
    src = np.random.default_rng(3).standard_normal(41).astype(
        ml_dtypes.bfloat16)
    jck.save(str(tmp_path / "jbf"), dr_tpu.distributed_vector.from_array(src))
    back = tck.load(str(tmp_path / "jbf"))
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.to_array().view(torch.int16).numpy(),
                                  src.view(np.int16))
    m = dt.dense_matrix.from_array(t[:40].reshape(5, 8))
    tck.save(str(tmp_path / "bfm"), m)
    mb = tck.load(str(tmp_path / "bfm"))
    assert torch.equal(mb.to_array().view(torch.int16),
                       m.to_array().view(torch.int16))


def test_matrix_roundtrips(tmp_path, mesh_size):
    _init_both(mesh_size)
    rng = np.random.default_rng(4)
    src = rng.standard_normal((9, 7)).astype(np.float32)
    tck.save(str(tmp_path / "mat"), dt.dense_matrix.from_array(src))
    np.testing.assert_array_equal(tck.load(str(tmp_path / "mat"))
                                  .materialize(), src)
    part = dt.block_cyclic(tile=(4, 4), grid=dt.factor(mesh_size))
    csrc = np.arange(16 * 16, dtype=np.float32).reshape(16, 16)
    tck.save(str(tmp_path / "cyc"), dt.dense_matrix.from_array(csrc, part))
    back = tck.load(str(tmp_path / "cyc"))
    assert back.partition.tile == (4, 4)
    assert back.grid_shape == part.grid
    assert not back.is_block
    np.testing.assert_array_equal(back.materialize(), csrc)
    cube = rng.standard_normal((4, 5, 3)).astype(np.float32)
    tck.save(str(tmp_path / "md"), dt.distributed_mdarray.from_array(cube))
    np.testing.assert_array_equal(tck.load(str(tmp_path / "md"))
                                  .materialize(), cube)
    d = np.zeros((12, 12), dtype=np.float32)
    d[3, 4], d[11, 1], d[0, 0] = 2.0, -1.0, 0.5
    for sp_part in (None, dt.block_cyclic(grid=dt.factor(mesh_size))):
        sp = dt.sparse_matrix.from_dense(d, partition=sp_part)
        tck.save(str(tmp_path / "sp"), sp)
        back = tck.load(str(tmp_path / "sp"))
        assert back.grid_shape == sp.grid_shape
        np.testing.assert_array_equal(back.to_dense(), d)


# ------------------------------------------------- files across packages

def _jax_containers(P):
    rng = np.random.default_rng(5)
    vec = rng.standard_normal(37).astype(np.float32)
    mat = rng.standard_normal((16, 16)).astype(np.float32)
    cube = rng.standard_normal((2 * P, 5, 3)).astype(np.float32)
    d = np.zeros((16, 12), np.float32)
    d[rng.integers(0, 16, 20), rng.integers(0, 12, 20)] = \
        rng.standard_normal(20)
    return vec, mat, cube, d


@pytest.mark.parametrize("kind", ["vector", "halo_vector", "dist_vector",
                                  "dense", "cyclic", "sparse", "sparse2d",
                                  "mdarray"])
def test_files_cross_both_ways(tmp_path, kind):
    """A file dr_tpu writes loads in the port and one the port writes
    loads in dr_tpu, with the same layout and values; the two packages
    write the same meta record and members."""
    P = 8
    _init_both(P)
    vec, mat, cube, d = _jax_containers(P)
    build = {
        "vector": lambda pkg: pkg.distributed_vector.from_array(vec),
        "halo_vector": lambda pkg: pkg.distributed_vector.from_array(
            vec, halo=pkg.halo_bounds(2, 1, periodic=True)),
        "dist_vector": lambda pkg: pkg.distributed_vector.from_array(
            vec, distribution=_uneven(len(vec), P, seed=7)),
        "dense": lambda pkg: pkg.dense_matrix.from_array(mat),
        "cyclic": lambda pkg: pkg.dense_matrix.from_array(
            mat, pkg.block_cyclic(tile=(4, 4), grid=pkg.factor(P))),
        "sparse": lambda pkg: pkg.sparse_matrix.from_dense(d),
        "sparse2d": lambda pkg: pkg.sparse_matrix.from_dense(
            d, partition=pkg.block_cyclic(grid=pkg.factor(P))),
        "mdarray": lambda pkg: pkg.distributed_mdarray.from_array(cube),
    }[kind]

    def value(c):
        if kind.startswith("sparse"):
            return c.to_dense()
        return np.asarray(c.materialize())

    def layout(c):
        if "vector" in kind:
            return c.layout
        if kind.startswith("sparse"):
            return c.grid_shape
        if kind == "mdarray":
            return c.grid
        return (c.grid_shape, tuple(c.partition.tile))

    jc, tc = build(dr_tpu), build(dt)
    jck.save(str(tmp_path / "j"), jc)
    tck.save(str(tmp_path / "t"), tc)
    with np.load(str(tmp_path / "j.npz")) as fj, \
            np.load(str(tmp_path / "t.npz")) as ft:
        assert sorted(fj.files) == sorted(ft.files)
        assert json.loads(str(fj["meta"])) == json.loads(str(ft["meta"]))
        for name in fj.files:
            np.testing.assert_array_equal(fj[name], ft[name])
    from_j = tck.load(str(tmp_path / "j"))
    from_t = jck.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(value(from_j), value(jc))
    np.testing.assert_array_equal(value(from_t), value(tc))
    assert layout(from_j) == layout(jc)
    assert layout(from_t) == layout(tc)


def test_legacy_unversioned_file_loads_in_both(tmp_path):
    _init_both(8)
    legacy = {"kind": "vector", "halo": [0, 0, False]}
    with open(tmp_path / "legacy.npz", "wb") as fh:
        np.savez(fh, meta=json.dumps(legacy),
                 data=np.arange(12, dtype=np.float32))
    for load in (tck.load, jck.load):
        back = load(str(tmp_path / "legacy.npz"))
        np.testing.assert_array_equal(np.asarray(back.materialize()),
                                      np.arange(12, dtype=np.float32))


# -------------------------------------------------------- failure model

def _save_vec(path, values):
    tck.save(str(path), dt.distributed_vector.from_array(values))


def test_save_is_atomic(tmp_path, monkeypatch):
    """A write that fails before its rename leaves the previous checkpoint
    intact and loadable, and no temp file behind."""
    _init_both(4)
    p = tmp_path / "vec.npz"
    old = np.arange(10, dtype=np.float32)
    _save_vec(p, old)

    def fail(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(tck.os, "replace", fail)
    with pytest.raises(OSError):
        _save_vec(p, old * 7)
    monkeypatch.undo()
    np.testing.assert_array_equal(tck.load(str(p)).materialize(), old)
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []


def test_truncated_file_raises_classified(tmp_path):
    _init_both(4)
    p = tmp_path / "vec.npz"
    _save_vec(p, np.arange(32, dtype=np.float32))
    with open(p, "r+b") as fh:
        fh.truncate(os.path.getsize(p) // 2)
    with pytest.raises(CheckpointCorruptError):
        tck.load(str(p))
    assert issubclass(CheckpointCorruptError, dt.resilience.ProgramError)


def test_corrupt_bytes_and_missing_file(tmp_path):
    _init_both(4)
    p = tmp_path / "garbage.npz"
    p.write_bytes(b"not a zip archive at all")
    with pytest.raises(CheckpointCorruptError):
        tck.load(str(p))
    with pytest.raises(FileNotFoundError):
        tck.load(str(tmp_path / "never_written.npz"))


def test_corrupt_member_raises_classified(tmp_path):
    _init_both(4)
    meta = io.BytesIO()
    np.save(meta, np.array(json.dumps(
        {"kind": "vector", "halo": [0, 0, False], "format_version": 1})))
    p = tmp_path / "member.npz"
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("meta.npy", meta.getvalue())
        z.writestr("data.npy", b"\x93NUMPY garbage, not a real header")
    with pytest.raises(CheckpointCorruptError, match="member"):
        tck.load(str(p))
    with zipfile.ZipFile(tmp_path / "nodata.npz", "w") as z:
        z.writestr("meta.npy", meta.getvalue())
    with pytest.raises(CheckpointCorruptError, match="missing"):
        tck.load(str(tmp_path / "nodata.npz"))


def test_format_version_recorded_and_future_rejected(tmp_path):
    _init_both(4)
    p = tmp_path / "vec.npz"
    _save_vec(p, np.arange(8, dtype=np.float32))
    with np.load(str(p), allow_pickle=False) as f:
        meta = json.loads(str(f["meta"]))
    assert meta["format_version"] == tck.FORMAT_VERSION == jck.FORMAT_VERSION
    meta["format_version"] = tck.FORMAT_VERSION + 1
    with open(tmp_path / "future.npz", "wb") as fh:
        np.savez(fh, meta=json.dumps(meta),
                 data=np.arange(8, dtype=np.float32))
    with pytest.raises(CheckpointCorruptError, match="newer"):
        tck.load(str(tmp_path / "future.npz"))
    with open(tmp_path / "alien.npz", "wb") as fh:
        np.savez(fh, meta=json.dumps({"kind": "alien"}))
    with pytest.raises(ValueError):
        tck.load(str(tmp_path / "alien.npz"))
    with pytest.raises(TypeError):
        tck.save(str(tmp_path / "x"), object())


def test_read_and_rebuild_split(tmp_path):
    _init_both(4)
    src = np.arange(9, dtype=np.int32)
    _save_vec(tmp_path / "v.npz", src)
    meta, arrays = tck.read(str(tmp_path / "v"))
    assert meta["kind"] == "vector"
    np.testing.assert_array_equal(arrays["data"], src)
    back = tck.rebuild(meta, arrays, runtime=dt.parallel.runtime.Runtime(
        [torch.device("cpu")] * 2))
    assert back.nshards == 2
    np.testing.assert_array_equal(dt.to_numpy(back), src)


# ------------------------------------------ fault injection (utils/faults)

def test_save_is_atomic_under_midwrite_kill(tmp_path):
    """test_checkpoint.py:96: an injected fault between the write and the
    rename leaves the previous checkpoint intact in both packages, and no
    temp file behind."""
    from dr_tpu.utils import faults as jfaults
    from dr_tpu.utils import resilience as jres
    from dr_tpu_torch.utils import faults, resilience
    _init_both(4)
    old = np.arange(10, dtype=np.float32)
    for pkg, ck, f, r in ((dt, tck, faults, resilience),
                          (dr_tpu, jck, jfaults, jres)):
        p = str(tmp_path / f"{pkg.__name__}.npz")
        ck.save(p, pkg.distributed_vector.from_array(old))
        with f.injected("checkpoint.write", "transient") as sp:
            with pytest.raises(r.TransientBackendError):
                ck.save(p, pkg.distributed_vector.from_array(old * 7))
        assert sp.fired == 1
    for name in ("dr_tpu_torch", "dr_tpu"):
        for ck in (tck, jck):  # each package's file loads in both
            np.testing.assert_array_equal(
                np.asarray(ck.load(str(tmp_path / f"{name}.npz"))
                           .materialize()), old)
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []


def test_truncated_checkpoint_raises_classified(tmp_path):
    """test_checkpoint.py:112: the ``truncate`` kind installs a torn file;
    both packages refuse it with ``CheckpointCorruptError``."""
    from dr_tpu.utils.resilience import CheckpointCorruptError as JCorrupt
    from dr_tpu_torch.utils import faults
    _init_both(4)
    p = tmp_path / "vec.npz"
    with faults.injected("checkpoint.write", "truncate") as sp:
        _save_vec(p, np.arange(32, dtype=np.float32))
        assert sp.fired == 1
    with pytest.raises(CheckpointCorruptError) as ei:
        tck.load(str(p))
    assert ei.value.site == "checkpoint.read"
    with pytest.raises(JCorrupt):
        jck.load(str(p))


def test_checkpoint_read_site_classified(tmp_path):
    """test_checkpoint.py:178: an injected ``checkpoint.read`` fault is
    classified, and the next load is clean."""
    from dr_tpu_torch.utils import faults
    from dr_tpu_torch.utils.resilience import (ProgramError,
                                               TransientBackendError)
    _init_both(4)
    p = tmp_path / "vec.npz"
    _save_vec(p, np.arange(8, dtype=np.float32))
    with faults.injected("checkpoint.read", "transient"):
        with pytest.raises(TransientBackendError):
            tck.load(str(p))
    with faults.injected("checkpoint.read", "program"):
        with pytest.raises(ProgramError):
            tck.read(str(p))
    np.testing.assert_array_equal(tck.load(str(p)).materialize(),
                                  np.asarray(jck.load(str(p)).materialize()))
