"""The port's multi-process kernel paths beyond the main path: the sort
family (K6 / K7), ``dense_matrix`` / ``mdarray`` / ``transpose`` /
``stencil2d`` (K5), the sparse ``gemv`` / ``spmm`` on the csr route and
ring attention (K9), on P = 2, 3 and 4 CPU processes over gloo, one rank
each (``dt.init_distributed``), against two oracles.

The file is its own worker::

    python tests/test_torch_multiprocess_paths.py <pid> <nproc> <port> <out> [device]

runs :func:`paths` in a process of a ``nproc``-process runtime and
writes every result to ``<out>.<pid>.npz`` (every result is valid on
every process, and every process writes all of them).  The worker
imports neither ``jax`` nor ``dr_tpu``; only the parent's oracle does.

The parent holds each process's results to the port's single controller
on ``dt.init(["cpu"] * P)`` bit for bit (both with the csr pin
``DR_GPU_SPMV_FORMAT=csr``: a multi-process runtime builds no other
sparse layout), and the single controller to the JAX package on P
shards with the same numpy inputs: data movement, sorts, ``is_sorted``,
``transpose`` and materialised matrices bit for bit; csr ``gemv`` /
``spmm`` and the tiled and one-tile ``stencil2d`` within
:data:`FLOAT_TOL` of the result's scale; the blockwise f32 ring within
:data:`RING_TOL` (the limits of ``tests/multihost_worker.py``); the bf16
flash ring (``flash_update``'s plain version here) within
:data:`FLASH_TOL`.  The checks cover every check of
``tests/multihost_worker.py`` beyond the main path.  Each spawn has its
own deadline and process-group timeout, and kills stragglers.
"""

import importlib
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from torch_mp_spawn import same_bits, spawn

HERE = Path(__file__).resolve()
#: seconds a spawn may take before its processes are killed
DEADLINE_S = 150.0
#: the process group's own timeout inside a worker
GROUP_TIMEOUT_S = float(os.environ.get("MPP_GROUP_TIMEOUT", 90.0))
SEED = 20261022
#: float results, relative to the largest magnitude of the result
FLOAT_TOL = 1e-5
FLOAT = ("gemv", "gemv_n", "spmm", "spmm_n", "flat_gemv", "gemv2d",
         "spmm2d", "st2_tiled", "st2_cyclic", "st2_transform",
         "st2_blocked", "st2_n", "scan_mis")
#: the blockwise f32 ring, as ``tests/multihost_worker.py`` holds it
RING_TOL = dict(rtol=1e-5, atol=1e-6)
RING = ("ring", "ring_n", "ring_nc", "ring_gqa", "ring_self")
#: the bf16 flash ring against the JAX package's bf16 ring (absolute)
FLASH_TOL = 2e-2
FLASH = ("flash", "flash_n")
#: the flash ring's shape: s = 128 a rank, 2 heads of d = 128
FLASH_S, FLASH_H, FLASH_D = 128, 2, 128


def _inputs(P):
    """The numpy inputs of the paths, from the seed."""
    rng = np.random.default_rng(SEED + P)
    f32 = np.float32
    n = 4 * P + 3
    mr = 32 * P
    S = 4 * P
    fS = FLASH_S * P
    return {
        "dm": rng.standard_normal((3 * P + 1, 5)).astype(f32),
        "md3": rng.standard_normal((2 * P + 1, 3, 5)).astype(f32),
        "u": rng.standard_normal((16, 12)).astype(f32),
        "one": rng.standard_normal((16, 128)).astype(f32),
        "sp_cols": rng.integers(0, mr, mr * 4),
        "sp_vals": rng.standard_normal(mr * 4).astype(f32),
        "sp_b": rng.standard_normal(mr).astype(f32),
        "sp_B": rng.standard_normal((mr, 3)).astype(f32),
        "d2": np.where(rng.random((2 * P, 2 * P)) < 0.3,
                       rng.standard_normal((2 * P, 2 * P)), 0.0)
        .astype(f32),
        "q": rng.standard_normal((1, S, 2, 8)).astype(f32),
        "k": rng.standard_normal((1, S, 2, 8)).astype(f32),
        "v": rng.standard_normal((1, S, 2, 8)).astype(f32),
        "kg": rng.standard_normal((1, S, 1, 8)).astype(f32),
        "vg": rng.standard_normal((1, S, 1, 8)).astype(f32),
        "x": rng.standard_normal((1, S, 16)).astype(f32),
        "wq": rng.standard_normal((16, 2, 8)).astype(f32) * 0.25,
        "wk": rng.standard_normal((16, 2, 8)).astype(f32) * 0.25,
        "wv": rng.standard_normal((16, 2, 8)).astype(f32) * 0.25,
        "fq": rng.standard_normal((1, fS, FLASH_H, FLASH_D)).astype(f32),
        "fk": rng.standard_normal((1, fS, FLASH_H, FLASH_D)).astype(f32),
        "fv": rng.standard_normal((1, fS, FLASH_H, FLASH_D)).astype(f32),
        "s": rng.standard_normal(n).astype(f32),
        "si": rng.integers(-5, 5, n).astype(np.int32),
        "r5": rng.standard_normal(n).astype(f32),
        "us": rng.standard_normal(sum(_usizes(P))).astype(f32),
        "ts": rng.standard_normal(sum(_tsizes(P))).astype(f32),
    }


def _usizes(P):
    """An uneven layout, one block a process."""
    return [3 + 2 * r for r in range(P)]


def _tsizes(P):
    """A "team" layout: every other rank empty."""
    return [0 if r % 2 else 3 + 2 * r for r in range(P)]


def paths(pkg, host, minimum, maximum, bf16, port):
    """This slice's paths at a small size on ``pkg`` (the port or the JAX
    package, on its current runtime); returns every result as a numpy
    array.  ``host(x)`` is a package array as numpy (bf16 widened to
    f32), ``minimum`` / ``maximum`` the package's elementwise ops,
    ``bf16(x)`` a numpy f32 array as the package's bf16 array; ``port``
    adds the port's own checks: ``from_reference_state`` and the
    truncated sort programs (``sort_phases_n``), whose cut cells hold the
    port's decoded keys where the JAX package leaves its order keys, so
    they are held to the single controller alone; the full programs
    (``rebalance`` / ``payload``) are the sorts above."""
    mod = lambda name: importlib.import_module(  # noqa: E731
        pkg.__name__ + "." + name)
    srt, gm = mod("algorithms.sort"), mod("algorithms.gemv")
    st2, ra = mod("algorithms.stencil2d"), mod("ops.ring_attention")
    P = pkg.nprocs()
    inp = _inputs(P)
    f32 = np.float32
    out = {}

    # ---- 2-D containers: materialise, element access, transpose
    mat = pkg.dense_matrix((2 * P, 3), dtype=f32,
                           partition=pkg.row_tiles())
    out["dm_zeros"] = mat.materialize()
    D = pkg.dense_matrix.from_array(inp["dm"])
    D[1, 2] = 7.5
    D.put([0, 3 * P], [4, 0], [1.0, -2.0])
    out["dm_set"] = D.materialize()
    out["dm_get"] = host(D.get([0, 1, 3 * P, 2], [4, 2, 0, 3]))
    out["dm_item"] = np.asarray([D[1, 2], D[3 * P, 4]], f32)
    C = pkg.dense_matrix.from_array(inp["dm"],
                                    partition=pkg.block_cyclic(tile=(2, 2)))
    out["dm_cyclic"] = C.materialize()
    if port:
        stored = D._stored().cpu().numpy()
        R = pkg.dense_matrix.from_reference_state(D.layout, stored)
        out["dm_refstate"] = R.materialize()
    src3 = np.arange(4 * P * 8, dtype=f32).reshape(4 * P, 8) * 0.5
    M = pkg.distributed_mdarray.from_array(src3)
    T = pkg.distributed_mdarray((8, 4 * P))
    pkg.transpose(T, M)
    out["md_T"] = T.materialize()
    M3 = pkg.distributed_mdarray.from_array(inp["md3"])
    T3 = pkg.distributed_mdarray((5, 2 * P + 1, 3))
    pkg.transpose(T3, M3, (2, 0, 1))
    out["md_T3"] = T3.materialize()
    M3[1, 2, 3] = 9.0
    out["md_item"] = np.asarray([M3[1, 2, 3], M3[2 * P, 0, 4]], f32)

    # ---- 2-D stencil: tiled (block and cyclic) and one-tile K5
    w = pkg.heat_step_weights(0.2)
    A, B = (pkg.dense_matrix.from_array(inp["u"]) for _ in range(2))
    pkg.stencil2d_iterate(A, B, w, steps=3)
    out["st2_tiled"] = A.materialize()
    cyc = pkg.block_cyclic(tile=(4, 4))
    A, B = (pkg.dense_matrix.from_array(inp["u"], partition=cyc)
            for _ in range(2))
    pkg.stencil2d_iterate(A, B, w, steps=3)
    out["st2_cyclic"] = A.materialize()
    A, B = (pkg.dense_matrix.from_array(inp["u"]) for _ in range(2))
    pkg.stencil2d_transform(A, B, w)
    out["st2_transform"] = B.materialize()
    one = pkg.block_cyclic(grid=(1, 1))
    O = pkg.dense_matrix.from_array(inp["one"], partition=one)
    st2.stencil2d_iterate_blocked(O, w, 5, time_block=2)
    out["st2_blocked"] = O.materialize()
    O = pkg.dense_matrix.from_array(inp["one"], partition=one)
    st2.stencil2d_n(O, w, 2, time_block=2)
    out["st2_n"] = O.materialize()

    # ---- sparse: the worker's one-a-row matrix, a random one, a 2-D grid
    m = 2 * P
    A1 = pkg.sparse_matrix.from_coo((m, m), np.arange(m), np.zeros(m, int),
                                    np.ones(m, f32))
    c = pkg.distributed_vector(m, dtype=f32)
    bv = pkg.distributed_vector(m, dtype=f32)
    pkg.fill(bv, 3.0)
    pkg.fill(c, 0.0)
    pkg.gemv(c, A1, bv)
    out["gemv_ones"] = pkg.to_numpy(c)
    out["spmm_ones"] = host(pkg.spmm(
        A1, np.tile(np.array([1.0, 2.0], f32), (m, 1))))
    mr = 32 * P
    A = pkg.sparse_matrix.from_coo(
        (mr, mr), np.repeat(np.arange(mr), 4), inp["sp_cols"],
        inp["sp_vals"])
    out["to_dense"] = A.to_dense()
    out["format"] = np.asarray([A.format, A1.format])
    c = pkg.distributed_vector(mr, dtype=f32)
    pkg.gemv(c, A, inp["sp_b"])
    out["gemv"] = pkg.to_numpy(c)
    c = pkg.distributed_vector(mr, dtype=f32)
    gm.gemv_n(c, A, inp["sp_b"], 3)
    out["gemv_n"] = pkg.to_numpy(c)
    out["flat_gemv"] = host(gm.flat_gemv(A, inp["sp_b"]))
    out["spmm"] = host(pkg.spmm(A, inp["sp_B"]))
    out["spmm_n"] = host(gm.spmm_n(A, inp["sp_B"], 2))
    if port:
        got = [A._tile_triple(t) for t in range(P)]
        R = pkg.sparse_matrix.from_reference_state(
            A.shape, A.grid_shape, A._tile_nnz,
            *(np.stack([g[i].cpu().numpy() for g in got])
              for i in range(3)))
        out["sp_refstate"] = R.to_dense()
    gp, gq = pkg.factor(P)
    sp2 = pkg.sparse_matrix.from_dense(
        inp["d2"], partition=pkg.block_cyclic(grid=(gp, gq)))
    c = pkg.distributed_vector(m, dtype=f32)
    pkg.fill(c, 0.0)
    pkg.gemv(c, sp2, np.ones(m, dtype=f32))
    out["gemv2d"] = pkg.to_numpy(c)
    out["spmm2d"] = host(pkg.spmm(sp2, inp["sp_B"][:m]))

    # ---- ring attention: the blockwise f32 ring and the bf16 flash ring
    q, k, v = inp["q"], inp["k"], inp["v"]
    out["ring"] = host(pkg.ring_attention(q, k, v, causal=True))
    out["ring_n"] = host(pkg.ring_attention_n(q, k, v, 1, causal=True))
    out["ring_nc"] = host(pkg.ring_attention(q, k, v))
    out["ring_gqa"] = host(pkg.ring_attention(q, inp["kg"], inp["vg"],
                                              causal=True))
    out["ring_self"] = host(ra.ring_self_attention(
        inp["x"], inp["wq"], inp["wk"], inp["wv"], causal=True))
    fq, fk, fv = (bf16(inp[x]) for x in ("fq", "fk", "fv"))
    out["flash"] = host(pkg.ring_attention(fq, fk, fv, causal=True))
    out["flash_n"] = host(pkg.ring_attention_n(fq, fk, fv, 2, causal=True))

    # ---- the sort family and its reduce
    n = len(inp["s"])
    src = inp["s"]

    def vec(x, **kw):
        return pkg.distributed_vector.from_array(x, **kw)

    v = vec(src)
    pkg.sort(v)
    out["sort"] = pkg.to_numpy(v)
    sorted_v = v
    v = vec(src)
    pkg.sort(v, descending=True)
    out["sort_desc"] = pkg.to_numpy(v)
    kv, pv = vec(src), vec(np.arange(n, dtype=f32))
    pkg.sort_by_key(kv, pv)
    out["sbk_keys"], out["sbk_vals"] = pkg.to_numpy(kv), pkg.to_numpy(pv)
    kv, pv = vec(src), vec(np.arange(n, dtype=np.int32))
    pkg.sort_by_key(kv, pv, descending=True)
    out["sbk_desc"] = np.concatenate([pkg.to_numpy(kv),
                                      pkg.to_numpy(pv).astype(f32)])
    iv = vec(inp["si"])
    pkg.sort(iv)
    out["sort_int"] = pkg.to_numpy(iv)
    iv, pv = vec(inp["si"]), vec(src)
    pkg.sort_by_key(iv, pv)
    out["sbk_int"] = pkg.to_numpy(pv)
    out["argsort"] = pkg.to_numpy(pkg.argsort(vec(src)))
    ud = vec(inp["us"], distribution=_usizes(P))
    pkg.sort(ud)
    out["sort_uneven"] = pkg.to_numpy(ud)
    td = vec(inp["ts"], distribution=_tsizes(P))
    tn = len(inp["ts"])
    pkg.sort(td[1:tn - 1])
    out["sort_team_win"] = pkg.to_numpy(td)
    pkg.sort(td)
    out["sort_team"] = pkg.to_numpy(td)
    r5 = inp["r5"]
    wv5 = vec(r5)
    pkg.sort(wv5[1:n - 2])
    out["sort_win"] = pkg.to_numpy(wv5)
    w5 = vec(r5)
    pkg.sort(w5[2:n - 1], descending=True)
    out["sort_win_desc"] = pkg.to_numpy(w5)
    ms5 = pkg.distributed_vector(n, dtype=f32)
    pkg.fill(ms5, 0.0)
    pkg.inclusive_scan(wv5[0:n - 3], ms5[3:n])
    out["scan_mis"] = pkg.to_numpy(ms5)
    ov5 = vec(r5)
    kb = max(2, n // 2)
    va = max(1, n // 4)
    pkg.sort_by_key(ov5[0:kb], ov5[va:va + kb])
    out["sbk_overlap"] = pkg.to_numpy(ov5)
    out["is_sorted"] = np.asarray([
        pkg.is_sorted(sorted_v), pkg.is_sorted(vec(src)),
        pkg.is_sorted(ud), pkg.is_sorted(td), pkg.is_sorted(wv5),
        pkg.is_sorted(wv5[1:n - 2]),
        pkg.is_sorted(pkg.views.transform(sorted_v, lambda x: x * 2.0)),
        pkg.is_sorted(pkg.views.transform(sorted_v, lambda x: -x))])
    v = vec(src)
    srt.sort_n(v, 2)
    out["sort_n"] = pkg.to_numpy(v)
    kv, pv = vec(src), vec(np.arange(n, dtype=f32))
    srt.sort_by_key_n(kv, pv, 2)
    out["sbk_n"] = np.concatenate([pkg.to_numpy(kv), pkg.to_numpy(pv)])
    if port:  # a cut program's cells: the port's own (module docstring)
        for ph in srt.SORT_PHASES:
            v = vec(src)
            srt.sort_phases_n(v, ph, 1)
            out[f"ph_{ph}"] = pkg.to_numpy(v)
        for ph in srt.SORTKV_PHASES:
            kv, pv = vec(src), vec(np.arange(n, dtype=f32))
            srt.sort_by_key_phases_n(kv, pv, ph, 1)
            out[f"phkv_{ph}"] = np.concatenate([pkg.to_numpy(kv),
                                                pkg.to_numpy(pv)])
    x = vec(src)
    out["red_minmax"] = np.asarray([pkg.reduce(x, None, minimum),
                                    pkg.reduce(x, None, maximum)], f32)
    return out


# ----------------------------------------------------------------- worker

def _torch_host(x):
    import torch
    t = x.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _torch_bf16(x):
    import torch
    return torch.from_numpy(x).to(torch.bfloat16)


def _port_paths(dt):
    import torch
    return paths(dt, _torch_host, torch.minimum, torch.maximum, _torch_bf16,
                 True)


def _worker(pid, nproc, port, out, device="cpu"):
    import dr_tpu_torch as dt
    from dr_tpu_torch.algorithms import gemv as tg
    from dr_tpu_torch.utils import spmd_guard
    os.environ["DR_GPU_SPMV_FORMAT"] = "csr"
    rt = dt.init_distributed(f"localhost:{port}", nproc, pid,
                             backend="gloo", device=device,
                             timeout_s=GROUP_TIMEOUT_S)
    assert rt.local_ranks == [pid] and dt.nprocs() == nproc
    with spmd_guard.guard() as g:
        res = _port_paths(dt)
        g.verify()
    assert len(g.trace) > 40, len(g.trace)
    # the worker's ELL check: no grouped layout across processes
    m = 2 * nproc
    A = dt.sparse_matrix.from_coo((m, m), np.arange(m), np.zeros(m, int),
                                  np.ones(m, np.float32))
    # the ring layout's profiler refuses, classified
    from dr_tpu_torch.utils.resilience import ProgramError
    try:
        tg.gemv_phases_n(dt.distributed_vector(m), A, np.ones(m, np.float32),
                         tg.SPMV_PHASES[-1], 1)
        site = None
    except ProgramError as e:
        site = e.site
    res["grouped"] = np.asarray([A.ensure_ell(), A.ensure_bcsr(),
                                 A.ensure_ring(),
                                 tg.resolved_format(A) == "csr",
                                 tg.resolved_spmm_format(A) == "csr",
                                 site == "gemv.ring_layout"])
    np.savez(f"{out}.{pid}.npz", **res)
    dt.barrier()
    dt.final()
    print(f"MP-OK pid={pid}", flush=True)


# ----------------------------------------------------------------- parent

def _single_controller(P):
    import dr_tpu_torch as dt
    dt.init(["cpu"] * P)
    try:
        return _port_paths(dt)
    finally:
        dt.final()


def _jax_reference(P):
    import jax
    import jax.numpy as jnp
    import dr_tpu
    dr_tpu.init(jax.devices()[:P])

    def host(x):
        a = np.asarray(x)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a

    return paths(dr_tpu, host, jnp.minimum, jnp.maximum,
                 lambda x: jnp.asarray(x).astype(jnp.bfloat16), False)


@pytest.fixture
def _reset_port():
    yield
    import dr_tpu_torch as dt
    dt.final()


@pytest.mark.parametrize("nproc", [2, 3, 4])
def test_multi_process_paths(nproc, tmp_path, monkeypatch, _reset_port):
    """P processes over gloo: every process's results have the single
    controller's bits and no grouped sparse layout; the JAX package on
    P shards agrees bit for bit on data movement, sorts, ``is_sorted``,
    ``transpose`` and materialised matrices, and within the stated
    tolerances on float results."""
    # the processes run while this one computes both oracles
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn, HERE, nproc, str(tmp_path / "res"),
                              deadline_s=DEADLINE_S)
        ref = _jax_reference(nproc)
        monkeypatch.setenv("DR_GPU_SPMV_FORMAT", "csr")
        single = _single_controller(nproc)
        got = spawned.result()
    for pid, res in enumerate(got):
        assert sorted(res) == sorted(list(single) + ["grouped"])
        for key, want in single.items():
            assert same_bits(res[key], want), (pid, key, res[key], want)
        assert res["grouped"].tolist() == [False, False, False, True,
                                           True, True], (pid, res["grouped"])
    assert single["is_sorted"].tolist() == [True, False, True, True, False,
                                            True, True, False]
    for key in ("dm_refstate", "sp_refstate"):
        base = single["dm_set"] if key == "dm_refstate" else \
            single["to_dense"]
        assert same_bits(single[key], base), key
    # the last phase is the full program
    assert same_bits(single["ph_rebalance"], single["sort"])
    assert same_bits(single["phkv_payload"], np.concatenate(
        [single["sbk_keys"], single["sbk_vals"]]))
    assert sorted(ref) == sorted(k for k in single if "refstate" not in k
                                 and not k.startswith("ph"))
    for key, want in ref.items():
        mine = single[key]
        if key in FLOAT + FLASH:
            scale = float(np.abs(want).max()) + 1.0 if key in FLOAT else 1.0
            err = float(np.abs(mine.astype(np.float64) - want).max())
            assert err <= (FLOAT_TOL if key in FLOAT else FLASH_TOL) * \
                scale, (key, err, scale)
        elif key in RING:
            np.testing.assert_allclose(mine, want, **RING_TOL)
        else:
            assert same_bits(mine.astype(want.dtype), want), \
                (key, mine, want)


def test_phase29_rehearsal(tmp_path, _reset_port):
    """``chip_smoke.py``'s phase 29 at its CPU sizes: one controller on
    two CPU ranks, then two processes over gloo, every child's digests
    equal bit for bit and its launch counts its rank's share (0 with 0
    on the CPU, where the wrappers take the plain versions)."""
    import importlib.util
    import dr_tpu_torch as dt
    from dr_tpu_torch.ops import kernels
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", HERE.parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    got = cs.mp29_phase(dt, kernels, 5, "cpu", device="cpu", small=True,
                        out_dir=str(tmp_path))
    assert got["processes"] == 2 and set(got["p0_steps"]) == \
        set(got["single_steps"])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            *sys.argv[5:6])
