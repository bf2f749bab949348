"""The port's multi-process main path: P = 2, 3 and 4 CPU processes over
gloo, one rank each (``dt.init_distributed``), against two oracles.

The file is its own worker::

    python tests/test_torch_multiprocess.py <pid> <nproc> <port> <out> [device]

runs :func:`main_path` in a process of a ``nproc``-process runtime (its
rank on ``device``, default the CPU) and
writes every result to ``<out>.<pid>.npz`` (every process writes, so the
test sees that each process read the same values).  The worker imports
neither ``jax`` nor ``dr_tpu``; only the parent's tests do.

The parent holds each process's results to the port's single-controller
run of the same path on ``dt.init(["cpu"] * P)`` bit for bit, and to the
JAX package on P shards with the same numpy inputs: data movement and
integer results bit for bit, float sums within the tolerance stated
beside each.  In the multi-process runtime the paths that run in one
process by design (serving) raise a classified ``ProgramError`` at
their entry.  Each spawn has its
own deadline and process-group timeout, and kills stragglers, as
``tests/test_multihost.py`` does.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_mp_spawn import same_bits, spawn

HERE = Path(__file__).resolve()
#: seconds a spawn may take before its processes are killed
DEADLINE_S = 120.0
#: the process group's own timeout inside a worker
GROUP_TIMEOUT_S = 60.0
SEED = 20261018
W3 = [0.25, 0.5, 0.25]
#: results compared with the JAX package bit for bit (data movement and
#: integer results); the rest are float sums, held to FLOAT_TOL
EXACT = ("iota", "iota_win", "fill", "fill_u8", "copy_u8", "copy_i8",
         "copy_shift", "transform", "zip_sum", "red_int", "red_max_init",
         "red_win_max", "get", "iter", "ckpt", "allgather", "to_host",
         "scan_int", "halo_rows", "exscan_int")
#: float sums and scans: relative to the largest magnitude of the result
FLOAT_TOL = 1e-5


def _sizes(P):
    return 7 * P + 3, [3 + 2 * r for r in range(P)]


def _inputs(P):
    """The numpy inputs of the path, from the seed."""
    n, usizes = _sizes(P)
    rng = np.random.default_rng(SEED + P)
    return {
        "x": rng.standard_normal(n).astype(np.float32),
        "y": rng.standard_normal(n).astype(np.float32),
        "k": rng.integers(-50, 50, n).astype(np.int32),
        "sat": np.tile(np.array([-1.5, -0.2, 255.5, 256.0, 1e10, np.nan],
                                np.float32), n // 6 + 1)[:n],
        "u": rng.standard_normal(sum(usizes)).astype(np.float32),
        "mm": rng.standard_normal(P * 256).astype(np.float32),
        "blk": rng.standard_normal(P * 1024).astype(np.float32),
    }


def main_path(pkg, maximum, ckpt_dir, rows_of, shards_of):
    """The multi-process slice's path at a small size on ``pkg`` (the
    port or the JAX package, on its current runtime); returns every
    result as a numpy array.  ``maximum`` is the package's elementwise
    max op, ``rows_of(v)`` a vector's padded rows, rank by rank, as
    numpy, and ``shards_of(v)`` its sharded form (what the
    communicator's gathers take)."""
    import importlib
    host = importlib.import_module(pkg.__name__ + ".utils.host")
    red = importlib.import_module(pkg.__name__ + ".algorithms.reduce")
    scan = importlib.import_module(pkg.__name__ + ".algorithms.scan")
    sten = importlib.import_module(pkg.__name__ + ".algorithms.stencil")
    P = pkg.nprocs()
    n, usizes = _sizes(P)
    inp = _inputs(P)
    f32 = np.float32
    out = {}
    a = pkg.distributed_vector(n, dtype=f32)
    pkg.iota(a, 1)
    out["iota"] = pkg.to_numpy(a)
    b = pkg.distributed_vector(n, dtype=np.int32)
    pkg.iota(b[2:n - 1], 5)
    out["iota_win"] = pkg.to_numpy(b)
    pkg.fill(a[3:n - 2], 2.5)
    out["fill"] = pkg.to_numpy(a)
    u8 = pkg.distributed_vector(n, dtype=np.uint8)
    pkg.fill(u8, 7)
    pkg.fill(u8[1:4], -0.5)
    out["fill_u8"] = pkg.to_numpy(u8)
    sat = pkg.distributed_vector.from_array(inp["sat"])
    pkg.copy(sat, u8)
    out["copy_u8"] = pkg.to_numpy(u8)
    i8 = pkg.distributed_vector(n, dtype=np.int8)
    pkg.copy(sat, i8)
    out["copy_i8"] = pkg.to_numpy(i8)
    x = pkg.distributed_vector.from_array(inp["x"])
    y = pkg.distributed_vector.from_array(inp["y"])
    t = pkg.distributed_vector(n, dtype=f32)
    pkg.copy(x[1:n], t[0:n - 1])   # unaligned windows: the gather route
    out["copy_shift"] = pkg.to_numpy(t)
    pkg.transform(x, t, lambda v: v * 2.0 + 1.0)
    out["transform"] = pkg.to_numpy(t)
    pkg.transform(pkg.views.zip(x, y), t, lambda p, q: p + q)
    out["zip_sum"] = pkg.to_numpy(t)
    k = pkg.distributed_vector.from_array(inp["k"])
    out["red_int"] = np.asarray(pkg.reduce(k))
    out["red_max_init"] = np.asarray([pkg.reduce(k, 60, maximum),
                                      pkg.reduce(k, -60, maximum)])
    out["red_win_max"] = np.asarray(pkg.reduce(k[2:n - 3], None, maximum))
    out["red_add"] = np.asarray(pkg.reduce(x), dtype=np.float64)
    out["dot"] = np.asarray(pkg.dot(x, y), dtype=np.float64)
    out["dot_n"] = np.asarray(float(red.dot_n(x, y, 3)))
    s = pkg.distributed_vector(n, dtype=f32)
    pkg.inclusive_scan(x, s)
    out["scan"] = pkg.to_numpy(s)
    pkg.exclusive_scan(x, s, 0.5)
    out["exscan"] = pkg.to_numpy(s)
    si = pkg.distributed_vector(n, dtype=np.int32)
    pkg.inclusive_scan(k, si)
    out["scan_int"] = pkg.to_numpy(si)
    pkg.exclusive_scan(k[1:n - 1], si[1:n - 1], 3)
    out["exscan_int"] = pkg.to_numpy(si)
    pkg.fill(s, 0.0)
    pkg.inclusive_scan(x[2:n - 1], s[2:n - 1])
    out["scan_win"] = pkg.to_numpy(s)
    pkg.fill(s, 0.0)
    pkg.inclusive_scan(x[0:n - 3], s[3:n])     # the realign route
    out["scan_realign"] = pkg.to_numpy(s)
    ud = pkg.distributed_vector(len(inp["u"]), dtype=f32,
                                distribution=usizes)
    ud.assign_array(inp["u"])
    us = pkg.distributed_vector(len(inp["u"]), dtype=f32,
                                distribution=usizes)
    pkg.inclusive_scan(ud, us)
    out["scan_uneven"] = pkg.to_numpy(us)
    sn = pkg.distributed_vector(n, dtype=f32)
    scan.inclusive_scan_n(x, sn, 2)
    out["scan_n"] = pkg.to_numpy(sn)
    hb = pkg.halo_bounds(1, 1, periodic=True)
    sv = pkg.distributed_vector.from_array(inp["x"], halo=hb)
    w = pkg.distributed_vector.from_array(inp["x"], halo=hb)
    res = pkg.stencil_iterate(sv, w, W3, steps=3)
    out["stencil"] = pkg.to_numpy(res)
    hv = pkg.distributed_vector.from_array(inp["k"].astype(f32), halo=hb)
    hv.halo().exchange()
    rows = [rows_of(hv)]
    hv.halo().reduce_plus()
    rows.append(rows_of(hv))
    out["halo_rows"] = np.stack(rows)
    mb = pkg.halo_bounds(128, 128, periodic=True)
    mv = pkg.distributed_vector.from_array(inp["mm"], halo=mb)
    sten.stencil_iterate_matmul(mv, W3, 10, k_block=4)
    out["matmul"] = pkg.to_numpy(mv)
    bb = pkg.halo_bounds(1024, 1024, periodic=True)
    bv = pkg.distributed_vector.from_array(inp["blk"], halo=bb)
    sten.stencil_iterate_blocked(bv, W3, 20, time_block=8)
    out["blocked"] = pkg.to_numpy(bv)
    out["get"] = np.asarray(host.to_host(a.get([0, n - 1, 3, n // 2])))
    a.put([0, n - 1], [-7.0, 9.0])
    out["iter"] = np.asarray(list(a), dtype=f32)
    path = os.path.join(ckpt_dir, f"mp_ckpt_{P}")
    pkg.checkpoint.save(path, ud)
    out["ckpt"] = pkg.to_numpy(pkg.checkpoint.load(path))
    pkg.barrier()  # every load is done before anyone moves on
    comm = pkg.default_comm()
    out["allgather"] = comm.allgather(shards_of(k))
    out["to_host"] = np.asarray(host.to_host(k.to_array()))
    return out


# ----------------------------------------------------------------- worker

def _torch_rows(v):
    from dr_tpu_torch.utils.host import to_host
    return to_host(v.rows).reshape(v.nshards, -1)


def _torch_shards(v):
    return v.rows


def _out_of_slice(dt, tmp):
    """The paths that run in one process by design (a serving daemon and
    a router: one process serves) refuse, classified, at their entry;
    returns the names that did."""
    from dr_tpu_torch import serve
    from dr_tpu_torch.utils import resilience
    n, _ = _sizes(dt.nprocs())
    v = dt.distributed_vector(n)
    dt.iota(v, 0)
    pid = dt.runtime().process_index
    calls = {
        "Server.start": lambda: serve.Server(
            os.path.join(tmp, f"mp{pid}.sock"), cpu=True).start(),
        "Router.start": lambda: serve.Router(
            os.path.join(tmp, f"mp{pid}"), replicas=2, cpu=True).start(),
    }
    refused = []
    for name, call in calls.items():
        try:
            call()
        except resilience.ProgramError as e:
            assert "one long-lived process serves" in str(e), (name, e)
            assert e.site == "runtime.multi_process", (name, e)
            assert resilience.classify(e) is resilience.ProgramError
            refused.append(name)
    return refused


def _worker(pid, nproc, port, out, device="cpu"):
    import torch
    import dr_tpu_torch as dt
    from dr_tpu_torch.utils import spmd_guard
    rt = dt.init_distributed(f"localhost:{port}", nproc, pid,
                             backend="gloo", device=device,
                             timeout_s=GROUP_TIMEOUT_S)
    assert rt.local_ranks == [pid] and dt.nprocs() == nproc
    with spmd_guard.guard() as g:
        res = main_path(dt, torch.maximum, os.path.dirname(out),
                        _torch_rows, _torch_shards)
        g.verify()
    assert len(g.trace) > 20
    refused = _out_of_slice(dt, os.path.dirname(out))
    res["refused"] = np.asarray(sorted(refused))
    logdir = os.path.dirname(out)
    dt.drlog.set_file(os.path.join(logdir, "mp.log"))
    dt.drlog.debug("process {}", pid)
    dt.drlog.close()
    res["log"] = np.asarray(os.path.exists(
        os.path.join(logdir, f"mp.{pid}.log")))
    np.savez(f"{out}.{pid}.npz", **res)
    dt.barrier()
    dt.final()
    print(f"MP-OK pid={pid}", flush=True)


# ----------------------------------------------------------------- parent

def _spawn(nproc, out, device="cpu", deadline_s=DEADLINE_S):
    """Run ``nproc`` workers of this file with their ranks on ``device``
    (``torch_mp_spawn.spawn``)."""
    return spawn(HERE, nproc, out, device, deadline_s)


def _single_controller(P, ckpt_dir, device="cpu"):
    import torch
    import dr_tpu_torch as dt
    dt.init([device] * P)
    try:
        return main_path(dt, torch.maximum, ckpt_dir, _torch_rows,
                         _torch_shards)
    finally:
        dt.final()


def _jax_reference(P, ckpt_dir):
    import jax
    import jax.numpy as jnp
    import dr_tpu
    dr_tpu.init(jax.devices()[:P])
    return main_path(dr_tpu, jnp.maximum, ckpt_dir,
                     lambda v: np.asarray(v._data), lambda v: v._data)


@pytest.fixture
def _reset_port():
    yield
    import dr_tpu_torch as dt
    dt.final()


@pytest.mark.parametrize("nproc", [2, 3, 4])
def test_multi_process_main_path(nproc, tmp_path, _reset_port):
    """P processes over gloo: every process's results have the single
    controller's bits; the JAX package on P shards agrees bit for bit on
    data movement and integers, within FLOAT_TOL on float sums."""
    got = _spawn(nproc, str(tmp_path / "res"))
    single = _single_controller(nproc, str(tmp_path))
    ref = _jax_reference(nproc, str(tmp_path))
    for pid, res in enumerate(got):
        assert sorted(res) == sorted(list(single) + ["log", "refused"])
        for key, want in single.items():
            assert same_bits(res[key], want), (pid, key, res[key], want)
        assert bool(res["log"]), pid
        assert set(res["refused"]) == {"Server.start", "Router.start"}, \
            res["refused"]
    for key, want in ref.items():
        mine = single[key]
        if key in EXACT:
            assert same_bits(mine.astype(want.dtype), want), \
                (key, mine, want)
        else:
            scale = float(np.abs(want).max()) + 1.0
            err = float(np.abs(mine.astype(np.float64) - want).max())
            assert err <= FLOAT_TOL * scale, (key, err, scale)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            *sys.argv[5:6])
