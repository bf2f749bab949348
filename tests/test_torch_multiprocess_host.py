"""The port's host layers across processes: deferred plans, the tuning
layer and the elastic shrink with its killed-worker leg, in P = 2, 3 and
4 CPU processes over gloo (``dt.init_distributed``), against two
oracles.

The file is its own worker::

    python tests/test_torch_multiprocess_host.py <pid> <nproc> <port> \\
        <out> <device> <case> [victim]

runs one case in a process of an ``nproc``-process runtime (its rank on
``device``) and writes its results to ``<out>.<pid>.npz``; a process
that plays the killed worker ends with ``os._exit(17)`` and writes
nothing.  The worker imports neither ``jax`` nor ``dr_tpu``; only the
parent's ``_jax*`` oracles do.  The cases:

* ``region``: the deferred main-path region (fill, for_each, a halo
  exchange, transform, reduce, dot, histogram and top_k fused; the
  scan and the two iterated stencils opaque; ``dot_n`` after the
  flush), deferred and eager.  Every process's results equal the
  single controller's on P ranks bit for bit, its ``Plan.stats()`` and
  ``explain()`` equal its peers', and ``spmd_guard.verify()`` passes;
  the single controller equals ``dr_tpu.deferred()`` on P shards, bit
  for bit on data movement and integers and within :data:`FLOAT_TOL`
  of the scale on float sums and scans.
* ``tuning``: with a DB armed and the ``capinfer`` / ``joinroute``
  passes on, process 0's records are every process's answer, even
  where process 1's overlay says otherwise; ``join`` and ``join_auto``
  take the same route and the single controller's bits.
* ``kill``: a checkpoint, a barrier, and the victim process exits;
  each survivor bounds the failed collective with ``with_deadline``,
  attributes it, and shrinks onto its own rank, whose values and fate
  counts equal ``dr_tpu``'s ``rescue_session(lost_ranks=...)`` on P
  shards from the same checkpoint.  With survivors in two processes
  the attributed rescue is refused, classified, first.
* ``replay``: process 1 exits after the checkpoint; process 0's region
  has ``device.lost`` injected once with ``DR_GPU_ELASTIC=1``, and the
  flush replays on rank 0 as ``dr_tpu``'s does on 2 shards.
"""

import contextlib
import gc
import importlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from torch_mp_spawn import same_bits, spawn

HERE = Path(__file__).resolve()
#: seconds a spawn may take before its processes are killed
DEADLINE_S = 90.0
#: the process group's own timeout inside a worker
GROUP_TIMEOUT_S = 60.0
#: seconds a survivor gives the collective that meets the dead peer
FAIL_DEADLINE_S = 30.0
SEED = 20261024
W3 = [0.25, 0.5, 0.25]
#: cells a rank: the blocked stencil's halo width
SEG = 1024
#: the region's results held to dr_tpu bit for bit (data movement and
#: integers); the rest are float sums and scans, held to FLOAT_TOL
EXACT = ("a_rows", "b", "hist", "top_v", "top_i")
#: float sums and scans: relative to the largest magnitude of the result
FLOAT_TOL = 1e-5
KILLED = 17


def _scale(x, c):
    return x * c


def _shift(x, c):
    return x + c


def _half(x):
    return x * 0.5


def _inputs(P):
    """The numpy inputs of every case, from the seed."""
    rng = np.random.default_rng(SEED + P)
    n = P * SEG
    return {
        "x": rng.standard_normal(n).astype(np.float32),
        "mm": rng.standard_normal(P * 256).astype(np.float32),
        "blk": rng.standard_normal(n).astype(np.float32),
        "kv": rng.standard_normal(4 * P).astype(np.float32),
        "lk": rng.integers(0, 40, 24 * P).astype(np.int32),
        "lv": rng.standard_normal(24 * P).astype(np.float32),
        "rk": rng.integers(0, 40, 16 * P).astype(np.int32),
        "rv": rng.standard_normal(16 * P).astype(np.float32),
    }


# ------------------------------------------------------------ the cases

def region(pkg, deferred, rows_of):
    """The deferred main-path region on ``pkg``'s current runtime (one
    controller or one process of several), recorded in a
    ``deferred()`` region or run eagerly; returns every result as a
    numpy array, and the plan's stats and report when deferred."""
    red = importlib.import_module(pkg.__name__ + ".algorithms.reduce")
    sten = importlib.import_module(pkg.__name__ + ".algorithms.stencil")
    P = pkg.nprocs()
    n = P * SEG
    inp = _inputs(P)
    f32, i32 = np.float32, np.int32
    hb = pkg.halo_bounds(1, 1, periodic=True)
    a = pkg.distributed_vector(n, f32, halo=hb)
    b = pkg.distributed_vector(n, f32, halo=hb)
    x = pkg.distributed_vector.from_array(inp["x"])
    s = pkg.distributed_vector(n, f32)
    h = pkg.distributed_vector(16, i32)
    tv = pkg.distributed_vector(8, f32)
    ti = pkg.distributed_vector(8, i32)
    mv = pkg.distributed_vector.from_array(
        inp["mm"], halo=pkg.halo_bounds(128, 128, periodic=True))
    bv = pkg.distributed_vector.from_array(
        inp["blk"], halo=pkg.halo_bounds(SEG, SEG, periodic=True))
    out = {}
    with (pkg.deferred() if deferred else contextlib.nullcontext()) as p:
        pkg.iota(a, 1)
        pkg.fill(a[5:n - 7], 0.5)
        pkg.for_each(a, _scale, 1.5)
        a.halo().exchange()
        pkg.transform(a, b, _shift, 2.0)
        tot = pkg.reduce(b)
        d = pkg.dot(a, b)
        pkg.histogram(x, h, -3.0, 3.0)
        pkg.top_k(x, tv, ti)
        pkg.inclusive_scan(x, s)
        sten.stencil_iterate_blocked(bv, W3, 20, time_block=8)
        sten.stencil_iterate_matmul(mv, W3, 10, k_block=4)
    out["tot"] = np.asarray(float(tot))
    out["dot"] = np.asarray(float(d))
    out["dot_n"] = np.asarray(float(red.dot_n(x, s, 2)))
    out["a_rows"] = rows_of(a)
    for name, v in (("b", b), ("hist", h), ("top_v", tv), ("top_i", ti),
                    ("scan", s), ("blocked", bv), ("matmul", mv)):
        out[name] = pkg.to_numpy(v)
    if deferred and hasattr(p, "explain"):
        out["stats"] = np.asarray(json.dumps(p.stats(), sort_keys=True))
        out["explain"] = np.asarray(p.explain())
    return out


def tuned_joins(dt, db, disagree=False):
    """The tuning case on the port's current runtime with the DB at
    ``db`` armed: two records (``join.broadcast_max`` 0, which forces
    the partition merge, and a ``cap_ratio_join_inner`` hint), an
    overlay note that disagrees with them where ``disagree`` (process
    1), then ``join`` and ``join_auto``; returns the answers, the routes
    and the joined rows."""
    from dr_tpu_torch import tuning
    from dr_tpu_torch.algorithms import relational
    P = dt.nprocs()
    inp = _inputs(P)
    out = {}
    env = {"DR_GPU_TUNING_DB": db, "DR_GPU_PLAN_OPT": "all"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    tuning.clear_session()
    tuning.reload()
    try:
        out["key"] = np.asarray(tuning.context_key("join", "broadcast_max"))
        out["recorded"] = np.asarray([
            str(tuning.record("join", "broadcast_max", 0, source="test")),
            str(tuning.record("relational", "cap_ratio_join_inner", 2.0,
                              source="test"))])
        with open(db, encoding="utf-8") as fh:
            out["file_keys"] = np.asarray(sorted(json.load(fh)["entries"]))
        if disagree:
            tuning.note("join", "broadcast_max", 1 << 30)
            tuning.note("relational", "cap_ratio_join_inner", 0.001)
        out["lookup"] = np.asarray([
            tuning.lookup("join", "broadcast_max"),
            tuning.lookup("relational", "cap_ratio_join_inner"),
            tuning.lookup("spmv", "format", "csr")], dtype=object).astype(str)
        lk, lv, rk, rv = (dt.distributed_vector.from_array(inp[k])
                          for k in ("lk", "lv", "rk", "rv"))
        cap = 64 * P
        ok = dt.distributed_vector(cap, np.int32)
        ol = dt.distributed_vector(cap, np.float32)
        orr = dt.distributed_vector(cap, np.float32)
        out["join_count"] = np.asarray(dt.join(lk, lv, rk, rv, ok, ol, orr,
                                               how="inner"))
        out["join_route"] = np.asarray(relational.last_join_route()["impl"])
        for name, v in (("join_k", ok), ("join_l", ol), ("join_r", orr)):
            out[name] = dt.to_numpy(v)
        res = dt.join_auto(lk, lv, rk, rv, how="inner")
        out["auto_count"] = np.asarray(int(res.count))
        out["auto_route"] = np.asarray(relational.last_join_route()["impl"])
        for name, v in zip(("auto_k", "auto_l", "auto_r"), res.arrays()):
            out[name] = dt.to_numpy(v)
        out["noted"] = np.asarray(str(tuning.lookup(
            "relational", "cap_ratio_join_inner")))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tuning.clear_session()
        tuning.reload()
    return out


def population(pkg, ckpt):
    """The containers a shrink walks: ``v`` checkpointed, then doubled
    (its segments on a lost rank restore from the file, the others keep
    their live values); ``w`` all on rank 0, ``u`` spread and ``m`` a
    one-tile matrix on rank 0, none checkpointed (rescued where all
    their segments survive, else lost)."""
    P = pkg.nprocs()
    src = _inputs(P)["kv"]
    n = len(src)
    v = pkg.distributed_vector.from_array(src)
    pkg.checkpoint.save(ckpt, v)
    pkg.for_each(v, _scale, 2.0)
    w = pkg.distributed_vector(n, np.float32,
                               distribution=[n] + [0] * (P - 1))
    pkg.iota(w, 3)
    u = pkg.distributed_vector(n, np.float32)
    pkg.iota(u, 7)
    m = pkg.dense_matrix.from_array(
        np.arange(64, dtype=np.float32).reshape(8, 8) * 0.5,
        pkg.block_cyclic(grid=(1, 1)))
    return v, w, u, m


def after_rescue(pkg, elastic, rep, v, w, u, m):
    """What a shrink left, as numpy: the fate counts, ``v``, and ``w``
    and ``m`` where not lost, each one's fate, then ``dot_n`` (K3) and
    ``inclusive_scan`` (K4) on the restored ``v``."""
    red = importlib.import_module(pkg.__name__ + ".algorithms.reduce")
    out = {"fates": np.asarray([rep.rescued, rep.restored, rep.lost]),
           "nprocs": np.asarray(pkg.nprocs()),
           "v": pkg.to_numpy(v),
           "w_lost": np.asarray(elastic.is_lost(w)),
           "u_lost": np.asarray(elastic.is_lost(u))}
    out["m_lost"] = np.asarray(elastic.is_lost(m))
    if not elastic.is_lost(w):
        out["w"] = pkg.to_numpy(w)
    if not elastic.is_lost(m):
        out["m"] = pkg.to_numpy(m)
    out["dot_n"] = np.asarray(float(red.dot_n(v, v, 2)))
    s = pkg.distributed_vector(len(v), np.float32)
    pkg.inclusive_scan(v, s)
    out["scan"] = pkg.to_numpy(s)
    return out


def replay_region(pkg, faults, v):
    """The faulted region of ``tests/test_torch_elastic.py``'s
    ``_flush_case`` over ``v``: a ``device.lost`` at the flush, then
    the elastic replay on the shrunken runtime."""
    with faults.injected("device.lost", "device_lost", times=1):
        with pkg.deferred() as p:
            pkg.fill(v, 2.0)
            pkg.for_each(v, _half)
            tot = pkg.reduce(v)
    return {"tot": np.asarray(float(tot)), "v": pkg.to_numpy(v),
            "nprocs": np.asarray(pkg.nprocs()),
            "reasons": np.asarray([e["reason"] for e in p.log]),
            "replayed": np.asarray([e.get("elastic_replayed") or 0
                                    for e in p.log])}


# ----------------------------------------------------------------- worker

def _torch_rows(v):
    from dr_tpu_torch.utils.host import to_host
    return to_host(v.rows).reshape(v.nshards, -1)


def _fail_and_attribute(dt, v, victim):
    """The collective that meets the dead peer, under ``with_deadline``;
    returns the attributed loss and how the wait ended."""
    from dr_tpu_torch.utils import elastic, resilience
    t0 = time.perf_counter()
    try:
        resilience.with_deadline(lambda: float(dt.reduce(v)),
                                 FAIL_DEADLINE_S, site="elastic.multihost",
                                 dump=False)
    except Exception as e:  # noqa: BLE001 - whatever gloo raised
        how = {"error": type(e).__name__, "text": str(e)[:200],
               "seconds": time.perf_counter() - t0}
        return elastic.attribute(e, victim), how
    raise AssertionError("the dead peer went unnoticed by the collective")


def _kill_case(dt, pid, P, out, victim):
    import torch.distributed as dist
    from dr_tpu_torch.utils import elastic, resilience
    ckpt = os.path.join(os.path.dirname(out), f"kill_{P}_{victim}.npz")
    v, w, u, m = population(dt, ckpt)
    dt.barrier()
    if pid == victim:
        os._exit(KILLED)
    loss, how = _fail_and_attribute(dt, v, victim)
    res = {"how": np.asarray(json.dumps(how))}
    gc.collect()
    if P > 2:
        try:
            elastic.rescue_session(loss)
            res["refusal"] = np.asarray("ran")
        except resilience.ProgramError as e:
            ok = e.site == "mesh.shrink" and "several processes" in str(e)
            res["refusal"] = np.asarray("refused" if ok else str(e))
        rep = elastic.rescue_session(
            loss, lost_ranks=[r for r in range(P) if r != pid])
    else:
        rep = elastic.rescue_session(loss)
    res.update(after_rescue(dt, elastic, rep, v, w, u, m))
    rt = dt.runtime()
    res["runtime"] = np.asarray([rt.nprocs, rt.process_count,
                                 int(dist.is_initialized())])
    # the group is left as it was: a new join refuses, classified
    try:
        dt.init_distributed("localhost:1", 2, 0, device="cpu")
        res["rejoin"] = np.asarray("ran")
    except resilience.ProgramError as e:
        res["rejoin"] = np.asarray("refused" if "shrank out of" in str(e)
                                   else str(e))
    t0 = time.perf_counter()
    dist.destroy_process_group()
    res["destroy_s"] = np.asarray(time.perf_counter() - t0)
    return res


def _replay_case(dt, pid, P, out):
    from dr_tpu_torch.utils import faults
    v = dt.distributed_vector.from_array(_inputs(P)["kv"])
    dt.checkpoint.save(os.path.join(os.path.dirname(out), "replay.npz"), v)
    dt.barrier()
    if pid != 0:
        os._exit(KILLED)
    os.environ["DR_GPU_ELASTIC"] = "1"
    return replay_region(dt, faults, v)


def _worker(pid, nproc, port, out, device, case, victim=None):
    import warnings
    import dr_tpu_torch as dt
    from dr_tpu_torch.utils import elastic, spmd_guard
    warnings.simplefilter("ignore", elastic.ElasticWarning)
    rt = dt.init_distributed(f"localhost:{port}", nproc, pid,
                             backend="gloo", device=device,
                             timeout_s=GROUP_TIMEOUT_S)
    assert rt.local_ranks == [pid] and dt.nprocs() == nproc
    if case == "region":
        with spmd_guard.guard() as g:
            res = region(dt, True, _torch_rows)
            eager = region(dt, False, _torch_rows)
            g.verify()
        res.update({f"eager/{k}": v for k, v in eager.items()})
        res["guarded"] = np.asarray(len(g.trace))
    elif case == "tuning":
        db = os.path.join(os.path.dirname(out), "tuning_db.json")
        res = tuned_joins(dt, db, disagree=pid == 1)
    elif case == "kill":
        res = _kill_case(dt, pid, nproc, out, int(victim))
    else:
        res = _replay_case(dt, pid, nproc, out)
    np.savez(f"{out}.{pid}.npz", **res)
    if case in ("region", "tuning"):
        dt.barrier()
    dt.final()
    print(f"MP-OK pid={pid}", flush=True)


# ----------------------------------------------------------------- parent

def _single_region(P):
    import dr_tpu_torch as dt
    dt.init(["cpu"] * P)
    try:
        out = region(dt, True, _torch_rows)
        eager = region(dt, False, _torch_rows)
    finally:
        dt.final()
    out.update({f"eager/{k}": v for k, v in eager.items()})
    return out


def _jax_region(P):
    import jax
    import dr_tpu
    dr_tpu.init(jax.devices()[:P])
    return region(dr_tpu, True, lambda v: np.asarray(v._data))


def _jax_after_kill(P, lost, ckpt):
    """``dr_tpu``'s shrink of the same population on P shards, the ranks
    ``lost`` dropped."""
    import warnings
    import jax
    import dr_tpu
    from dr_tpu.utils import elastic as jelastic
    dr_tpu.init(jax.devices()[:P])
    jelastic.reset()  # the previous survivor's oracle shrank this mesh
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        v, w, u, m = population(dr_tpu, ckpt)
        gc.collect()
        rep = jelastic.rescue_session(lost_ranks=lost)
        return after_rescue(dr_tpu, jelastic, rep, v, w, u, m)


def _jax_replay(ckpt):
    """``dr_tpu``'s injected-loss replay on 2 shards."""
    import warnings
    import jax
    import dr_tpu
    from dr_tpu.utils import faults as jfaults
    from dr_tpu.utils.env import env_override
    dr_tpu.init(jax.devices()[:2])
    with warnings.catch_warnings(), env_override(DR_TPU_ELASTIC="1"):
        warnings.simplefilter("ignore")
        v = dr_tpu.distributed_vector.from_array(_inputs(2)["kv"])
        dr_tpu.checkpoint.save(ckpt, v)
        return replay_region(dr_tpu, jfaults, v)


def _close(mine, want, key):
    if key in EXACT:
        assert same_bits(mine.astype(want.dtype), want), (key, mine, want)
    else:
        scale = float(np.abs(want).max()) + 1.0
        err = float(np.abs(mine.astype(np.float64) - want).max())
        assert err <= FLOAT_TOL * scale, (key, err, scale)


@pytest.fixture
def _reset_port():
    yield
    import dr_tpu_torch as dt
    from dr_tpu_torch.utils import elastic
    dt.final()
    elastic.reset()


@pytest.mark.parametrize("nproc", [2, 3, 4])
def test_deferred_region_across_processes(nproc, tmp_path, _reset_port):
    """P processes record and flush the same region: every process's
    results (deferred and eager) have the single controller's bits, its
    stats and report equal its peers' and the single controller's, and
    the single controller matches ``dr_tpu.deferred()``."""
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn, HERE, nproc, str(tmp_path / "res"),
                              "cpu", DEADLINE_S, ("region",))
        ref = _jax_region(nproc)
        single = _single_region(nproc)
        got = spawned.result()
    for pid, res in enumerate(got):
        assert sorted(res) == sorted(list(single) + ["guarded"])
        for key, want in single.items():
            assert same_bits(res[key], want), (pid, key, res[key], want)
        assert int(res["guarded"]) > 20
    stats = json.loads(str(single["stats"]))
    assert stats["flushes"] >= 1 and stats["opaque_ops"] == 3, stats
    assert stats["graph_captures"] == 0, stats
    for key in ref:
        if key in ("stats", "explain"):
            continue  # the JAX package's routes are its own
        _close(single[key], ref[key], key)
        _close(single[f"eager/{key}"], ref[key], key)


def test_tuning_across_processes(tmp_path, _reset_port):
    """Process 0's records are the answer on both processes, even where
    process 1's overlay disagrees; the joins route alike and give the
    single controller's bits under the same records."""
    import dr_tpu_torch as dt
    got = spawn(HERE, 2, str(tmp_path / "res"), "cpu", DEADLINE_S,
                ("tuning",))
    dt.init(["cpu"] * 2)
    try:
        os.makedirs(tmp_path / "one", exist_ok=True)
        single = tuned_joins(dt, str(tmp_path / "one" / "tuning_db.json"))
    finally:
        dt.final()
    assert list(single["lookup"]) == ["0", "2.0", "csr"], single["lookup"]
    assert str(single["join_route"]) == str(single["auto_route"]) == \
        "partition"
    for pid, res in enumerate(got):
        assert sorted(res) == sorted(single), pid
        for key, want in single.items():
            assert same_bits(res[key], want), (pid, key, res[key], want)


@pytest.mark.parametrize("nproc,victim", [(2, 1), (2, 0), (3, 2)],
                         ids=["p2_kill1", "p2_kill0", "p3_kill2"])
def test_killed_worker_shrinks_survivors(nproc, victim, tmp_path,
                                         _reset_port):
    """The killed-worker leg: every survivor notices the dead peer within
    the deadline, shrinks onto its own rank (refused first, classified,
    where survivors span processes) and holds ``dr_tpu``'s values and
    fate counts from the same checkpoint; the process group is left as
    it was, and a new join refuses until it is destroyed."""
    got = spawn(HERE, nproc, str(tmp_path / "res"), "cpu", DEADLINE_S,
                ("kill", victim), exits={victim: KILLED})
    for pid, res in enumerate(got):
        if pid == victim:
            continue
        lost = [r for r in range(nproc) if r != pid]
        ref = _jax_after_kill(nproc, lost, str(tmp_path / f"j{pid}.npz"))
        how = json.loads(str(res["how"]))
        assert how["seconds"] < FAIL_DEADLINE_S, how
        if nproc > 2:
            assert str(res["refusal"]) == "refused", res["refusal"]
        assert list(res["runtime"]) == [1, 1, 1], res["runtime"]
        assert str(res["rejoin"]) == "refused", res["rejoin"]
        assert float(res["destroy_s"]) < 5.0
        assert sorted(k for k in ref) == sorted(
            k for k in res if k not in ("how", "refusal", "runtime",
                                        "rejoin", "destroy_s")), pid
        for key in ("fates", "nprocs", "v", "w_lost", "u_lost", "w",
                    "m_lost", "m"):
            if key in ref:
                assert same_bits(res[key].astype(ref[key].dtype),
                                 ref[key]), (pid, key, res[key], ref[key])
        for key in ("dot_n", "scan"):
            _close(res[key], ref[key], key)


def test_killed_worker_flush_replays(tmp_path, _reset_port):
    """A ``device.lost`` injected at the flush of process 0's region
    after process 1 died: the replay runs on rank 0 and ends as
    ``dr_tpu``'s injected-loss replay on 2 shards."""
    got = spawn(HERE, 2, str(tmp_path / "res"), "cpu", DEADLINE_S,
                ("replay",), exits={1: KILLED})
    ref = _jax_replay(str(tmp_path / "j.npz"))
    res = got[0]
    assert "elastic replay" in list(res["reasons"]), res["reasons"]
    assert int(res["nprocs"]) == 1 and res["replayed"].sum() > 0
    for key in ("tot", "v", "nprocs", "reasons", "replayed"):
        assert same_bits(res[key].astype(ref[key].dtype), ref[key]), \
            (key, res[key], ref[key])


def test_deferred_region_sanitized(tmp_path, monkeypatch, _reset_port):
    """The region's processes with the sanitizer armed
    (``DR_GPU_SANITIZE=1``): ``plansan`` replays each run abstractly
    under a single-controller view (no message to a peer), the finite
    sweeps skip another process's rows, and every result keeps the
    unsanitized single controller's bits."""
    monkeypatch.setenv("DR_GPU_SANITIZE", "1")
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn, HERE, 2, str(tmp_path / "res"),
                              "cpu", DEADLINE_S, ("region",))
        single = _single_region(2)
        got = spawned.result()
    for pid, res in enumerate(got):
        for key, want in single.items():
            assert same_bits(res[key], want), (pid, key, res[key], want)


def test_phase31_rehearsal(tmp_path, _reset_port):
    """``chip_smoke.py``'s phase 31 at its CPU sizes: the region with one
    controller on two CPU ranks, then in two processes over gloo (every
    child's digests equal bit for bit, its launch counts its rank's
    share: 0 with 0 on the CPU), the joins under the tuning DB, and the
    killed-worker leg, whose survivor restores and equals one
    controller's digests."""
    import importlib.util
    import dr_tpu_torch as dt
    from dr_tpu_torch.ops import kernels
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", HERE.parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    got = cs.mp31_phase(dt, kernels, 5, "cpu", device="cpu", small=True,
                        out_dir=str(tmp_path))
    assert got["p0_stats"] == got["p1_stats"] == got["single_stats"]
    assert got["kill_how"] == "raised" and got["kill_restore_gbps"] > 0


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            *sys.argv[5:8])
