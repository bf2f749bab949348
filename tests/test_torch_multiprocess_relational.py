"""The port's multi-process relational ops and re-layout: ``join`` on
both routes and every ``how``, ``groupby_aggregate`` with every
aggregation, ``unique``, ``histogram`` (K8), ``top_k`` (with
``merge=True``), the auto tier, ``redistribute`` between even, uneven
and one-rank layouts (vectors and a matrix re-block) and the
unstructured halo, on P = 2, 3 and 4 CPU processes over gloo, one rank
each (``dt.init_distributed``), against two oracles.

The file is its own worker::

    python tests/test_torch_multiprocess_relational.py <pid> <nproc> <port> <out> [device]

runs :func:`paths` in a process of a ``nproc``-process runtime and
writes every result to ``<out>.<pid>.npz``: every gathered result on
every process, and the ghost buffers of the process's own ranks under
``uh_ghost/<rank>``.  The worker imports neither ``jax`` nor
``dr_tpu``; only the parent's oracle does.

The parent holds each process's results to the port's single controller
on ``dt.init(["cpu"] * P)`` bit for bit, and the single controller to
the JAX package on P shards with the same numpy inputs: keys, counts,
integer and min / max aggregates, bins, ``unique``, ``top_k`` values
and indices, joined rows, re-laid rows and the halo's ghosts and folds
(small integers in f32, exact in any order) bit for bit; float
groupby sums and means within :data:`FLOAT_TOL`, the tolerance
``tests/test_torch_relational.py`` states for them (the two packages
add a group's values in different orders).  The inputs hold no -0.0
(the port keeps it in ``sort_by_key`` payloads where the JAX package
loses it).  Each spawn has its own deadline and process-group timeout,
and kills stragglers.
"""

import contextlib
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
GROUP_TIMEOUT_S = 90.0
SEED = 20261023
#: float groupby sums and means against the JAX package, as
#: ``tests/test_torch_relational.py`` holds them
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
FLOAT = ("gb_sum_v", "gb_mean_v", "gb_uneven_v", "gba_v")
AGGS = ("sum", "min", "max", "mean", "count")
HOWS = ("inner", "left", "right", "outer")
#: DR_GPU_JOIN_BROADCAST_MAX (and the JAX package's twin) per route;
#: None leaves it unset: the default threshold, the broadcast route at
#: these sizes
ROUTES = {"default": None, "partition": "0"}
UH_OPS = ("plus", "max", "min")


def _usizes(P):
    """An uneven layout, one block a process."""
    return [3 + 2 * r for r in range(P)]


def _tsizes(P, n):
    """A "team" layout: every other rank empty, the rest evenly."""
    live = list(range(0, P, 2))
    per = [n // len(live) + (i < n % len(live)) for i in range(len(live))]
    out = [0] * P
    for r, c in zip(live, per):
        out[r] = c
    return out


def _inputs(P):
    """The numpy inputs of the paths, from the seed (no -0.0)."""
    rng = np.random.default_rng(SEED + P)
    f32, i32 = np.float32, np.int32
    n = 6 * P + 5
    nu = sum(_usizes(P))
    nuh = 8 * P + 3
    ghosts = {r: rng.integers(0, nuh, 5 + r) for r in range(P - 1)}
    for r in ghosts:  # a repeat, and a cell of the next rank's block
        seg = -(-nuh // P)
        ghosts[r][1] = ghosts[r][0]
        ghosts[r][2] = min(((r + 1) % P) * seg + 1, nuh - 1)
    return {
        "gk": rng.integers(0, 7, n).astype(i32),
        "gv": rng.standard_normal(n).astype(f32),
        "gi": rng.integers(-50, 50, n).astype(i32),
        "uk": rng.integers(0, 5, nu).astype(i32),
        "uv": rng.standard_normal(nu).astype(f32),
        "tk": rng.integers(0, 4, n).astype(i32),
        "lk": rng.integers(0, 9, 5 * P + 3).astype(i32),
        "lv": rng.standard_normal(5 * P + 3).astype(f32),
        "rk": rng.integers(2, 12, 4 * P + 1).astype(i32),
        "rv": rng.standard_normal(4 * P + 1).astype(f32),
        "rd": rng.standard_normal(nu).astype(f32),
        "dm": rng.standard_normal((2 * P + 1, 5)).astype(f32),
        "uh": rng.integers(-20, 20, nuh).astype(f32),
        "uh_ghosts": ghosts,
        "uh_contrib": {r: rng.integers(-9, 9, len(g)).astype(f32)
                       for r, g in ghosts.items()},
    }


@contextlib.contextmanager
def _route(route):
    """Both packages' join-route threshold for one route."""
    names = ("DR_GPU_JOIN_BROADCAST_MAX", "DR_TPU_JOIN_BROADCAST_MAX")
    saved = {k: os.environ.get(k) for k in names}
    for k in names:
        if ROUTES[route] is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = ROUTES[route]
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def paths(pkg, host, rows_of, local, port):
    """The slice's paths at a small size on ``pkg`` (the port or the JAX
    package, on its current runtime); returns every result as a numpy
    array.  ``host(x)`` is a package array as numpy, ``rows_of(v)`` a
    vector's padded rows, rank by rank, ``local`` the ranks whose ghost
    buffers this process reads; ``port`` adds the port's own checks
    (the join's route record, the host-staged re-layout, the halo's
    ``second`` fold)."""
    rel = importlib.import_module(pkg.__name__ + ".algorithms.relational")
    P = pkg.nprocs()
    inp = _inputs(P)
    f32, i32 = np.float32, np.int32
    tn = pkg.to_numpy
    out = {}

    def vec(x, **kw):
        return pkg.distributed_vector.from_array(x, **kw)

    def groupby(tag, k, v, agg, n, vdt=f32):
        ok = pkg.distributed_vector(n, i32)
        ov = pkg.distributed_vector(n, vdt)
        out[f"{tag}_n"] = np.asarray(int(pkg.groupby_aggregate(
            k, v, ok, ov, agg=agg)))
        out[f"{tag}_k"], out[f"{tag}_v"] = tn(ok), tn(ov)

    # ---- groupby: every aggregation, integer sums (K7), uneven and
    # "team" layouts, a window under a transform view, a short vector
    n = len(inp["gk"])
    k, v = vec(inp["gk"]), vec(inp["gv"])
    for agg in AGGS:
        groupby(f"gb_{agg}", k, v, agg, n)
    groupby("gb_count_none", k, None, "count", n, i32)
    gi = vec(inp["gi"])
    groupby("gb_int", k, gi, "sum", n, i32)
    uk = vec(inp["uk"], distribution=_usizes(P))
    uv = vec(inp["uv"], distribution=_usizes(P))
    groupby("gb_uneven", uk, uv, "sum", len(inp["uk"]))
    tk = vec(inp["tk"], distribution=_tsizes(P, n))
    win = pkg.views.transform(tk[1:n - 1], lambda x: x * 3 + 1)
    groupby("gb_team_view", win, gi[1:n - 1], "min", n, i32)
    short = vec(inp["gk"][:P - 1])          # the last rank empty
    groupby("gb_short", short, vec(inp["gi"][:P - 1]), "sum", P, i32)

    # ---- unique
    u = pkg.distributed_vector(n, i32)
    out["uniq_n"] = np.asarray(int(pkg.unique(k, u)))
    out["uniq"] = tn(u)
    out["uniq_win_n"] = np.asarray(int(pkg.unique(tk[2:n - 1], u)))
    out["uniq_win"] = tn(u)

    # ---- histogram (K8's plain version here): a window of a view too
    hb = pkg.distributed_vector(16, i32)
    pkg.histogram(v, hb, -2.0, 2.0)
    out["hist"] = tn(hb)
    h7 = pkg.distributed_vector(7, f32)
    pkg.histogram(pkg.views.transform(v[2:n - 3], lambda x: x * 2.0), h7,
                  -3.0, 3.0)
    out["hist_view"] = tn(h7)

    # ---- top_k: largest with indices, smallest, a running merge
    tv = pkg.distributed_vector(5, f32)
    ti = pkg.distributed_vector(5, i32)
    pkg.top_k(v, tv, ti)
    out["topk_v"], out["topk_i"] = tn(tv), tn(ti)
    pkg.top_k(gi, ti, largest=False)
    out["topk_small"] = tn(ti)
    mv = pkg.distributed_vector(4, f32)
    mi = pkg.distributed_vector(4, i32)
    pkg.top_k(v[0:n // 2], mv, mi)
    pkg.top_k(v[n // 2:n], mv, mi, merge=True)
    out["topk_merge_v"], out["topk_merge_i"] = tn(mv), tn(mi)

    # ---- join: every how on both routes, uneven and team sides
    lk, lv = vec(inp["lk"]), vec(inp["lv"])
    rk, rv = vec(inp["rk"]), vec(inp["rv"])
    cap = 2 * len(inp["lk"]) * len(inp["rk"])
    jo = [pkg.distributed_vector(cap, dt) for dt in (i32, f32, f32)]
    for route in ROUTES:
        with _route(route):
            for how in HOWS:
                m = int(pkg.join(lk, lv, rk, rv, *jo, how=how, fill=-1.0))
                tag = f"join_{how}_{route}"
                out[f"{tag}_n"] = np.asarray(m)
                out[tag] = np.concatenate([tn(o)[:m].view(i32)
                                           for o in jo])
                if port:
                    out[f"{tag}_impl"] = np.asarray(
                        rel.last_join_route()["impl"])
            # an uneven left side against a right side with empty ranks,
            # integer right values filled with 2.5 cast to int32
            m = int(pkg.join(uk, uv, tk, gi, *jo, how="outer", fill=2.5))
            out[f"join_team_{route}_n"] = np.asarray(m)
            out[f"join_team_{route}"] = np.concatenate(
                [tn(o)[:m].view(i32) for o in jo])

    # ---- empty inputs: the one-cell n == 0 scratch, empty windows, a
    # right join against an empty left side
    e = vec(np.zeros(0, i32))
    groupby("gb_empty", e, e, "sum", 4, i32)
    groupby("gb_empty_win", k[2:2], gi[2:2], "max", 4, i32)
    eu = pkg.distributed_vector(4, i32)
    out["uniq_empty_n"] = np.asarray(int(pkg.unique(gi[3:3], eu)))
    out["uniq_empty"] = tn(eu)
    pkg.top_k(v[1:1], tv, ti)
    out["topk_empty"] = np.concatenate([tn(tv).view(i32), tn(ti)])
    m = int(pkg.join(lk[0:0], lv[0:0], rk, rv, *jo, how="right", fill=-1.0))
    out["join_empty_n"] = np.asarray(m)
    out["join_empty"] = np.concatenate([tn(o)[:m].view(i32) for o in jo])

    # ---- the auto tier
    ja = pkg.join_auto(lk, lv, rk, rv, how="outer", fill=-1.0)
    out["ja_n"] = np.asarray(ja.count)
    out["ja"] = np.concatenate([a.view(i32) for a in ja.arrays()])
    ga = pkg.groupby_auto(k, v, "mean")
    out["gba_n"] = np.asarray(ga.count)
    out["gba_k"], out["gba_v"] = ga.arrays()
    ua = pkg.unique_auto(gi)
    out["ua_n"] = np.asarray(ua.count)
    out["ua"] = ua.arrays()[0]

    # ---- redistribute: even -> uneven -> one rank -> even, rows too
    nu = len(inp["rd"])
    rd = vec(inp["rd"])
    for tag, d in (("uneven", _usizes(P)[::-1]),
                   ("one", [0] * (P - 1) + [nu]), ("even", None)):
        pkg.redistribute(rd, d)
        out[f"rd_{tag}"] = tn(rd)
        out[f"rd_{tag}_rows"] = rows_of(rd)
        if port:
            hs = vec(inp["rd"])
            rdx = importlib.import_module(pkg.__name__
                                          + ".parallel.redistribute")
            rdx._host_staged(hs, d, pkg.runtime())
            out[f"rd_{tag}_host_rows"] = rows_of(hs)
    D = pkg.dense_matrix.from_array(
        inp["dm"], partition=pkg.block_cyclic(tile=(2, 2)))
    pkg.redistribute(D)
    out["rd_matrix"] = D.materialize()

    # ---- the unstructured halo: repeats and cells of another process's
    # rank; rank P - 1 mirrors nothing
    base = inp["uh"]
    hv = vec(base)
    uh = pkg.unstructured_halo(hv, inp["uh_ghosts"])
    uh.exchange()
    for r in local:
        out[f"uh_ghost/{r}"] = host(uh.ghost_values(r))
    ops = UH_OPS + (("second",) if port else ())
    for op in ops:
        hv.assign_array(base)
        for r in local:
            if r in inp["uh_contrib"]:
                uh.set_ghost_values(r, inp["uh_contrib"][r])
        uh.reduce(op)
        out[f"uh_{op}"] = tn(hv)

    # ---- the calls that left the multi-process refusals
    # (tests/test_torch_multiprocess.py's _out_of_slice)
    w = pkg.distributed_vector(7 * P + 3, f32)
    pkg.iota(w, 0)
    pkg.redistribute(w, None)
    out["left_redistribute"] = tn(w)
    lu = pkg.unstructured_halo(w, {0: [1]})
    lu.exchange()
    if 0 in local:
        out["uh_ghost_left/0"] = host(lu.ghost_values(0))
    lh = pkg.distributed_vector(4, i32)
    pkg.histogram(w, lh, 0.0, 1.0)
    out["left_hist"] = tn(lh)
    return out


# ----------------------------------------------------------------- worker

def _torch_host(x):
    return x.detach().cpu().numpy()


def _torch_rows(v):
    from dr_tpu_torch.utils.host import to_host
    return to_host(v.rows).reshape(v.nshards, -1)


def _port_paths(dt, local):
    return paths(dt, _torch_host, _torch_rows, local, True)


def _armed(dt, tmp):
    """The auto tier and the join with the tuning layer armed (a DB in
    ``tmp``, ``DR_GPU_PLAN_OPT=all``: the ``capinfer`` and ``joinroute``
    passes read it), which refused across processes before the tuning
    layer ran there; returns their counts, routes and rows under keys
    ending in ``_armed``."""
    from dr_tpu_torch.algorithms import relational
    P = dt.nprocs()
    v = dt.distributed_vector.from_array(np.arange(4 * P, dtype=np.float32))
    env = {"DR_GPU_TUNING_DB": os.path.join(tmp, "tuning_db.json"),
           "DR_GPU_PLAN_OPT": "all"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = {}
    try:
        res = dt.join_auto(v, v, v, v)
        out["capinfer_count_armed"] = np.asarray(int(res.count))
        for name, c in zip("klr", res.arrays()):
            out[f"capinfer_{name}_armed"] = dt.to_numpy(c)
        outs = [dt.distributed_vector(8 * P) for _ in range(3)]
        out["joinroute_count_armed"] = np.asarray(dt.join(v, v, v, v, *outs))
        out["joinroute_impl_armed"] = np.asarray(
            relational.last_join_route()["impl"])
        for name, c in zip("klr", outs):
            out[f"joinroute_{name}_armed"] = dt.to_numpy(c)
    finally:
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    return out


def _refusals(dt):
    """What still refuses across processes, classified: a ghost buffer
    of another process's rank and a re-layout onto a runtime outside the
    process group; and a faulted re-layout, which raises on every
    process and leaves each one's layout and rows as they were."""
    import torch
    from dr_tpu_torch.parallel.runtime import Runtime
    from dr_tpu_torch.utils import resilience
    rt = dt.runtime()
    P = rt.nprocs
    v = dt.distributed_vector.from_array(np.arange(4 * P, dtype=np.float32))
    got = {}

    def refused(name, call, text):
        try:
            call()
            got[name] = "ran"
        except Exception as e:  # noqa: BLE001 - the class is the check
            want = resilience.TransientBackendError if text == "transient" \
                else resilience.ProgramError
            ok = resilience.classify(e) is want and (
                text == "transient" or text in str(e))
            got[name] = "refused" if ok else f"{type(e).__name__}: {e}"

    uh = dt.unstructured_halo(v, {r: [0, 4 * P - 1] for r in range(P)})
    other = (rt.process_index + 1) % P
    refused("ghost_values", lambda: uh.ghost_values(other), "not this one")
    refused("set_ghost_values",
            lambda: uh.set_ghost_values(other, [1.0, 2.0]), "not this one")
    refused("redistribute_outside",
            lambda: dt.redistribute(v, None, runtime=Runtime(
                [torch.device("cpu")] * P)), "one process group")
    # a faulted collective re-layout rolls every process back
    before = (v.layout, [r.clone() for r in v.rows if r is not None])
    with dt.faults.injected("redistribute.exchange", "transient"):
        refused("rollback", lambda: dt.redistribute(
            v, [4 * P] + [0] * (P - 1)), "transient")
    if got["rollback"] == "refused" and (
            v.layout != before[0] or not all(
                torch.equal(a, b) for a, b in zip(
                    [r for r in v.rows if r is not None], before[1]))):
        got["rollback"] = "rows changed"
    return got


def _worker(pid, nproc, port, out, device="cpu"):
    import dr_tpu_torch as dt
    from dr_tpu_torch.utils import spmd_guard
    rt = dt.init_distributed(f"localhost:{port}", nproc, pid,
                             backend="gloo", device=device,
                             timeout_s=GROUP_TIMEOUT_S)
    assert rt.local_ranks == [pid] and dt.nprocs() == nproc
    with spmd_guard.guard() as g:
        res = _port_paths(dt, rt.local_ranks)
        g.verify()
    assert len(g.trace) > 40, len(g.trace)
    res.update(_armed(dt, os.path.dirname(out)))
    got = _refusals(dt)
    res["refusals"] = np.asarray([f"{k}={v}" for k, v in sorted(got.items())])
    np.savez(f"{out}.{pid}.npz", **res)
    dt.barrier()
    dt.final()
    print(f"MP-OK pid={pid}", flush=True)


# ----------------------------------------------------------------- parent

def _single_controller(P, tmp):
    import dr_tpu_torch as dt
    dt.init(["cpu"] * P)
    try:
        out = _port_paths(dt, range(P))
        out.update(_armed(dt, tmp))
        return out
    finally:
        dt.final()


def _jax_reference(P):
    import jax
    import dr_tpu
    dr_tpu.init(jax.devices()[:P])
    return paths(dr_tpu, np.asarray, lambda v: np.asarray(v._data),
                 range(P), False)


def _numpy_fold(inp, op):
    want = inp["uh"].copy()
    flat = np.concatenate([inp["uh_ghosts"][r]
                           for r in sorted(inp["uh_ghosts"])])
    vals = np.concatenate([inp["uh_contrib"][r]
                           for r in sorted(inp["uh_ghosts"])])
    if op == "second":
        want[flat] = vals
    else:
        {"plus": np.add, "max": np.maximum, "min": np.minimum}[op].at(
            want, flat, vals)
    return want


@pytest.fixture
def _reset_port():
    yield
    import dr_tpu_torch as dt
    dt.final()


@pytest.mark.parametrize("nproc", [2, 3, 4])
def test_multi_process_relational(nproc, tmp_path, _reset_port):
    """P processes over gloo: every process's results have the single
    controller's bits, its ghost buffers those of its own rank, and the
    refusals stay classified (the auto tier and the join with the
    tuning layer armed run, with the single controller's bits); the JAX
    package on P shards agrees bit for bit on everything but float
    groupby sums and means, which hold to FLOAT_TOL; the halo's folds
    equal numpy's."""
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn, HERE, nproc, str(tmp_path / "res"),
                              deadline_s=DEADLINE_S)
        ref = _jax_reference(nproc)
        single = _single_controller(nproc, str(tmp_path))
        got = spawned.result()
    for pid, res in enumerate(got):
        mine = {k: w for k, w in single.items()
                if "/" not in k or k.endswith(f"/{pid}")}
        assert sorted(res) == sorted(list(mine) + ["refusals"])
        for key, want in mine.items():
            assert same_bits(res[key], want), (pid, key, res[key], want)
        assert all(r.endswith("=refused") for r in res["refusals"]), \
            (pid, res["refusals"])
        assert len(res["refusals"]) == 4, res["refusals"]
    # the routes the joins took, and the host-staged re-layout's rows
    for how in HOWS:
        assert single[f"join_{how}_default_impl"] == "broadcast", how
        assert single[f"join_{how}_partition_impl"] == "partition", how
    for tag in ("uneven", "one", "even"):
        assert same_bits(single[f"rd_{tag}_host_rows"],
                         single[f"rd_{tag}_rows"]), tag
    inp = _inputs(nproc)
    for op in UH_OPS + ("second",):
        assert same_bits(single[f"uh_{op}"], _numpy_fold(inp, op)), op
    assert sorted(ref) == sorted(k for k in single if not k.endswith(
        ("_impl", "_host_rows", "uh_second", "_armed")))
    for key, want in ref.items():
        mine = single[key]
        if key in FLOAT:
            np.testing.assert_allclose(mine, want, **FLOAT_TOL)
        else:
            assert same_bits(mine.astype(want.dtype), want), \
                (key, mine, want)


def test_phase30_rehearsal(tmp_path, _reset_port):
    """``chip_smoke.py``'s phase 30 at its CPU sizes: one controller on
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
    got = cs.mp30_phase(dt, kernels, 5, "cpu", device="cpu", small=True,
                        out_dir=str(tmp_path))
    assert got["processes"] == 2 and set(got["p0_steps"]) == \
        set(got["single_steps"])
    assert got["p1_gbps"]["collective"] > 0


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            *sys.argv[5:6])
