"""dr_tpu_torch.utils.spmd_guard and core.pinning against their JAX
oracle (``tests/test_spmd_guard.py``): the dispatch tap through every
module cache of the port, canonicalization (the same canonical strings as
the JAX package for the same keys), digests, divergence location, the
LRU bound and the pin-eviction purge, and ``verify()`` across two
processes over ``torch.distributed`` (gloo)."""

import os
import socket
import subprocess
import sys
import textwrap
from collections import OrderedDict

import numpy as np
import pytest
import torch

import dr_tpu_torch as dt
from dr_tpu.core import pinning as jpinning
from dr_tpu.utils import spmd_guard as jguard
from dr_tpu_torch.core import pinning
from dr_tpu_torch.utils import spmd_guard
from dr_tpu_torch.utils.spmd_guard import TappedCache

P = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port():
    dt.init(["cpu"] * P)
    yield
    dt.final()


def _workload(n):
    a = dt.distributed_vector(n)
    b = dt.distributed_vector(n)
    dt.iota(a, 0)
    dt.fill(b, 2.0)
    dt.dot(a, b)
    out = dt.distributed_vector(n)
    dt.inclusive_scan(a, out)


def test_guard_records_dispatches():
    with spmd_guard.guard() as g:
        _workload(256)
    assert len(g.trace) >= 4  # iota, fill, dot, scan at minimum
    tags = [t.split(",")[0].strip("('") for t in g.trace]
    assert {"gen", "red", "scan"} <= set(tags)
    g.verify()  # one process: agrees with itself


def test_identical_sequences_share_digest():
    with spmd_guard.guard() as g1:
        _workload(256)
    with spmd_guard.guard() as g2:
        _workload(256)
    assert g1.digest() == g2.digest()
    with spmd_guard.guard() as g3:
        _workload(512)
    assert g1.digest() != g3.digest()


def test_digest_independent_of_runtime_object():
    """A key holds ``pinned_id(runtime)``, never a device: the same
    program on another runtime object over other device objects records
    the same trace (the card-versus-CPU digest of chip_smoke phase 22)."""
    with spmd_guard.guard() as g1:
        _workload(256)
    dt.init([torch.device("cpu", 0)] * P)
    with spmd_guard.guard() as g2:
        _workload(256)
    assert g1.trace == g2.trace
    assert not any("device(" in t for t in g1.trace)


@pytest.mark.parametrize("key", [
    ("dot", "PIN", (8, 32, 0, 0, 256)),
    ("scan", (8, 1 << 33, 0, 0, (1 << 36) + 8)),
    ("gen", "fill", (8, 16, 0, 0, 128), 0, 128, "float32"),
    ("ew", ("PIN", (8, 16, 1, 1, 128)), None, True, (True, False), 2.5),
])
def test_canon_matches_reference(key):
    """The same key structure canonicalizes to the same string in both
    packages (pins become ``ptr``; structural ints stay verbatim)."""
    obj = object()

    def fill(k, pin):
        if isinstance(k, tuple):
            return tuple(fill(e, pin) for e in k)
        return pin(obj) if k == "PIN" else k

    assert spmd_guard._canon(fill(key, pinning.pinned_id)) == \
        jguard._canon(fill(key, jpinning.pinned_id))


def test_canonicalization_hides_object_ids():
    key1 = ("dot", pinning.pinned_id(object()), (8, 32, 0, 0, 256))
    key2 = ("dot", pinning.pinned_id(object()), (8, 32, 0, 0, 256))
    assert spmd_guard._canon(key1) == spmd_guard._canon(key2)
    assert "ptr" in spmd_guard._canon(key1)
    big1 = ("scan", (8, 1 << 33, 0, 0, (1 << 36) + 8))
    big2 = ("scan", (8, 1 << 33, 0, 0, (1 << 36) + 16))
    assert spmd_guard._canon(big1) != spmd_guard._canon(big2)


def test_divergence_detection_logic():
    g = spmd_guard.SpmdGuard()
    g.record(("fill", 1))
    g.record(("dot", 2))
    h = spmd_guard.SpmdGuard()
    h.record(("fill", 1))
    h.record(("scan", 2))
    assert g.digest() != h.digest()
    assert spmd_guard.first_divergence(g.trace, h.trace) == \
        (1, g.trace[1], h.trace[1])
    h2 = spmd_guard.SpmdGuard()
    h2.record(("fill", 1))
    assert spmd_guard.first_divergence(g.trace, h2.trace) == (1, None, None)
    assert spmd_guard.first_divergence(g.trace, h.trace) == \
        jguard.first_divergence(g.trace, h.trace)


def test_guard_nesting_restores():
    assert spmd_guard.active() is None
    with spmd_guard.guard() as outer:
        with spmd_guard.guard() as inner:
            dt.fill(dt.distributed_vector(64), 1.0)
            assert spmd_guard.active() is inner
        assert spmd_guard.active() is outer
    assert spmd_guard.active() is None
    assert inner.trace and not outer.trace


def test_all_module_caches_are_tapped():
    """test_spmd_guard.py:80: halo, communicator, mdarray, dense matrix
    and ring attention dispatches land on the trace."""
    hb = dt.halo_bounds(1, 1, periodic=True)
    dv = dt.distributed_vector.from_array(
        np.arange(32, dtype=np.float32), halo=hb)
    with spmd_guard.guard() as g:
        dt.halo(dv).exchange()
        n0 = len(g.trace)
        assert n0 >= 1, "halo exchange not recorded"
        comm = dt.default_comm()
        comm.shift_forward(dv.rows, periodic=True)
        assert len(g.trace) > n0, "communicator shift not recorded"
        n1 = len(g.trace)
        M = dt.distributed_mdarray.from_array(np.zeros((8, 8), np.float32))
        T = dt.distributed_mdarray((8, 8))
        dt.transpose(T, M)
        assert len(g.trace) > n1, "mdarray transpose not recorded"
        n2 = len(g.trace)
        A = dt.dense_matrix.from_array(np.ones((8, 8), np.float32))
        dt.gemm(A, A)
        assert len(g.trace) > n2, "dense matrix dispatch not recorded"
        n3 = len(g.trace)
        S = 4 * dt.nprocs()
        q = np.zeros((1, S, 1, 8), np.float32)
        dt.ring_attention(q, q, q, causal=True)
        assert len(g.trace) > n3, "ring attention not recorded"
    tags = {t.split(",")[0].strip("('") for t in g.trace}
    assert {"exchange", "shift", "mdT", "gemm", "ringattn"} <= tags
    # one module-level TappedCache wherever the JAX module owns one
    import importlib
    for mod, attr in (("algorithms.elementwise", "_prog_cache"),
                      ("containers.distributed_vector", "_jit_cache"),
                      ("containers.dense_matrix", "_cache"),
                      ("containers.mdarray", "_md_cache"),
                      ("parallel.collectives", "_shift_cache"),
                      ("parallel.halo", "_program_cache"),
                      ("parallel.redistribute", "_prog_cache"),
                      ("ops.ring_attention", "_cache")):
        tc = getattr(importlib.import_module(f"dr_tpu_torch.{mod}"), attr)
        jc = getattr(importlib.import_module(f"dr_tpu.{mod}"), attr)
        assert isinstance(tc, TappedCache), mod
        assert isinstance(jc, jguard.TappedCache), mod


def _tags(g):
    return [t.split(",")[0].strip("('") for t in g.trace]


def test_main_path_ops_land_on_the_trace():
    """Every op of the 1-D main path records its own dispatch, and the
    second run of the path inserts no key."""
    n = P * 1024

    def path():
        src = np.linspace(0.0, 1.0, n).astype(np.float32)
        a = dt.distributed_vector.from_array(
            src, halo=dt.halo_bounds(128, 128, periodic=True))
        out = {}
        with spmd_guard.guard() as g:
            dt.halo(a).exchange()
            out["exchange"] = _tags(g)[-1]
            dt.stencil_iterate_matmul(a, [0.25, 0.5, 0.25], 16, k_block=8)
            out["mm"] = _tags(g)[-1]
            b = dt.distributed_vector.from_array(
                src, halo=dt.halo_bounds(1024, 1024, periodic=True))
            dt.stencil_iterate_blocked(b, [0.25, 0.5, 0.25], 16,
                                       time_block=8)
            out["blk"] = _tags(g)[-1]
            out["dot"] = dt.dot(a, a)
            dt.dot_n(a, a, 2)
            out["dot_n"] = _tags(g)[-1]
            s = dt.distributed_vector(n)
            dt.inclusive_scan(a, s)
            out["scan"] = [t for t in _tags(g) if t.startswith("scan")][-1]
        return out, g

    first, g1 = path()
    c0 = spmd_guard.compile_count()
    second, g2 = path()
    assert spmd_guard.compile_count() == c0
    assert g1.trace == g2.trace and first == second
    assert (first["exchange"], first["mm"], first["blk"], first["dot_n"],
            first["scan"]) == ("exchange", "stencil_mm", "stencil_blk",
                               "dot_n", "scan")
    assert "red" in _tags(g1)


def test_op_identity_survives_canonicalization():
    def op_a(x):
        return x * 2

    def op_b(x):
        return x * 3

    src = np.ones(64, np.float32)
    out = dt.distributed_vector(64)
    with spmd_guard.guard() as ga:
        dt.transform(dt.distributed_vector.from_array(src), out, op_a)
    with spmd_guard.guard() as gb:
        dt.transform(dt.distributed_vector.from_array(src), out, op_b)
    assert ga.digest() != gb.digest()
    assert any("op_a" in t for t in ga.trace)


def test_lambda_code_identity_diverges():
    f = lambda x: x * 2  # noqa: E731
    g = lambda x: x * 3  # noqa: E731
    cf = spmd_guard._canon(("t", pinning.pinned_id(f)))
    cg = spmd_guard._canon(("t", pinning.pinned_id(g)))
    assert cf != cg
    h1 = lambda x: x * 2  # noqa: E731
    assert spmd_guard._canon(("t", pinning.pinned_id(h1))) == cf
    # the code hash is the JAX package's
    assert cf == jguard._canon(("t", jpinning.pinned_id(f)))


def test_two_lambdas_diverge_at_first_differing_index():
    src = np.ones(64, np.float32)
    traces = []
    for op in (lambda x: x * 2, lambda x: x + 2):  # noqa: E731
        out = dt.distributed_vector(64)
        v = dt.distributed_vector.from_array(src)
        with spmd_guard.guard() as g:
            dt.fill(out, 0.0)
            dt.transform(v, out, op)
            dt.fill(out, 1.0)
        traces.append(g.trace)
    i, a, b = spmd_guard.first_divergence(*traces)
    assert i == 1 and a.startswith("('ew'") and a != b


def test_tapped_cache_lru_bound(monkeypatch):
    monkeypatch.setenv("DR_GPU_PROG_CACHE_CAP", "8")
    c = TappedCache()
    for i in range(8):
        c[("k", i)] = i
    assert len(c) == 8
    assert c.get(("k", 0)) == 0
    c[("k", 8)] = 8
    assert len(c) == 8
    assert c.get(("k", 0)) == 0          # refreshed -> kept
    assert c.get(("k", 1)) is None       # the true oldest -> evicted
    c.setdefault(("k", 2), None)
    for i in range(9, 15):
        c[("k", i)] = i
    assert c.get(("k", 2)) is not None
    monkeypatch.setenv("DR_GPU_PROG_CACHE_CAP", "lots")
    before = len(c)
    c[("k", 99)] = 99
    assert len(c) == before + 1


def test_tap_counts_dispatches_and_compiles():
    c = TappedCache()
    d0, c0 = spmd_guard.dispatch_count(), spmd_guard.compile_count()
    assert c.tap(("t", 1)) is True
    assert c.tap(("t", 1)) is True
    assert c.tap(("t", 2), lambda: "plan") == "plan"
    assert spmd_guard.dispatch_count() - d0 == 3
    assert spmd_guard.compile_count() - c0 == 2
    spmd_guard.note_compile(("t", 2, 8))
    assert spmd_guard.compile_count() - c0 == 3


def test_pin_eviction_purges_cache_entries(monkeypatch):
    monkeypatch.setattr(pinning, "_pins", OrderedDict())
    monkeypatch.setattr(spmd_guard, "_pins", pinning._pins)
    monkeypatch.setenv("DR_GPU_PIN_CAP", "1024")
    c = TappedCache()
    keep = [object() for _ in range(1024 + 256 + 1)]
    pid0 = pinning.pinned_id(keep[0])
    c[("prog", pid0, 7)] = "compiled"
    c[("prog", "no-pin", 8)] = "other"
    assert c.get(("prog", pid0, 7)) == "compiled"
    for o in keep[1:]:
        pinning.pinned_id(o)
    assert ("prog", pid0, 7) not in c
    assert c.get(("prog", "no-pin", 8)) == "other"
    pid0b = pinning.pinned_id(keep[0])
    assert int(pid0b) == int(pid0)
    assert c.get(("prog", pid0b, 7)) is None


_VERIFY = textwrap.dedent("""
    import sys
    import torch.distributed as dist
    sys.path.insert(0, {repo!r})
    import dr_tpu_torch as dt
    from dr_tpu_torch.utils import spmd_guard
    rank = int(sys.argv[1])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    dt.init(["cpu"] * 4)
    v = dt.distributed_vector(64)
    with spmd_guard.guard() as g:
        dt.fill(v, 1.0)
        g.verify()                      # agree
        if rank == 1 and {diverge}:
            dt.iota(v, 0)               # the divergent dispatch
        else:
            dt.fill(v, 2.0)
        try:
            g.verify()
            print("AGREE")
        except spmd_guard.DivergenceError as e:
            print("DIVERGED", e)
    dist.destroy_process_group()
""")


@pytest.mark.parametrize("diverge", [False, True])
def test_verify_across_processes(diverge, tmp_path):
    """``verify()`` over ``torch.distributed`` (gloo, two processes on
    localhost): equal traces agree; one divergent dispatch is reported
    at its index on both processes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "verify.py"
    script.write_text(_VERIFY.format(repo=REPO, port=port, diverge=diverge))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        if diverge:
            assert "DIVERGED" in out and "at index 1" in out, out
            assert "('gen','iota'" in out and "('gen','fill'" in out
        else:
            assert out.strip().endswith("AGREE"), out
