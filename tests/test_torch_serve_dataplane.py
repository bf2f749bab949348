"""dr_tpu_torch's serving data plane (``dr_tpu_torch/serve``: the
shared-memory arena, per-tenant resident containers, weighted-fair
admission) against dr_tpu's.

Mirrors every case of ``tests/test_serve_dataplane.py`` but the router's
(``test_hash_ring_stable_and_bounded_rehash``,
``test_router_fleet_tenant_affinity_and_stats``,
``test_router_dead_replica_rehash_with_story_marker``,
``test_router_route_fault_site_classified`` and
``test_router_subprocess_fleet_churn_and_kill``, which
``tests/test_torch_serve_router.py`` mirrors), on ``dt.init(["cpu"] *
8)`` with ``Server(cpu=True)``.  The
per-tenant rollup case reads the port's own Chrome trace instead of
synthetic events, and ``test_parity_dataplane_*`` hold the arena's and
the queue's behaviour against the JAX package's on the same inputs.
"""

import importlib.util
import os
import socket
import threading
import time

import numpy as np
import pytest

import dr_tpu_torch as dt
from dr_tpu_torch import serve
from dr_tpu_torch.serve import arena as arena_mod
from dr_tpu_torch.serve import protocol
from dr_tpu_torch.serve.queue import AdmissionQueue, Request, parse_weights
from dr_tpu_torch.utils import elastic, faults, resilience
from dr_tpu_torch.utils.env import env_override

P = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X = np.arange(48, dtype=np.float32)
#: comfortably above the default DR_GPU_SERVE_ARENA_MIN_BYTES floor
BIG = np.arange(1 << 15, dtype=np.float32)


@pytest.fixture(autouse=True)
def _fresh():
    dt.init(["cpu"] * P)
    yield
    faults.clear()
    serve.reset()
    elastic.reset()
    dt.obs.arm(False)
    dt.obs.reset()
    dt.final()


@pytest.fixture
def server(tmp_path):
    srv = serve.Server(str(tmp_path / "dp.sock"), cpu=True)
    srv.start()
    yield srv
    srv.stop()


def _client(srv, **kw):
    kw.setdefault("timeout", 60.0)
    return serve.Client(srv.path, **kw)


def _wait_free(ar, limit=5.0):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline and ar.stats()["in_use"]:
        time.sleep(0.02)
    return ar.stats()["in_use"]


# ---------------------------------------------------------------------------
# arena unit behavior (no daemon)
# ---------------------------------------------------------------------------

def test_arena_alloc_release_recycles_and_coalesces():
    ar = serve.Arena(nbytes=1 << 16)
    try:
        a = ar.alloc(1000)
        b = ar.alloc(2000)
        c = ar.alloc(3000)
        assert ar.stats()["slots"] == 3
        ar.release(b)
        ar.release(a)  # adjacent frees coalesce back into one range
        d = ar.alloc(2900)  # fits the coalesced a+b hole
        assert d["offset"] == a["offset"]
        ar.release(c)
        ar.release(d)
        st = ar.stats()
        assert st["in_use"] == 0 and st["slots"] == 0
        e = ar.alloc((1 << 16) - arena_mod.ALIGN)
        ar.release(e)
    finally:
        ar.destroy()


def test_arena_generation_tag_rejects_stale_handles():
    ar = serve.Arena(nbytes=1 << 16)
    try:
        h1 = ar.put(arena_mod.npy_bytes(X))
        ar.release(h1)
        h2 = ar.put(arena_mod.npy_bytes(X * 2))
        with pytest.raises(resilience.ProgramError, match="stale"):
            ar.map(h1)
        with pytest.raises(resilience.ProgramError, match="stale"):
            ar.release(h1)
        np.testing.assert_array_equal(ar.map(h2), X * 2)
        ar.retain(h2)
        ar.release(h2)
        np.testing.assert_array_equal(ar.map(h2), X * 2)
        ar.release(h2)
        assert ar.stats()["in_use"] == 0
    finally:
        ar.destroy()


def test_arena_exhaustion_is_classified_transient():
    ar = serve.Arena(nbytes=1 << 12)
    try:
        ar.alloc(3 << 10)
        with pytest.raises(resilience.TransientBackendError,
                           match="exhausted"):
            ar.alloc(3 << 10)
        assert ar.stats()["exhaustions"] == 1
    finally:
        ar.destroy()


def test_arena_release_owner_frees_wholesale():
    ar = serve.Arena(nbytes=1 << 16)
    try:
        owner = object()
        for _ in range(4):
            ar.alloc(512, owner=owner)
        keep = ar.alloc(512, owner=object())
        assert ar.release_owner(owner) == 4
        assert ar.stats()["slots"] == 1
        ar.release(keep)
    finally:
        ar.destroy()


def test_parity_dataplane_arena_slots_match_the_jax_package():
    """The same alloc / release sequence leaves the same handles, free
    ranges and counters in both packages' arenas."""
    from dr_tpu.serve import arena as jarena
    seq = [("alloc", 1000), ("alloc", 2000), ("alloc", 3000),
           ("release", 1), ("release", 0), ("alloc", 2900),
           ("alloc", 100), ("release", 2), ("alloc", 5000)]
    outs = []
    for mod in (jarena, arena_mod):
        ar = mod.Arena(nbytes=1 << 16)
        try:
            handles, log = [], []
            for what, arg in seq:
                if what == "alloc":
                    h = ar.alloc(arg)
                    handles.append(h)
                    log.append(dict(h))
                else:
                    ar.release(handles[arg])
            log.append(list(ar._free))
            log.append(ar.stats())
            outs.append(log)
        finally:
            ar.destroy()
    assert outs[0] == outs[1]
    assert jarena.npy_bytes(X) == arena_mod.npy_bytes(X)


# ---------------------------------------------------------------------------
# arena over the wire
# ---------------------------------------------------------------------------

def test_arena_wire_roundtrip_and_reply_path(server):
    with _client(server) as c:
        got = c.scale(BIG, a=2.0, b=-1.0)
        np.testing.assert_allclose(got, BIG * 2.0 - 1.0, rtol=1e-6)
        assert c.arena_active(), "big payload should attach the arena"
        st = c.stats()
        assert st["arena"]["allocs"] >= 2
        assert st["obs"]["counters"]["serve.arena.maps"] >= 1
        s = c.dot(BIG, BIG)
        assert abs(s - float((BIG.astype(np.float64) ** 2).sum())) \
            < abs(s) * 1e-5 + 1.0
        np.testing.assert_allclose(c.scale(X, a=3.0), X * 3.0, rtol=1e-6)
    assert _wait_free(server._arena) == 0


def test_arena_lease_cache_reuses_slots_across_requests(server):
    with _client(server) as c:
        for r in range(6):
            got = c.scale(BIG, a=1.0 + r)
            np.testing.assert_allclose(got, BIG * (1.0 + r), rtol=1e-6)
        assert c.arena_active()
        assert c.lease_hits >= 5, (c.lease_hits, c.lease_misses)
        assert c.lease_misses == 1
        allocs_now = server._arena.stats()["allocs"]
        c.scale(BIG, a=9.0)
        # one more round trip costs exactly the REPLY slot
        assert server._arena.stats()["allocs"] == allocs_now + 1
    assert _wait_free(server._arena) == 0


def test_arena_lease_cache_differs_by_shape_and_caps(server):
    small_big = np.arange(1 << 14, dtype=np.float32)  # still >= floor
    with _client(server) as c:
        c.scale(BIG, a=1.0)
        c.scale(small_big, a=1.0)
        hits0 = c.lease_hits
        c.scale(BIG, a=2.0)
        c.scale(small_big, a=2.0)
        assert c.lease_hits == hits0 + 2
        assert c.lease_misses == 2  # one per distinct capacity


def test_arena_lease_cache_disabled_by_env(tmp_path):
    with env_override(DR_GPU_SERVE_LEASE_CACHE="0"):
        srv = serve.Server(str(tmp_path / "nolease.sock"), cpu=True).start()
        try:
            with _client(srv) as c:
                for r in range(3):
                    np.testing.assert_allclose(
                        c.scale(BIG, a=1.0 + r), BIG * (1.0 + r),
                        rtol=1e-6)
                assert c.lease_hits == 0
                assert c.lease_misses == 3
        finally:
            srv.stop()


def test_arena_lease_cache_drops_on_reconnect(tmp_path):
    srv = serve.Server(str(tmp_path / "relse.sock"), cpu=True).start()
    try:
        with _client(srv, retries=3) as c:
            c.scale(BIG, a=1.0)
            c.scale(BIG, a=2.0)
            assert c.lease_hits == 1
            c._invalidate("test: simulated desync")
            assert c._lease_cache == {}
            np.testing.assert_allclose(c.scale(BIG, a=3.0), BIG * 3.0,
                                       rtol=1e-6)
            assert c.lease_misses >= 2
    finally:
        srv.stop()


def test_arena_disabled_daemon_serves_inline(tmp_path):
    with env_override(DR_GPU_SERVE_ARENA="0"):
        srv = serve.Server(str(tmp_path / "noar.sock"), cpu=True).start()
    try:
        with serve.Client(srv.path, timeout=60.0) as c:
            assert "arena" not in c.ping()
            np.testing.assert_allclose(c.scale(BIG, a=2.0), BIG * 2.0,
                                       rtol=1e-6)
            assert not c.arena_active()
    finally:
        srv.stop()


def test_arena_unavailable_is_counted_and_shown(tmp_path, monkeypatch):
    """A host without usable shared memory: the daemon serves on the
    inline wire, counts the fallback, and says so in stats()."""
    def boom(*a, **kw):
        raise OSError("no /dev/shm")

    monkeypatch.setattr(arena_mod, "Arena", boom)
    f0 = arena_mod.fallbacks()
    srv = serve.Server(str(tmp_path / "nosh.sock"), cpu=True).start()
    try:
        with serve.Client(srv.path, timeout=60.0) as c:
            np.testing.assert_allclose(c.scale(BIG, a=2.0), BIG * 2.0,
                                       rtol=1e-6)
            assert not c.arena_active()
            st = c.stats()
        assert "no /dev/shm" in st["arena_unavailable"]
        assert st["arena_fallbacks"] == f0 + 1
        assert any("arena unavailable" in n for n in st["notes"])
    finally:
        srv.stop()


def test_arena_exhausted_falls_back_to_inline_wire(tmp_path):
    with env_override(DR_GPU_SERVE_ARENA_BYTES=str(1 << 12)):
        srv = serve.Server(str(tmp_path / "tiny.sock"), cpu=True).start()
    try:
        with serve.Client(srv.path, timeout=60.0) as c:
            np.testing.assert_allclose(c.scale(BIG, a=2.0), BIG * 2.0,
                                       rtol=1e-6)
            st = c.stats()
            assert st["arena"]["exhaustions"] >= 1
            assert st["obs"]["counters"].get("serve.arena.fallbacks",
                                             0) >= 1
    finally:
        srv.stop()


def test_arena_stale_wire_handle_classified(server):
    with _client(server) as c:
        c.scale(BIG, a=1.0)
        raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        raw.connect(server.path)
        try:
            protocol.send_frame(
                raw, {"op": "scale", "params": {"a": 1.0}, "id": 1,
                      "arena": [{"slot": 999999, "generation": 3,
                                 "len": 64}]})
            hdr, _ = protocol.recv_frame(raw)
            assert hdr["ok"] is False
            assert hdr["error"]["cls"] == "ProgramError"
            assert hdr["error"]["site"] == "arena.map"
        finally:
            raw.close()
        assert abs(c.reduce(X) - X.sum()) < 1e-3


def test_arena_fault_sites_drive_classified_or_fallback(server):
    with _client(server) as c:
        c.scale(BIG, a=1.0)  # attach
        with faults.injected("arena.map", "transient") as sp:
            np.testing.assert_allclose(c.scale(BIG, a=2.0), BIG * 2.0,
                                       rtol=1e-6)
            assert sp.fired == 1
        with faults.injected("arena.map", "program") as sp:
            with pytest.raises(resilience.ProgramError):
                c.scale(BIG, a=2.0)
            assert sp.fired == 1
        np.testing.assert_allclose(c.scale(BIG, a=4.0), BIG * 4.0,
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", ["transient", "program"])
def test_arena_release_fault_site_classified(server, kind):
    """``arena.release`` fires at the piggybacked reply release: the
    request is refused classified at that site, and the connection
    serves on."""
    with _client(server, arena=True) as c:
        c.scale(BIG, a=1.0)  # the reply rides a slot owed back
        assert c._pending_release
        with faults.injected("arena.release", kind) as sp:
            with pytest.raises(resilience.ResilienceError) as ei:
                c.reduce(X)
            assert sp.fired == 1
        assert ei.value.site == "arena.release"
        assert abs(c.reduce(X) - X.sum()) < 1e-3


def test_arena_concurrent_stress_slot_recycling(tmp_path):
    with env_override(DR_GPU_SERVE_ARENA_BYTES=str(1 << 20)):
        srv = serve.Server(str(tmp_path / "stress.sock"), queue_depth=256,
                           tenant_cap=64, cpu=True).start()
    errs = []
    try:
        with serve.Client(srv.path, timeout=120.0) as c:
            c.scale(BIG, a=1.0)

        def worker(i):
            try:
                rng = np.random.default_rng(i)
                with serve.Client(srv.path, timeout=120.0,
                                  tenant=f"w{i}") as c:
                    for r in range(6):
                        x = rng.standard_normal(1 << 15) \
                            .astype(np.float32)
                        got = c.scale(x, a=2.0, b=float(r))
                        np.testing.assert_allclose(got, x * 2.0 + r,
                                                   rtol=1e-6)
            except Exception as e:  # pragma: no cover - failure path
                errs.append(repr(e))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not errs, errs[:3]
        assert srv._arena.stats()["allocs"] >= 6
        assert _wait_free(srv._arena) == 0, \
            "slots leaked after client disconnects"
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# resident container cache
# ---------------------------------------------------------------------------

def test_resident_put_ref_get_drop_roundtrip(server):
    with _client(server) as c:
        r = c.put("feat", X)
        assert r["bytes"] == X.nbytes and r["cached"] is False
        assert abs(c.reduce(serve.Ref("feat")) - X.sum()) < 1e-3
        np.testing.assert_allclose(c.scale(serve.Ref("feat"), a=2.0),
                                   X * 2.0, rtol=1e-6)
        np.testing.assert_array_equal(c.get("feat"), X)
        assert abs(c.dot(serve.Ref("feat"), X)
                   - float((X.astype(np.float64) ** 2).sum())) < 1e-2
        assert c.put("feat", X)["cached"] is True
        r3 = c.put("feat", X * 3)
        assert r3["cached"] is False
        np.testing.assert_allclose(c.get("feat"), X * 3, rtol=1e-6)
        assert c.drop("feat")["dropped"] is True
        assert c.drop("feat")["dropped"] is False
        with pytest.raises(resilience.ProgramError, match="no resident"):
            c.reduce(serve.Ref("feat"))
        st = c.stats()["resident"]
        assert st["puts"] == 2 and st["put_hits"] == 1


def test_resident_is_tenant_scoped(server):
    with _client(server, tenant="alice") as a, \
            _client(server, tenant="bob") as b:
        a.put("secret", X)
        with pytest.raises(resilience.ProgramError, match="no resident"):
            b.get("secret")
        b.put("secret", X * 2)
        np.testing.assert_array_equal(a.get("secret"), X)
        np.testing.assert_allclose(b.get("secret"), X * 2, rtol=1e-6)


def test_resident_lru_bytes_budget_evicts(tmp_path):
    n = 1 << 10  # 4 KiB per value
    with env_override(DR_GPU_SERVE_RESIDENT_BYTES=str(3 * n * 4)):
        srv = serve.Server(str(tmp_path / "lru.sock"), cpu=True).start()
    try:
        with serve.Client(srv.path, timeout=60.0) as c:
            vals = {}
            for i in range(4):
                vals[i] = np.full(n, float(i), np.float32)
                c.put(f"v{i}", vals[i])
            with pytest.raises(resilience.ProgramError,
                               match="no resident"):
                c.get("v0")
            np.testing.assert_array_equal(c.get("v3"), vals[3])
            st = c.stats()["resident"]
            assert st["evictions"] == 1 and st["entries"] == 3
            assert st["bytes"] <= 3 * n * 4
            c.get("v1")
            c.put("v4", np.full(n, 9.0, np.float32))
            np.testing.assert_array_equal(c.get("v1"), vals[1])
            with pytest.raises(resilience.ProgramError,
                               match="no resident"):
                c.get("v2")
            with pytest.raises(resilience.ProgramError, match="budget"):
                c.put("huge", np.zeros(4 * n, np.float32))
            np.testing.assert_array_equal(c.get("v1"), vals[1])
    finally:
        srv.stop()


def test_resident_content_tags_match_the_jax_package():
    from dr_tpu.serve import resident as jresident
    from dr_tpu_torch.serve import resident as tresident
    for a in (X, X * 3, np.zeros(7, np.float32)):
        assert jresident._content_tag(a) == tresident._content_tag(a)


def test_resident_rides_elastic_shrink_poison_classified(server):
    with _client(server) as c:
        c.put("state", X)
        assert abs(c.reduce(serve.Ref("state")) - X.sum()) < 1e-3
        try:
            elastic.rescue_session(resilience.DeviceLostError(
                "dataplane: simulated device loss", rank=P - 1))
            with pytest.raises(resilience.DeviceLostError):
                c.get("state")
            with pytest.raises(resilience.DeviceLostError):
                c.reduce(serve.Ref("state"))
            c.put("state", X * 2)
            assert abs(c.reduce(serve.Ref("state")) - 2 * X.sum()) \
                < 1e-3
        finally:
            elastic.grow_session(reason="dataplane test: restore mesh")
        assert dt.nprocs() == P
        assert abs(c.reduce(serve.Ref("state")) - 2 * X.sum()) < 1e-3


# ---------------------------------------------------------------------------
# weighted-fair admission (DRR)
# ---------------------------------------------------------------------------

def _reqs(tenant, n):
    return [Request("scale", {}, [X], tenant=tenant) for _ in range(n)]


def test_drr_interleaves_tenants_fifo_within():
    q = AdmissionQueue(64, 64, weights={})
    heavy = _reqs("heavy", 6)
    light = _reqs("light", 2)
    for r in heavy + light:
        q.submit(r)
    live, dropped = q.take_batch(8, 0.0)
    assert not dropped
    order = [r.tenant for r in live]
    assert order[:4] == ["heavy", "light", "heavy", "light"]
    assert order[4:] == ["heavy"] * 4
    assert [r is h for r, h in zip(
        [x for x in live if x.tenant == "heavy"], heavy)] == [True] * 6


def test_drr_weights_shift_the_share():
    q = AdmissionQueue(64, 64, weights={"gold": 3.0})
    for r in _reqs("free", 6) + _reqs("gold", 6):
        q.submit(r)
    live, _ = q.take_batch(8, 0.0)
    order = [r.tenant for r in live]
    assert order.count("gold") == 6
    assert order[:4].count("free") == 1
    live2, _ = q.take_batch(8, 0.0)
    assert [r.tenant for r in live2] == ["free"] * 4


def test_drr_fractional_weights_bank_across_turns():
    q = AdmissionQueue(64, 64, weights={"slow": 0.5})
    for r in _reqs("slow", 2) + _reqs("fast", 2):
        q.submit(r)
    live, _ = q.take_batch(10, 0.0)
    order = [r.tenant for r in live]
    assert order.count("slow") == 2 and order.count("fast") == 2
    assert order[0] == "fast" or order[1] == "fast"


@pytest.mark.parametrize("weights,plan", [
    ({}, [("a", 5), ("b", 3), ("c", 1)]),
    ({"a": 2.0, "c": 0.5}, [("c", 4), ("a", 6), ("b", 2)]),
    ({"b": 0.25}, [("b", 3), ("a", 3)]),
])
def test_parity_dataplane_drr_order_matches_the_jax_package(weights, plan):
    """The same submissions pop in the same tenant order, batch by
    batch, from both packages' queues."""
    from dr_tpu.serve.queue import AdmissionQueue as JQ
    from dr_tpu.serve.queue import Request as JR
    orders = []
    for Q, R in ((JQ, JR), (AdmissionQueue, Request)):
        q = Q(64, 64, weights=dict(weights))
        for tenant, n in plan:
            for i in range(n):
                q.submit(R("scale", {"i": i}, [X], tenant=tenant))
        out = []
        while len(q):
            live, _ = q.take_batch(3, 0.0)
            out.append([(r.tenant, r.params["i"]) for r in live])
        orders.append(out)
    assert orders[0] == orders[1]


def test_parse_weights_tolerant():
    from dr_tpu.serve.queue import parse_weights as jparse
    assert parse_weights("a:2,b:0.5") == {"a": 2.0, "b": 0.5}
    assert parse_weights(" gold : 4 ; free : 1 ") == \
        {"gold": 4.0, "free": 1.0}
    w = parse_weights("bad,x:oops,ok:3,z:-1")
    assert w["ok"] == 3.0 and w["z"] == pytest.approx(1e-3)
    assert "bad" not in w and "x" not in w
    assert parse_weights("") == {}
    assert jparse("bad,x:oops,ok:3,z:-1") == w


def test_tenant_weights_read_from_the_port_variable(monkeypatch):
    monkeypatch.setenv("DR_TPU_SERVE_TENANT_WEIGHTS", "gold:9")
    assert AdmissionQueue(4, 4).weights == {}
    monkeypatch.setenv("DR_GPU_SERVE_TENANT_WEIGHTS", "gold:4")
    assert AdmissionQueue(4, 4).weights == {"gold": 4.0}


def test_starvation_regression_light_tenant_bounded(tmp_path):
    srv = serve.Server(str(tmp_path / "fair.sock"), batch_max=2,
                       tenant_cap=16, batch_window=0.0, cpu=True).start()
    try:
        with serve.Client(srv.path, timeout=60.0) as c:
            c.scale(X, a=1.0)
        srv.hold()
        done = []

        def worker(tenant):
            with serve.Client(srv.path, timeout=60.0, tenant=tenant) as c:
                c.scale(X, a=2.0)
                done.append(tenant)

        threads = [threading.Thread(target=worker, args=("heavy",))
                   for _ in range(10)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10.0
        while len(srv._queue) < 10 and time.monotonic() < deadline:
            time.sleep(0.01)
        lt = threading.Thread(target=worker, args=("light",))
        lt.start()
        while len(srv._queue) < 11 and time.monotonic() < deadline:
            time.sleep(0.01)
        srv.release()
        for t in threads + [lt]:
            t.join(timeout=60.0)
        assert len(done) == 11
        hists = srv.stats()["obs"]["histograms"]
        light = hists["serve.queue_wait_ms.t.light"]
        heavy = hists["serve.queue_wait_ms.t.heavy"]
        assert light["count"] == 1 and heavy["count"] == 10
        assert light["max"] < heavy["max"], (light, heavy)
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# trace_view per-tenant rollup
# ---------------------------------------------------------------------------

def test_trace_view_per_tenant_rollup(tmp_path, capsys):
    """The port's own daemon trace (``dt.obs``'s Chrome export) rolls up
    per tenant in ``tools/trace_view.py``."""
    spec = importlib.util.spec_from_file_location(
        "trace_view", os.path.join(REPO, "tools", "trace_view.py"))
    tv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tv)
    dt.obs.reset()
    dt.obs.arm(True)
    srv = serve.Server(str(tmp_path / "tv.sock"), cpu=True).start()
    try:
        for tenant, n in (("heavy", 3), ("light", 2)):
            with serve.Client(srv.path, timeout=60.0, tenant=tenant) as c:
                for _ in range(n):
                    c.reduce(X)
    finally:
        srv.stop()
    events = dt.obs.chrome_trace()["traceEvents"]
    tv.summarize(events)
    out = capsys.readouterr().out
    assert "per-tenant rollup" in out
    heavy = next(ln for ln in out.splitlines()
                 if ln.strip().startswith("heavy"))
    light = next(ln for ln in out.splitlines()
                 if ln.strip().startswith("light"))
    assert " 3 " in heavy and " 2 " in light
