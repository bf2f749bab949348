"""dr_tpu_torch's serving daemon (``dr_tpu_torch/serve``) against
dr_tpu's: lifecycle edges, admission control, batching, the classified
failure matrix, and parity of every ``OPS`` entry.

Mirrors every case of ``tests/test_serve.py`` on ``dt.init(["cpu"] * 8)``
with ``Server(cpu=True)``.  Where the port must differ:

* ``test_serve_relay_death_degrades_to_cpu_route`` becomes
  ``test_serve_flush_relay_down_fails_classified_same_ranks``: the port
  has no CPU route to degrade to, so ``serve.flush:relay_down`` fails
  that one request classified and the next succeeds on the same ranks,
  with ``restarts == 0``;
* the subprocess daemon runs ``python -m dr_tpu_torch.serve --cpu``;
  without ``--cpu``, on a box with no card, it prints the classified
  error line and exits 1 (``test_serve_subprocess_device_route_needs_
  cuda``).

The parity cases send the same numpy inputs, made from a seed, through
a JAX ``dr_tpu.serve.Server`` and a port ``Server``, each through its
own client: data movement, sort, integers and min/max bit for bit;
float sums and scans within the stated tolerances.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import dr_tpu_torch as dt
from dr_tpu_torch import serve
from dr_tpu_torch.serve import protocol
from dr_tpu_torch.utils import elastic, faults, resilience
from dr_tpu_torch.utils.env import env_int

P = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X = np.arange(48, dtype=np.float32)


@pytest.fixture(autouse=True)
def _fresh():
    dt.init(["cpu"] * P)
    yield
    faults.clear()
    serve.reset()
    elastic.reset()
    dt.final()


@pytest.fixture
def server(tmp_path):
    srv = serve.Server(str(tmp_path / "d.sock"), cpu=True)
    srv.start()
    yield srv
    srv.stop()


def _client(srv, **kw):
    kw.setdefault("timeout", 60.0)
    return serve.Client(srv.path, **kw)


def _wait_queued(srv, n, limit=10.0):
    deadline = time.monotonic() + limit
    while len(srv._queue) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    return len(srv._queue)


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------

def test_protocol_roundtrip():
    a, b = socket.socketpair()
    try:
        arrays = [np.arange(5, dtype=np.float32),
                  np.ones((2, 3), np.int32)]
        protocol.send_frame(a, {"op": "x", "params": {"k": 1}}, arrays)
        hdr, got = protocol.recv_frame(b)
        assert hdr["op"] == "x" and hdr["params"] == {"k": 1}
        for want, have in zip(arrays, got):
            np.testing.assert_array_equal(want, have)
            assert want.dtype == have.dtype
        a.close()
        assert protocol.recv_frame(b) == (None, None)
    finally:
        b.close()


def test_protocol_frames_match_the_jax_package():
    """The same header and payloads make the same bytes in both
    packages, and each reads the other's frame."""
    from dr_tpu.serve import protocol as jprotocol
    arrays = [np.arange(7, dtype=np.float32), np.ones(3, np.int32)]
    got = {}
    for name, mod in (("jax", jprotocol), ("port", protocol)):
        a, b = socket.socketpair()
        try:
            mod.send_frame(a, {"op": "y", "id": 3}, arrays)
            a.close()
            got[name] = b.recv(1 << 16)
        finally:
            b.close()
    assert got["jax"] == got["port"]
    assert jprotocol.MAX_HEADER == protocol.MAX_HEADER
    assert jprotocol.MAX_PAYLOAD == protocol.MAX_PAYLOAD == 1 << 28
    a, b = socket.socketpair()
    try:
        jprotocol.send_frame(a, {"op": "z"}, arrays)
        hdr, arrs = protocol.recv_frame(b)
        assert hdr["op"] == "z"
        np.testing.assert_array_equal(arrs[1], arrays[1])
    finally:
        a.close()
        b.close()


def test_protocol_torn_frame_classified():
    a, b = socket.socketpair()
    try:
        a.sendall(b"\x00\x00\x00\x10partial")  # 16-byte header, 7 sent
        a.close()
        with pytest.raises(resilience.TransientBackendError,
                           match="torn"):
            protocol.recv_frame(b)
    finally:
        b.close()


def test_protocol_malformed_and_oversized_classified():
    a, b = socket.socketpair()
    try:
        a.sendall(b"\xff\xff\xff\xff")  # absurd header length
        with pytest.raises(resilience.ProgramError):
            protocol.recv_frame(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        bad = b"not json!"
        a.sendall(struct.pack(">I", len(bad)) + bad)
        with pytest.raises(resilience.ProgramError, match="malformed"):
            protocol.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_protocol_error_header_roundtrip():
    hdr = protocol.error_header(
        resilience.ServerOverloaded("queue full", site="serve.request"))
    assert hdr["ok"] is False
    with pytest.raises(resilience.ServerOverloaded, match="queue full"):
        protocol.raise_error(hdr)
    with pytest.raises(resilience.ProgramError):
        protocol.raise_error({"error": {"cls": "NoSuchClass",
                                        "message": "m"}})


# ---------------------------------------------------------------------------
# request/reply correctness
# ---------------------------------------------------------------------------

def test_serve_ops_roundtrip(server):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(33).astype(np.float32)
    y = rng.standard_normal(33).astype(np.float32)
    with _client(server) as c:
        assert c.ping()["pong"] is True
        np.testing.assert_allclose(c.scale(x, a=2.0, b=-1.0),
                                   x * 2.0 - 1.0, rtol=1e-6)
        assert abs(c.reduce(x) - x.astype(np.float64).sum()) < 1e-3
        assert abs(c.dot(x, y) - (x.astype(np.float64) * y).sum()) < 1e-2
        np.testing.assert_allclose(c.scan(x),
                                   np.cumsum(x, dtype=np.float32),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(c.sort(x), np.sort(x))
        np.testing.assert_allclose(c.fill(16, 2.5),
                                   np.full(16, 2.5, np.float32))
        st = c.stats()
        assert st["requests"] >= 6 and st["errors"] == 0
        assert st["route"] == {"requested": "cpu", "current": "cpu"}


def test_serve_request_errors_classified_daemon_survives(server):
    with _client(server) as c:
        with pytest.raises(resilience.ProgramError, match="unknown op"):
            c.request("no_such_op")
        with pytest.raises(resilience.ProgramError, match="array"):
            c.request("reduce")  # missing operand
        with pytest.raises(resilience.ProgramError, match="params.n"):
            c.fill(0)
        with pytest.raises(resilience.ProgramError, match="share a"):
            c.dot(X, X[:5])
        assert abs(c.reduce(X) - X.sum()) < 1e-3
    assert server.stats()["errors"] == 4


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------

def test_serve_batching_coalesces_one_flush(server):
    with _client(server) as c:
        c.scale(X, a=1.0)
    f0 = server.stats()["flushes"]
    server.hold()
    results = {}

    def worker(i):
        with _client(server) as c:
            results[i] = c.scale(X, a=float(i + 1))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    assert _wait_queued(server, 4) == 4, "requests did not queue"
    server.release()
    for t in threads:
        t.join()
    for i in range(4):
        np.testing.assert_allclose(results[i], X * (i + 1), rtol=1e-6)
    st = server.stats()
    # all four concurrent requests coalesced into ONE deferred flush
    assert st["flushes"] == f0 + 1
    assert st["batch_hw"] == 4
    # CPU ranks always run a plan's runs in order
    assert st["plan"]["graph_captures"] == 0
    assert st["plan"]["eager_runs"] >= 1


def test_serve_nonfusible_runs_solo_in_batch(server):
    server.hold()
    rng = np.random.default_rng(3)
    src = rng.standard_normal(40).astype(np.float32)
    results = {}

    def w_sort():
        with _client(server) as c:
            results["sort"] = c.sort(src)

    def w_scale():
        with _client(server) as c:
            results["scale"] = c.scale(src, a=3.0)

    threads = [threading.Thread(target=w) for w in (w_sort, w_scale)]
    for t in threads:
        t.start()
    _wait_queued(server, 2)
    server.release()
    for t in threads:
        t.join()
    np.testing.assert_array_equal(results["sort"], np.sort(src))
    np.testing.assert_allclose(results["scale"], src * 3.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_serve_overload_rejected_classified(tmp_path):
    srv = serve.Server(str(tmp_path / "o.sock"), queue_depth=2,
                       tenant_cap=8, cpu=True).start()
    try:
        srv.hold()
        errs, oks = [], []

        def worker(i):
            try:
                with serve.Client(srv.path, timeout=30.0,
                                  tenant=f"t{i}") as c:
                    oks.append(c.reduce(X))
            except resilience.ResilienceError as e:
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10.0
        while len(errs) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        srv.release()
        for t in threads:
            t.join()
        assert len(errs) == 2 and len(oks) == 2
        assert all(isinstance(e, resilience.ServerOverloaded)
                   for e in errs), errs
        assert srv.stats()["rejected"] == 2
    finally:
        srv.stop()


def test_serve_tenant_cap_isolates_tenants(tmp_path):
    srv = serve.Server(str(tmp_path / "t.sock"), queue_depth=16,
                       tenant_cap=1, cpu=True).start()
    try:
        srv.hold()
        errs, oks = [], []

        def worker(tenant):
            try:
                with serve.Client(srv.path, timeout=30.0,
                                  tenant=tenant) as c:
                    oks.append(c.reduce(X))
            except resilience.ServerOverloaded as e:
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in ("hog", "hog", "other")]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10.0
        while len(errs) + len(srv._queue) < 3 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        srv.release()
        for t in threads:
            t.join()
        assert len(errs) == 1 and "hog" in str(errs[0])
        assert len(oks) == 2
    finally:
        srv.stop()


def test_serve_deadline_expired_requests_shed(server):
    server.hold()
    box = {}

    def worker():
        try:
            with _client(server, timeout=30.0) as c:
                box["r"] = c.reduce(X, deadline_s=0.05)
        except resilience.ResilienceError as e:
            box["e"] = e

    t = threading.Thread(target=worker)
    t.start()
    time.sleep(0.4)  # let the deadline lapse while queued
    server.release()
    t.join()
    assert isinstance(box.get("e"), resilience.DeadlineExpired), box
    assert "shed" in str(box["e"])
    assert server.stats()["shed"] == 1


# ---------------------------------------------------------------------------
# daemon lifecycle edges
# ---------------------------------------------------------------------------

def test_serve_stale_socket_takeover(tmp_path):
    path = str(tmp_path / "stale.sock")
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(path)  # a daemon died here without unlinking
    s.close()
    assert os.path.exists(path)
    srv = serve.Server(path, cpu=True).start()
    try:
        with serve.Client(path, timeout=30.0) as c:
            assert c.ping()["pong"] is True
        assert any("stale socket" in n for n in srv.stats()["notes"])
    finally:
        srv.stop()


def test_serve_double_daemon_refused_classified(server):
    newcomer = serve.Server(server.path, cpu=True)
    with pytest.raises(resilience.ProgramError,
                       match="already serving"):
        newcomer.start()
    # stopping the refused newcomer must NOT unlink the live socket
    newcomer.stop()
    assert os.path.exists(server.path)
    with _client(server) as c:
        assert abs(c.reduce(X) - X.sum()) < 1e-3


def test_serve_client_crash_mid_request_cancels_cleanly(server):
    server.hold()
    raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    raw.connect(server.path)
    protocol.send_frame(raw, {"op": "reduce", "params": {},
                              "tenant": "crash"}, [X])
    _wait_queued(server, 1)
    raw.close()  # crash before the reply
    time.sleep(0.1)
    server.release()
    with _client(server) as c:
        assert abs(c.reduce(X) - X.sum()) < 1e-3
    assert server.stats()["cancelled"] == 1


def test_serve_truncated_frame_drops_connection_only(server):
    raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    raw.connect(server.path)
    raw.sendall(b"\x00\x00\x01\x00only-a-few-bytes")
    raw.close()
    time.sleep(0.2)
    with _client(server) as c:
        assert c.ping()["pong"] is True


def test_serve_default_socket_differs_from_the_jax_package(monkeypatch):
    from dr_tpu.serve import daemon as jdaemon
    monkeypatch.delenv("DR_GPU_SERVE_SOCKET", raising=False)
    monkeypatch.delenv("DR_TPU_SERVE_SOCKET", raising=False)
    assert serve.default_socket_path() != jdaemon.default_socket_path()
    monkeypatch.setenv("DR_GPU_SERVE_SOCKET", "/tmp/x-gpu.sock")
    assert serve.default_socket_path() == "/tmp/x-gpu.sock"


def test_serve_device_claim_without_cuda_fails_classified(tmp_path):
    """A daemon not asked for the CPU never serves on it: without a card
    its start fails classified and releases the socket."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the device claim succeeds")
    path = str(tmp_path / "dev.sock")
    dt.final()
    srv = serve.Server(path)
    with pytest.raises(resilience.ProgramError, match="no CUDA device"):
        srv.start()
    assert not os.path.exists(path)
    # a CPU runtime already initialised is not the requested route
    dt.init(["cpu"] * 2)
    with pytest.raises(resilience.ProgramError) as ei:
        serve.Server(path).start()
    assert ei.value.site == "runtime.init"
    assert not os.path.exists(path)


def test_serve_claim_keeps_the_runtime_of_the_requested_route(tmp_path):
    rt = dt.runtime()
    srv = serve.Server(str(tmp_path / "k.sock"), cpu=True).start()
    try:
        assert dt.runtime() is rt and dt.nprocs() == P
        assert srv.devices == rt.devices
    finally:
        srv.stop()
    dt.final()
    srv = serve.Server(str(tmp_path / "k1.sock"), cpu=True).start()
    try:  # nothing initialised: one CPU rank
        assert dt.nprocs() == 1
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# failure injection (the serve.* sites)
# ---------------------------------------------------------------------------

def test_serve_flush_transient_recovers_in_process(server):
    with faults.injected("serve.flush", "transient") as sp:
        with _client(server) as c:
            assert abs(c.reduce(X) - X.sum()) < 1e-3
        assert sp.fired == 1


def test_serve_flush_program_fault_isolated_per_request(server):
    with _client(server) as c:
        c.scale(X, a=1.0)
    server.hold()
    results, errs = {}, []

    def worker(i):
        try:
            with _client(server) as c:
                results[i] = c.scale(X, a=float(i + 2))
        except resilience.ResilienceError as e:
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    _wait_queued(server, 2)
    with faults.injected("serve.flush", "program") as sp:
        server.release()
        for t in threads:
            t.join()
        assert sp.fired == 1
    assert not errs, errs
    for i in range(2):
        np.testing.assert_allclose(results[i], X * (i + 2), rtol=1e-6)


def test_serve_flush_relay_down_fails_classified_same_ranks(server):
    """relay_down at the flush: no CPU route to move to — that request
    fails classified, the next succeeds on the same ranks, and nothing
    restarted."""
    devices = list(server.devices)
    with _client(server) as c:
        with faults.injected("serve.flush", "relay_down") as sp:
            with pytest.raises(resilience.RelayDownError):
                c.reduce(X)
            assert sp.fired == 1
        assert abs(c.reduce(X) - X.sum()) < 1e-3
    st = server.stats()
    assert st["restarts"] == 0 and st["degraded"] is None
    assert st["route"] == {"requested": "cpu", "current": "cpu"}
    assert server.devices == devices and dt.nprocs() == P
    assert resilience.session_story() is None


def test_serve_flush_deadline_fails_classified_no_replay(tmp_path):
    """A flush past its deadline fails classified and is never
    replayed; while its abandoned worker still runs, the next batch is
    held and then fails classified, never launched beside it, and
    stop() drops no resident under it."""
    srv = serve.Server(str(tmp_path / "dl.sock"), cpu=True,
                       flush_deadline=0.2).start()
    orig = serve.OPS["reduce"].handler
    release, entered = threading.Event(), threading.Event()
    lock = threading.Lock()
    calls, live, overlap = [], [0], []

    def slow(req):
        with lock:
            calls.append(1)
            live[0] += 1
            overlap.append(live[0])
        try:
            if len(calls) == 1:
                entered.set()
                release.wait(10.0)  # the abandoned worker
            return orig(req)
        finally:
            with lock:
                live[0] -= 1

    serve.OPS["reduce"].handler = slow
    try:
        with _client(srv) as c:
            with pytest.raises(resilience.DeadlineExpired):
                c.reduce(X)
            assert entered.wait(5.0)
            # at once, while the abandoned worker still runs
            with pytest.raises(resilience.DeadlineExpired,
                               match="abandoned"):
                c.reduce(X)
            assert calls == [1]  # held, never launched, never replayed
            release.set()
            assert abs(c.reduce(X) - X.sum()) < 1e-3
        assert calls == [1, 1] and max(overlap) == 1
        assert srv.stats()["restarts"] == 0
    finally:
        release.set()
        serve.OPS["reduce"].handler = orig
        srv.stop()


def test_serve_stop_waits_for_an_abandoned_flush(tmp_path):
    """stop() drops the residents only once an abandoned flush's worker
    has ended: it may be capturing a graph over their rows."""
    srv = serve.Server(str(tmp_path / "st.sock"), cpu=True,
                       flush_deadline=0.2).start()
    orig = serve.OPS["reduce"].handler
    release, live = threading.Event(), threading.Event()
    cleared_live = []
    clear = srv._resident.clear

    def slow(req):
        live.set()
        try:
            release.wait(10.0)
            return orig(req)
        finally:
            live.clear()

    def noted_clear():
        cleared_live.append(live.is_set())
        clear()

    srv._resident.clear = noted_clear
    try:
        with _client(srv) as c:
            c.put("x", X)
            serve.OPS["reduce"].handler = slow
            with pytest.raises(resilience.DeadlineExpired):
                c.reduce(serve.Ref("x"))
    finally:
        serve.OPS["reduce"].handler = orig
    assert live.wait(5.0)
    threading.Timer(1.0, release.set).start()
    srv.flush_deadline = 10.0
    srv.stop()
    assert cleared_live == [False]
    assert srv._resident.stats()["entries"] == 0


def test_serve_accept_fault_drops_connection_keeps_serving(server):
    with faults.injected("serve.accept", "transient") as sp:
        with pytest.raises(resilience.ResilienceError):
            with _client(server) as c:
                c.ping()
        assert sp.fired == 1
    assert server.stats()["accept_drops"] == 1
    with _client(server) as c:
        assert c.ping()["pong"] is True


def test_serve_request_fault_serialized_back(server):
    with _client(server) as c:
        with faults.injected("serve.request", "oom") as sp:
            with pytest.raises(resilience.DeviceOOM):
                c.reduce(X)
            assert sp.fired == 1
        assert abs(c.reduce(X) - X.sum()) < 1e-3


def test_serve_story_markers_cleared_by_reset(server):
    server._mark_degraded("serve: synthetic")
    story = resilience.session_story()
    assert story is not None and story["serve"]["reason"] == \
        "serve: synthetic" and story["reason"] == "serve: synthetic"
    serve.reset()
    assert resilience.session_story() is None


# ---------------------------------------------------------------------------
# concurrency with the host thread's own plans
# ---------------------------------------------------------------------------

def _tl_scale(x, c):
    return x * c


def test_serve_plans_are_thread_local(server):
    src = np.arange(64, dtype=np.float32)
    v = dt.distributed_vector.from_array(src)
    box = {}

    def worker():
        with _client(server) as c:
            box["r"] = c.scale(X, a=5.0)

    with dt.deferred() as p:
        dt.fill(v, 2.0)
        t = threading.Thread(target=worker)
        t.start()
        t.join()  # the daemon flushed ITS plan while ours is open
        dt.for_each(v, _tl_scale, 3.0)
        tot = dt.reduce(v)
    assert float(tot) == pytest.approx(64 * 6.0)
    np.testing.assert_allclose(box["r"], X * 5.0, rtol=1e-6)
    st = p.stats()
    assert st["fused_ops"] == 3 and st["fused_runs"] == 1


# ---------------------------------------------------------------------------
# subprocess daemon
# ---------------------------------------------------------------------------

def _spawn_env(fault_spec=None):
    env = dict(os.environ)
    env.pop("DR_GPU_SERVE_SOCKET", None)
    if fault_spec is not None:
        env["DR_GPU_FAULT_SPEC"] = fault_spec
    else:
        env.pop("DR_GPU_FAULT_SPEC", None)
    return env


def _spawn_daemon(path, fault_spec=None, cpu=True):
    args = [sys.executable, "-m", "dr_tpu_torch.serve", "--socket", path]
    proc = subprocess.Popen(args + (["--cpu"] if cpu else []),
                            env=_spawn_env(fault_spec),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, cwd=REPO)
    line = proc.stdout.readline()
    try:
        ready = json.loads(line) if line.strip() else {}
    except ValueError:
        ready = {}
    if ready.get("serving") != path:
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError(f"daemon failed to start: {line!r}")
    return proc


def test_serve_subprocess_lifecycle(tmp_path):
    path = str(tmp_path / "sub.sock")
    proc = _spawn_daemon(path)
    try:
        with serve.Client(path, timeout=120.0) as c:
            np.testing.assert_allclose(c.scale(X, a=2.0), X * 2.0,
                                       rtol=1e-6)
            c.shutdown()
        assert proc.wait(timeout=60) == 0
        assert not os.path.exists(path), "socket not cleaned up"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_serve_subprocess_device_route_needs_cuda(tmp_path):
    """``python -m dr_tpu_torch.serve`` without ``--cpu`` on a box with no
    card: the classified error line, exit code 1, no socket left."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the device route serves")
    path = str(tmp_path / "nocard.sock")
    res = subprocess.run(
        [sys.executable, "-m", "dr_tpu_torch.serve", "--socket", path],
        env=_spawn_env(), capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert res.returncode == 1, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["serving"] is None
    assert line["error"]["cls"] == "ProgramError"
    assert "no CUDA device" in line["error"]["message"]
    assert not os.path.exists(path)


def _serve_chaos_combos():
    if env_int("DR_GPU_CHAOS_ROUNDS", 1, floor=0) > 1:
        return [(s, k) for s, kinds in sorted(faults.sites().items())
                if s.startswith("serve.") for k in kinds]
    return [("serve.flush", "relay_down"), ("serve.request", "program")]


@pytest.mark.slow  # each combo starts a daemon subprocess
@pytest.mark.parametrize("site,kind", _serve_chaos_combos())
def test_serve_subprocess_chaos(tmp_path, site, kind):
    path = str(tmp_path / "chaos.sock")
    proc = _spawn_daemon(path, fault_spec=f"{site}:{kind}")
    try:
        outcomes = []
        for attempt in range(3):
            try:
                with serve.Client(path, timeout=120.0) as c:
                    got = c.scale(X, a=2.0)
                    np.testing.assert_allclose(got, X * 2.0, rtol=1e-6)
                    outcomes.append("ok")
            except resilience.ResilienceError as e:
                outcomes.append(type(e).__name__)
        assert outcomes[-1] == "ok", outcomes
        with serve.Client(path, timeout=120.0) as c:
            assert c.stats()["restarts"] == 0
            c.shutdown()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# client retry policy
# ---------------------------------------------------------------------------

def test_client_retry_recovers_transient_intake_fault(server):
    with _client(server, retries=3) as c:
        faults.inject("serve.request", "transient", times=1)
        x = np.arange(8, dtype=np.float32)
        np.testing.assert_allclose(c.scale(x, a=2.0), x * 2.0, rtol=1e-6)


def test_client_retry_recovers_overload(tmp_path):
    srv = serve.Server(str(tmp_path / "r.sock"), queue_depth=1,
                       batch_window=0.0, cpu=True).start()
    try:
        srv.hold()
        filler_err = []

        def filler():
            try:
                with serve.Client(srv.path, timeout=30.0,
                                  tenant="filler") as c0:
                    c0.reduce(X)
            except resilience.ResilienceError as e:  # pragma: no cover
                filler_err.append(e)

        t = threading.Thread(target=filler)
        t.start()
        _wait_queued(srv, 1)
        threading.Timer(0.3, srv.release).start()
        with serve.Client(srv.path, timeout=30.0, retries=1) as c1:
            with pytest.raises(resilience.ServerOverloaded):
                c1.reduce(X)
        with serve.Client(srv.path, timeout=30.0, retries=5) as c2:
            assert abs(c2.reduce(np.ones(8, np.float32)) - 8.0) < 1e-4
        t.join(timeout=10)
        assert not filler_err
        assert srv.stats()["rejected"] >= 1
    finally:
        srv.stop()


def test_client_retry_deadline_aware():
    calls = []

    def always_overloaded():
        calls.append(1)
        raise resilience.ServerOverloaded("full", site="serve.request")

    with pytest.raises(resilience.ServerOverloaded):
        resilience.retry(always_overloaded, attempts=5, base=10.0,
                         retry_on=(resilience.ServerOverloaded,),
                         deadline_s=0.5)
    assert len(calls) == 1


def test_client_default_single_attempt_unchanged(server):
    with _client(server) as c:
        faults.inject("serve.request", "transient", times=1)
        with pytest.raises(resilience.TransientBackendError):
            c.scale(np.arange(4, dtype=np.float32))


# ---------------------------------------------------------------------------
# parity: every OPS entry through a JAX daemon and a port daemon
# ---------------------------------------------------------------------------

@pytest.fixture
def pair(tmp_path):
    """A JAX daemon on its 8-device CPU mesh and a port daemon on 8 CPU
    ranks; yields ``(client, Ref)`` for each package."""
    import dr_tpu
    from dr_tpu import serve as jserve
    dr_tpu.init()
    jsrv = jserve.Server(str(tmp_path / "j.sock"),
                         batch_window=0.0).start()
    tsrv = serve.Server(str(tmp_path / "t.sock"), batch_window=0.0,
                        cpu=True).start()
    jc = jserve.Client(jsrv.path, timeout=120.0)
    tc = serve.Client(tsrv.path, timeout=120.0)
    try:
        yield (jc, jserve.Ref), (tc, serve.Ref)
    finally:
        jc.close()
        tc.close()
        jsrv.stop()
        tsrv.stop()
        jserve.reset()


def _inputs(seed, n=203):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    k = rng.integers(0, 13, n).astype(np.float32)
    return x, y, k


def _both(pair, fn):
    """``fn(client, Ref)`` through the JAX daemon, then the port's."""
    return tuple(fn(c, ref) for c, ref in pair)


def _bits(a, b):
    a = a if isinstance(a, (list, tuple)) else [a]
    b = b if isinstance(b, (list, tuple)) else [b]
    assert len(a) == len(b)
    for u, v in zip(a, b):
        u, v = np.asarray(u), np.asarray(v)
        assert u.dtype == v.dtype and u.shape == v.shape, (u, v)
        np.testing.assert_array_equal(u.view(np.uint8), v.view(np.uint8))


def test_parity_fill_put_get_drop(pair):
    x, _, _ = _inputs(1)
    j, t = _both(pair, lambda c, R: c.fill(77, -1.25))
    _bits(j, t)
    j, t = _both(pair, lambda c, R: (c.put("p", x), c.get("p"),
                                     c.put("p", x)["cached"],
                                     c.drop("p")["dropped"],
                                     c.drop("p")["dropped"]))
    assert j[0]["tag"] == t[0]["tag"] and j[0]["bytes"] == t[0]["bytes"]
    _bits(j[1], t[1])
    _bits(t[1], x)
    assert j[2:] == t[2:] == (True, True, False)


@pytest.mark.parametrize("descending", [False, True])
def test_parity_sort(pair, descending):
    x, _, _ = _inputs(2)
    x[5] = -0.0
    x[9] = 0.0
    j, t = _both(pair, lambda c, R: c.sort(x, descending=descending))
    _bits(j, t)


def test_parity_scale(pair):
    x, _, _ = _inputs(3)
    j, t = _both(pair, lambda c, R: c.scale(x, a=1.5, b=-0.25))
    # x * a + b: the JAX package may fuse the multiply-add (one rounding)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t, x * np.float32(1.5)
                                  + np.float32(-0.25))


def test_parity_reduce_dot_scan(pair):
    x, y, _ = _inputs(4)
    j, t = _both(pair, lambda c, R: (c.reduce(x), c.dot(x, y)))
    for a, b in zip(j, t):
        # f32 sums in two orders: 1e-5 of the magnitude summed
        assert abs(a - b) <= 1e-5 * float(np.abs(x).sum()
                                          * max(1.0, np.abs(y).max()))
    j, t = _both(pair, lambda c, R: c.scan(x))
    # f32 prefixes in two orders: 1e-5 of the largest prefix
    np.testing.assert_allclose(t, j, atol=1e-5 * np.abs(j).max())


def test_parity_histogram_topk_unique(pair):
    x, _, k = _inputs(5)
    _bits(*_both(pair, lambda c, R: c.histogram(x, 9, -2.0, 2.0)))
    _bits(*_both(pair, lambda c, R: c.top_k(x, 7)))
    _bits(*_both(pair, lambda c, R: c.top_k(x, 5, largest=False)))
    _bits(*_both(pair, lambda c, R: c.unique(k)))


@pytest.mark.parametrize("agg", ["min", "max", "count", "sum", "mean"])
def test_parity_groupby(pair, agg):
    x, _, k = _inputs(6)
    j, t = _both(pair, lambda c, R: c.groupby(k, x, agg=agg))
    _bits(j[0], t[0])
    if agg in ("min", "max", "count"):
        _bits(j[1], t[1])
    else:  # f32 sums in two orders
        np.testing.assert_allclose(t[1], j[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_parity_join(pair, how):
    rng = np.random.default_rng(7)
    lk = rng.integers(0, 9, 40).astype(np.float32)
    lv = rng.standard_normal(40).astype(np.float32)
    rk = rng.integers(0, 9, 31).astype(np.float32)
    rv = rng.standard_normal(31).astype(np.float32)
    j, t = _both(pair, lambda c, R: c.join(lk, lv, rk, rv, how=how,
                                           fill=-7.0))
    assert len(j[0]) == len(t[0])
    order_j = np.lexsort((j[2], j[1], j[0]))
    order_t = np.lexsort((t[2], t[1], t[0]))
    _bits([np.asarray(a)[order_j] for a in j],
          [np.asarray(b)[order_t] for b in t])


def test_parity_refs_and_errors(pair):
    x, y, _ = _inputs(8)
    j, t = _both(pair, lambda c, R: (c.put("rx", x), c.put("ry", y),
                                     c.reduce(R("rx")), c.sort(R("ry")),
                                     c.get("ry")))
    assert abs(j[2] - t[2]) <= 1e-5 * float(np.abs(x).sum())
    _bits(j[3], t[3])
    _bits(j[4], t[4])  # the sort ran on a scratch copy in both
    _bits(t[4], y)
    for bad in (lambda c: c.request("nope"), lambda c: c.fill(0),
                lambda c: c.groupby(x, y, agg="median"),
                lambda c: c.histogram(x, 0, 0.0, 1.0),
                lambda c: c.get("never-put")):
        got = []
        for c, _ref in pair:
            with pytest.raises(Exception) as ei:
                bad(c)
            got.append(type(ei.value).__name__)
        assert got[0] == got[1] == "ProgramError"


def test_parity_covers_every_op():
    from dr_tpu.serve import OPS as JOPS
    assert set(serve.OPS) == set(JOPS)
    for name, spec in serve.OPS.items():
        assert (spec.narrays, spec.batchable) == \
            (JOPS[name].narrays, JOPS[name].batchable), name


def test_phase25_rehearsal(tmp_path):
    """``chip_smoke.py`` phase 25 on the CPU at a small size: every reply
    of the 3-tenant mix equals the direct call bit for bit, each daemon
    site's chaos case ends classified or right, the journal restart
    brings the residents back, the entry point serves and exits 0, and
    the 4-rank loss and grow give fresh runtimes' bits."""
    import importlib.util
    from dr_tpu_torch.ops import kernels
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    td = str(tmp_path)
    srv, one, inputs = chip.serve_one_rank(
        dt, kernels, 5, td, device="cpu", tenants=3, res_log2=14,
        inline_log2=12, k6_n=256, bins=64, k=16)
    try:
        assert one["requests"] == 3 * 64 and one["errors"] == 0
        chaos = chip.serve_chaos(srv, serve, faults,
                                 chip.serve_sites(faults))
        assert set(chaos) == {f"{s}:{k}" for s, k in
                              chip.serve_sites(faults)}
        assert chaos["serve.flush:relay_down"] == \
            "RelayDownError@serve.flush"
        rs = chip.serve_restart(dt, srv, inputs, serve, td, device="cpu")
        assert rs["replayed"] >= 6
    finally:
        srv.stop()
        serve.reset()
    assert chip.serve_subprocess(td, cpu=True)["route"]["current"] == "cpu"
    four = chip.serve_four_ranks(dt, 5, td, device="cpu", log2=12)
    assert four["story"]["shrink"]["shrinks"] == 1


def test_serve_concurrent_clients_never_dropped(tmp_path):
    """More client threads than cores, a short switch interval, replies
    written while each connection's reader waits for its next frame:
    every request is answered right (a reply's write must not disturb
    the reader's blocking ``recv`` on the same socket)."""
    srv = serve.Server(str(tmp_path / "st.sock"), cpu=True,
                       queue_depth=256, tenant_cap=64,
                       batch_window=0.0).start()
    errs, done = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(i):
            try:
                with serve.Client(srv.path, timeout=120.0,
                                  tenant=f"c{i}") as c:
                    x = np.arange(64 + i, dtype=np.float32)
                    for r in range(60):
                        got = c.scale(x, a=2.0, b=float(r))
                        if not np.array_equal(got, x * np.float32(2.0)
                                              + np.float32(r)):
                            errs.append((i, r, "wrong"))
                done.append(i)
            except Exception as e:  # reported by the assertion below
                errs.append((i, repr(e)))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        srv.stop()
    assert not errs, errs[:4]
    assert len(done) == len(threads)
