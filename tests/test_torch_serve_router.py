"""dr_tpu_torch's replica router (``dr_tpu_torch/serve/router.py``:
``HashRing``, ``CircuitBreaker``, ``Router``, ``RouterClient``) against
dr_tpu's.

Mirrors the router cases of ``tests/test_serve_dataplane.py``
(``test_hash_ring_stable_and_bounded_rehash`` to
``test_router_route_fault_site_classified``, and
``test_router_subprocess_fleet_churn_and_kill``), of
``tests/test_serve_controlplane.py`` (``test_breaker_state_machine``,
``test_probe_schedule_deterministic_and_bounded``,
``test_router_and_clients_share_one_budget``,
``test_dead_fleet_fails_fast_classified``,
``test_router_drain_rehash_no_client_error``,
``test_rolling_restart_zero_classified_errors``,
``test_breaker_probe_readmits_replica`` and the two subprocess soaks)
and the router leg of ``tests/test_chaos.py``, on ``dt.init(["cpu"] *
8)`` with ``Router(cpu=True)``.  Spawned replicas run ``python -m
dr_tpu_torch.serve --cpu``; as in the JAX file, the churn soak and the
SIGTERM rolling restart are slow-marked, and the SIGKILL respawn and
the phase 26 rehearsal run unmarked.

Where the port differs: every replica takes the requested route (the
JAX fleet pins replicas 1 and up to the CPU), ``Router`` defaults to the
card, an in-process fleet whose route is not the initialised runtime's
is refused, and in-process replicas never run batches at once on the
shared ranks.  The parity cases hold the ring's placement, the probe
schedule's delays, the breaker's states, a fleet's replies and the
story's router fields against ``dr_tpu.serve``'s.
"""

import importlib.util
import io
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

import dr_tpu_torch as dt
from dr_tpu_torch import serve
from dr_tpu_torch.serve import daemon as daemon_mod
from dr_tpu_torch.serve import router as router_mod
from dr_tpu_torch.serve.router import _ProbeSchedule
from dr_tpu_torch.utils import elastic, faults, resilience
from dr_tpu_torch.utils.env import env_int, env_override

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
    dt.obs.arm(False)
    dt.obs.reset()
    dt.final()


def _client(srv, **kw):
    kw.setdefault("timeout", 60.0)
    return serve.Client(srv.path, **kw)


def _fleet(tmp_path, name, replicas=2, **kw):
    kw.setdefault("batch_window", 0.0)
    return serve.Router(str(tmp_path / name), replicas=replicas, cpu=True,
                        **kw).start()


# ---------------------------------------------------------------------------
# the ring, the breaker and the probe schedule (no daemon)
# ---------------------------------------------------------------------------

def test_hash_ring_stable_and_bounded_rehash():
    paths = [f"/tmp/r{i}.sock" for i in range(4)]
    ring1 = serve.HashRing(paths)
    ring2 = serve.HashRing(list(paths))
    tenants = [f"tenant{i}" for i in range(64)]
    before = {t: ring1.lookup(t) for t in tenants}
    # placement is process-independent (sha1, not salted hash())
    assert before == {t: ring2.lookup(t) for t in tenants}
    assert len(set(before.values())) > 1, "all tenants on one replica"
    ring1.remove(paths[0])
    moved = [t for t in tenants if ring1.lookup(t) != before[t]]
    # ONLY the dead replica's tenants moved (consistent hashing)
    assert all(before[t] == paths[0] for t in moved)
    assert all(ring1.lookup(t) == before[t] for t in tenants
               if before[t] != paths[0])


def test_breaker_state_machine():
    with env_override(DR_GPU_SERVE_PROBE_S="1.0", DR_GPU_SERVE_PROBES="3"):
        br = serve.CircuitBreaker("/tmp/x.sock", seed=0)
        assert br.state == "closed" and not br.due()
        br.trip()
        assert br.state == "open" and br.trips == 1
        now = time.monotonic()
        # first probe lands one backoff-base out, not immediately
        assert not br.due(now)
        assert br.due(now + 2.0)
        # a failed probe advances the schedule: the next due time
        # doubles (seeded jitter, deterministic)
        br.sched.advance(now + 2.0)
        assert not br.due(now + 2.1)
        assert br.due(now + 2.0 + 4.0)
        # the budget bounds the probing: after 3 probes, never due again
        br.sched.advance(now + 6.0)
        br.sched.advance(now + 6.0)
        assert br.exhausted() and not br.due(now + 1e6)
        # a healthy probe closes the breaker and drops the schedule
        br.reset()
        assert br.state == "closed" and br.sched is None


def test_probe_schedule_deterministic_and_bounded():
    with env_override(DR_GPU_SERVE_PROBE_S="0.25",
                      DR_GPU_SERVE_PROBE_CAP_S="2.0",
                      DR_GPU_SERVE_PROBES="5"):
        a, b = _ProbeSchedule(seed=3), _ProbeSchedule(seed=3)
        assert a._delays == b._delays  # seeded: reproducible
        assert len(a._delays) == 5
        assert max(a._delays) <= 2.0 * 1.25  # cap (+jitter)
        for _ in range(5):
            assert not a.exhausted()
            a.advance()
        assert a.exhausted() and not a.due()


def test_probe_schedule_reads_the_ports_env_names():
    """``DR_GPU_SERVE_PROBE*`` set the schedule; the JAX package's
    ``DR_TPU_SERVE_PROBE*`` do not."""
    with env_override(DR_TPU_SERVE_PROBE_S="9.0", DR_TPU_SERVE_PROBES="2",
                      DR_GPU_SERVE_PROBE_S=None, DR_GPU_SERVE_PROBES=None,
                      DR_GPU_SERVE_PROBE_CAP_S=None):
        s = _ProbeSchedule(seed=0)
        assert s.budget == 16 and s._delays[0] <= 0.5 * 1.25
    with env_override(DR_GPU_SERVE_PROBES="2"):
        assert _ProbeSchedule(seed=0).budget == 2


# ---------------------------------------------------------------------------
# parity with the JAX package's ring, schedule and breaker
# ---------------------------------------------------------------------------

def test_hash_ring_placement_matches_the_jax_package():
    """256 tenants over 4 paths: the same replica for every tenant as
    ``dr_tpu.serve.HashRing``, before and after ``remove`` and ``add``."""
    from dr_tpu import serve as jserve
    paths = [f"/tmp/dr_fleet.r{i}" for i in range(4)]
    tenants = [f"t{i}" for i in range(256)]
    ours, theirs = serve.HashRing(paths), jserve.HashRing(paths)

    def same():
        assert ours.keys() == theirs.keys()
        assert [ours.lookup(t) for t in tenants] == \
            [theirs.lookup(t) for t in tenants]

    same()
    for ring in (ours, theirs):
        ring.remove(paths[1])
    same()
    for ring in (ours, theirs):
        ring.add(paths[1])
        ring.add("/tmp/dr_fleet.r4")
    same()
    assert len({ours.lookup(t) for t in tenants}) == 5
    assert router_mod._digest("alice") == \
        importlib.import_module("dr_tpu.serve.router")._digest("alice")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_probe_schedule_matches_the_jax_package(seed, monkeypatch):
    from dr_tpu.serve.router import _ProbeSchedule as JSched
    for pkg in ("GPU", "TPU"):
        monkeypatch.setenv(f"DR_{pkg}_SERVE_PROBE_S", "0.2")
        monkeypatch.setenv(f"DR_{pkg}_SERVE_PROBE_CAP_S", "3.0")
        monkeypatch.setenv(f"DR_{pkg}_SERVE_PROBES", "11")
    ours, theirs = _ProbeSchedule(seed=seed), JSched(seed=seed)
    assert ours.budget == theirs.budget == 11
    assert ours._delays == theirs._delays
    for pkg in ("GPU", "TPU"):
        for knob in ("PROBE_S", "PROBE_CAP_S", "PROBES"):
            monkeypatch.delenv(f"DR_{pkg}_SERVE_{knob}")
    assert _ProbeSchedule(seed=seed)._delays == JSched(seed=seed)._delays


def test_breaker_state_machine_matches_the_jax_package(monkeypatch):
    from dr_tpu import serve as jserve
    for pkg in ("GPU", "TPU"):
        monkeypatch.setenv(f"DR_{pkg}_SERVE_PROBE_S", "0.5")
        monkeypatch.setenv(f"DR_{pkg}_SERVE_PROBES", "4")
    both = (serve.CircuitBreaker("/tmp/b.sock", seed=2),
            jserve.CircuitBreaker("/tmp/b.sock", seed=2))
    t0 = time.monotonic()

    def state():
        return [(b.state, b.trips, b.exhausted(),
                 [b.due(t0 + d) for d in (0.0, 0.4, 0.7, 2.0, 9.0)])
                for b in both]

    seen = [state()]
    for step in ("trip", "advance", "advance", "trip", "advance",
                 "advance", "advance", "advance", "reset", "trip"):
        for b in both:
            if step == "advance":
                b.sched.advance(t0 + 1.0)
            else:
                getattr(b, step)()
        seen.append(state())
    for ours, theirs in seen:
        assert ours == theirs


# ---------------------------------------------------------------------------
# in-process fleets
# ---------------------------------------------------------------------------

def test_router_fleet_tenant_affinity_and_stats(tmp_path):
    fleet = _fleet(tmp_path, "f")
    try:
        with serve.RouterClient(fleet.paths(), tenant="alice",
                                timeout=60.0) as rc:
            assert abs(rc.reduce(np.ones(64, np.float32)) - 64.0) < 1e-3
            # resident state follows tenant affinity: put and ref land
            # on the SAME replica without the caller knowing which
            rc.put("feat", X)
            assert abs(rc.reduce(serve.Ref("feat")) - X.sum()) < 1e-3
            # a second tenant routes independently (possibly the other
            # replica) and its ops work through the same front
            assert abs(rc.reduce(np.ones(8, np.float32),
                                 tenant="bob") - 8.0) < 1e-3
            st = rc.stats()
            assert len(st) == 2
            assert sum(s["requests"] for s in st.values()) >= 3
            home = rc.route("alice")
            assert {p: s["resident"]["entries"] for p, s in st.items()} \
                == {p: int(p == home) for p in fleet.paths()}
    finally:
        fleet.stop()


def test_router_dead_replica_rehash_with_story_marker(tmp_path):
    fleet = _fleet(tmp_path, "k")
    try:
        with serve.RouterClient(fleet.paths(), tenant="alice",
                                timeout=60.0) as rc:
            assert abs(rc.reduce(np.ones(32, np.float32)) - 32.0) < 1e-3
            victim = rc.route("alice")
            next(s for s in fleet._servers if s.path == victim).stop()
            # the next op re-hashes onto the survivor and SUCCEEDS
            assert abs(rc.reduce(np.ones(16, np.float32)) - 16.0) < 1e-3
            assert rc.rehashes == 1
            assert rc.live_replicas() == \
                [p for p in fleet.paths() if p != victim]
            story = resilience.session_story()
            assert story is not None
            assert story["serve"]["router_dead"] == 1
            assert "re-hashed" in story["serve"]["router_reason"]
            # killing the LAST replica surfaces the fleet-wide death
            next(s for s in fleet._servers if s.path != victim).stop()
            with pytest.raises(resilience.RelayDownError):
                rc.reduce(np.ones(8, np.float32))
    finally:
        fleet.stop()
        serve.reset()


def test_router_route_fault_site_classified(tmp_path):
    fleet = _fleet(tmp_path, "rf", replicas=1)
    try:
        with serve.RouterClient(fleet.paths(), timeout=60.0) as rc:
            with faults.injected("router.route", "program") as sp:
                with pytest.raises(resilience.ProgramError) as ei:
                    rc.reduce(X)
                assert sp.fired == 1 and ei.value.site == "router.route"
            # a transient from a LIVE replica re-raises (no rehash)
            with faults.injected("router.route", "transient") as sp:
                with pytest.raises(resilience.TransientBackendError):
                    rc.reduce(X)
                assert sp.fired == 1
            assert rc.rehashes == 0
            assert abs(rc.reduce(np.ones(8, np.float32)) - 8.0) < 1e-3
            # a retried transient answers with the clean call's bits
            want = rc.reduce(X)
            with faults.injected("router.route", "transient", times=1):
                got = resilience.retry(lambda: rc.reduce(X), attempts=2,
                                       base=0.01, seed=0)
            assert np.float32(got).view(np.int32) == \
                np.float32(want).view(np.int32)
    finally:
        fleet.stop()


def test_router_and_clients_share_one_budget(tmp_path):
    # RouterClient's per-replica Clients draw from ONE bucket, so
    # fleet-level retries cannot multiply
    fleet = _fleet(tmp_path, "b")
    try:
        budget = resilience.TokenBudget(1, ratio=0.0)
        with serve.RouterClient(fleet.paths(), timeout=60.0, retries=4,
                                budget=budget) as rc:
            with faults.injected("serve.request", "transient",
                                 times=None) as sp:
                with pytest.raises(resilience.TransientBackendError):
                    rc.reduce(X)
                total_after_first = sp.fired
                assert total_after_first == 2  # 1 try + 1 budgeted
                with pytest.raises(resilience.TransientBackendError):
                    rc.reduce(X, tenant="other")
                # the other tenant (possibly the other replica) got NO
                # budgeted retry: the bucket is shared and dry
                assert sp.fired == total_after_first + 1
    finally:
        fleet.stop()


def test_dead_fleet_fails_fast_classified(tmp_path):
    # with the budget exhausted and every breaker open, a dead fleet
    # costs < 1 RTT a request: no backoff storm
    with env_override(DR_GPU_SERVE_PROBE_S="30.0"):
        fleet = _fleet(tmp_path, "dead")
        try:
            rc = serve.RouterClient(fleet.paths(), timeout=60.0,
                                    budget=resilience.TokenBudget(0))
            assert abs(rc.reduce(np.ones(8, np.float32)) - 8.0) < 1e-3
            for s in list(fleet._servers):
                s.stop()
            t0 = time.perf_counter()
            for i in range(10):
                with pytest.raises(resilience.RelayDownError):
                    rc.reduce(X, tenant=f"t{i}")
            assert time.perf_counter() - t0 < 1.0
            assert set(rc.breaker_states().values()) == {"open"}
            rc.close()
        finally:
            fleet.stop()


def test_router_drain_rehash_no_client_error(tmp_path):
    with env_override(DR_GPU_SERVE_PROBE_S="30.0"):
        fleet = _fleet(tmp_path, "dr")
        try:
            with serve.RouterClient(fleet.paths(), timeout=60.0) as rc:
                t2 = next(t for t in (f"t{i}" for i in range(64))
                          if rc.route(t) == fleet.paths()[1])
                assert abs(rc.reduce(np.ones(8, np.float32),
                                     tenant=t2) - 8.0) < 1e-3
                # park one in-flight request on the replica (held
                # dispatcher) so the drain STAYS in its announcing phase
                fleet._servers[1].hold()
                res = {}

                def inflight():
                    with _client(fleet._servers[1]) as c:
                        res["got"] = c.reduce(np.ones(32, np.float32))

                it = threading.Thread(target=inflight)
                it.start()
                deadline = time.monotonic() + 10.0
                while len(fleet._servers[1]._queue) == 0 \
                        and time.monotonic() < deadline:
                    time.sleep(0.005)
                th = threading.Thread(target=fleet._servers[1].drain)
                th.start()
                deadline = time.monotonic() + 10.0
                while not fleet._servers[1].draining() \
                        and time.monotonic() < deadline:
                    time.sleep(0.005)
                # mid-drain: the tenant's next op succeeds with NO
                # classified error (the drain announcement re-hashes)
                assert abs(rc.reduce(np.ones(16, np.float32),
                                     tenant=t2) - 16.0) < 1e-3
                fleet._servers[1].release()
                th.join(timeout=30.0)
                it.join(timeout=30.0)
                assert abs(res["got"] - 32.0) < 1e-3  # drain finished it
                assert rc.drain_rehashes == 1 and rc.rehashes == 0
                assert rc.breaker_states()[fleet.paths()[1]] == "open"
                assert env_int("_DR_GPU_SERVE_ROUTER_DRAINED", 0,
                               floor=0) >= 1
        finally:
            fleet._servers[1].release()
            fleet.stop()


def test_rolling_restart_zero_classified_errors(tmp_path):
    # NOT probe base 0.0: zero delays make the 16-probe budget burnable
    # within one restart's downtime by the tight traffic loop
    with env_override(DR_GPU_SERVE_PROBE_S="0.01"):
        fleet = _fleet(tmp_path, "rr", state_dir=str(tmp_path / "state"))
        try:
            rc = serve.RouterClient(fleet.paths(), tenant="alice",
                                    timeout=60.0)
            rc.put("feat", X)
            errs, done = [], threading.Event()

            def traffic():
                while not done.is_set():
                    try:
                        rc.reduce(X, tenant="alice")
                        rc.reduce(X, tenant="bob")
                    except resilience.ResilienceError as e:
                        errs.append(repr(e))

            th = threading.Thread(target=traffic)
            th.start()
            try:
                time.sleep(0.1)
                restarted = fleet.rolling_restart()
                time.sleep(0.2)
            finally:
                done.set()
                th.join(timeout=60.0)
            assert len(restarted) == 2
            assert not errs, errs[:3]
            # breakers re-close as paced probes land: the fleet is whole
            # again (and only THEN does the tenant's home replica answer
            # for its journal-replayed residents)
            deadline = time.monotonic() + 10.0
            while len(rc.live_replicas()) < 2 \
                    and time.monotonic() < deadline:
                rc.reduce(np.ones(4, np.float32), tenant="carol")
            assert len(rc.live_replicas()) == 2
            # resident state survived the full roll via the journal
            np.testing.assert_array_equal(rc.get("feat"), X)
            assert fleet.stats()["restarts"] == 2
            rc.close()
        finally:
            fleet.stop()


def test_breaker_probe_readmits_replica(tmp_path):
    with env_override(DR_GPU_SERVE_PROBE_S="0.0"):
        fleet = _fleet(tmp_path, "pr")
        try:
            with serve.RouterClient(fleet.paths(), timeout=60.0) as rc:
                t2 = next(t for t in (f"t{i}" for i in range(64))
                          if rc.route(t) == fleet.paths()[0])
                fleet._servers[0].stop()  # abrupt death, no drain
                # the dead replica's tenant re-hashes (story marker) and
                # the op still succeeds
                assert abs(rc.reduce(np.ones(8, np.float32),
                                     tenant=t2) - 8.0) < 1e-3
                assert rc.rehashes == 1
                assert len(rc.live_replicas()) == 1
                # a fresh daemon takes the socket back; the due probe
                # (router.probe fires) re-admits it to the ring
                fleet.restart_replica(0)
                with faults.injected("router.probe", "transient") as sp:
                    # the FAULTED probe backs off: the replica stays out
                    rc.reduce(np.ones(4, np.float32), tenant=t2)
                    assert sp.fired == 1
                    assert len(rc.live_replicas()) == 1
                rc.reduce(np.ones(4, np.float32), tenant=t2)
                assert fleet.paths()[0] in rc.live_replicas()
                assert rc.recoveries == 1
                assert rc.breaker_states()[fleet.paths()[0]] == "closed"
                assert env_int("_DR_GPU_SERVE_ROUTER_RECOVERED", 0,
                               floor=0) >= 1
        finally:
            fleet.stop()


def test_chaos_router_leg(tmp_path):
    """The router leg of ``tests/test_chaos.py``: a second replica
    drains (``serve.drain`` fires), its tenant re-hashes onto the
    survivor with no client-visible error, and once a fresh daemon holds
    the socket again the open breaker's half-open probe (``router.probe``
    fires) re-admits it; ``router.route`` fires at every lookup."""
    s1 = serve.Server(str(tmp_path / "c1.sock"), cpu=True,
                      batch_window=0.0).start()
    s2 = serve.Server(str(tmp_path / "c2.sock"), cpu=True,
                      batch_window=0.0).start()
    faults.arm_counting()
    try:
        with env_override(DR_GPU_SERVE_PROBE_S="0.0"):
            with serve.RouterClient([s1.path, s2.path],
                                    timeout=60.0) as rc:
                assert abs(rc.reduce(np.ones(4 * P, np.float32))
                           - 4 * P) < 1e-3
                t2 = next(t for t in (f"t{i}" for i in range(64))
                          if rc.route(t) == s2.path)
                s2.drain()
                assert abs(rc.reduce(np.ones(2 * P, np.float32),
                                     tenant=t2) - 2 * P) < 1e-3
                s2 = serve.Server(s2.path, cpu=True,
                                  batch_window=0.0).start()
                assert abs(rc.reduce(np.ones(P, np.float32),
                                     tenant=t2) - P) < 1e-3
                assert s2.path in rc.live_replicas()
                assert rc.route(t2) == s2.path
        visits = faults.stats()
        for site in ("router.route", "router.probe", "serve.drain"):
            assert visits.get(site, 0) >= 1, (site, visits)
    finally:
        s1.stop()
        s2.stop()


# ---------------------------------------------------------------------------
# where the port differs: the route, the shared runtime, the shared ranks
# ---------------------------------------------------------------------------

def test_router_defaults_to_the_card(tmp_path):
    """``Router()`` asks for the card, as every entry point of the port:
    without one its start fails classified (the claim's error), starts
    nothing and leaves no socket."""
    fleet = serve.Router(str(tmp_path / "card"), replicas=2)
    assert fleet.cpu is False and fleet.spawn is False
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the device fleet starts")
    dt.final()
    with pytest.raises(resilience.ProgramError) as ei:
        fleet.start()
    assert ei.value.site == "runtime.init"
    assert fleet.paths() == [] and not list(router_mod._live_routers)
    assert not os.path.exists(str(tmp_path / "card") + ".r0")


def test_router_refuses_a_mixed_route_fleet(tmp_path):
    """An in-process fleet shares the initialised runtime: a fleet on
    another route is refused, classified at ``router.route``, before any
    replica starts, and the runtime is left as it was."""
    base = str(tmp_path / "mixed")
    with pytest.raises(resilience.ProgramError) as ei:
        serve.Router(base, replicas=2).start()
    assert ei.value.site == "router.route"
    assert not any(os.path.exists(f"{base}.r{i}") for i in range(2))
    assert not list(router_mod._live_routers)
    assert dt.nprocs() == P and all(d.type == "cpu" for d in dt.devices())
    # the route the runtime holds starts, every replica on it
    fleet = serve.Router(base, replicas=2, cpu=True).start()
    try:
        assert [s.stats()["route"] for s in fleet._servers] == \
            [{"requested": "cpu", "current": "cpu"}] * 2
        assert dt.nprocs() == P
    finally:
        fleet.stop()


class _FakeProc:
    """A ``subprocess.Popen`` stand-in that records its argv and env and
    prints the ready line of the socket it was given."""

    made: list = []

    def __init__(self, argv, env=None, **kw):
        self.argv, self.env, self.returncode = argv, env, None
        path = argv[argv.index("--socket") + 1]
        self.stdout = io.StringIO(json.dumps({"serving": path}) + "\n")
        _FakeProc.made.append(self)

    def poll(self):
        return self.returncode

    def terminate(self):
        self.returncode = 0

    kill = terminate

    def wait(self, timeout=None):
        return self.returncode


@pytest.mark.parametrize("cpu", [False, True])
def test_spawn_argv_takes_the_requested_route(tmp_path, monkeypatch, cpu):
    """Every spawned replica is ``python -m dr_tpu_torch.serve`` on the
    requested route (``--cpu`` only when asked, for replica 0 and the
    rest alike), with the state dir, and imports this checkout."""
    import subprocess
    monkeypatch.setattr(subprocess, "Popen", _FakeProc)
    _FakeProc.made = []
    state = str(tmp_path / "st")
    fleet = serve.Router(str(tmp_path / "sp"), replicas=3, cpu=cpu,
                         spawn=True, state_dir=state).start()
    try:
        assert [p.argv for p in _FakeProc.made] == [
            [sys.executable, "-m", "dr_tpu_torch.serve", "--socket",
             f"{tmp_path / 'sp'}.r{i}"] + (["--cpu"] if cpu else [])
            + ["--state-dir", state] for i in range(3)]
        for p in _FakeProc.made:
            assert p.env["PYTHONPATH"].split(os.pathsep)[0] == REPO
            assert {k: v for k, v in p.env.items() if k != "PYTHONPATH"} \
                == {k: v for k, v in os.environ.items()
                    if k != "PYTHONPATH"}
    finally:
        fleet.stop()


def test_in_process_replicas_never_run_batches_at_once(tmp_path,
                                                       monkeypatch):
    """Two in-process replicas on the same ranks, tenants on both, many
    client threads: no batch of one runs while the other's does (the
    sort handler, which runs inside the batch worker, never overlaps),
    and every reply is right."""
    spec = daemon_mod.OPS["sort"]
    orig = spec.handler
    lock = threading.Lock()
    live, peak, calls = [0], [0], []

    def watched(req):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            calls.append(req.tenant)
        try:
            time.sleep(0.005)
            return orig(req)
        finally:
            with lock:
                live[0] -= 1

    monkeypatch.setattr(spec, "handler", watched)
    fleet = _fleet(tmp_path, "ex")
    try:
        ring = serve.HashRing(fleet.paths())
        names = [f"t{i}" for i in range(64)]
        tenants = [t for p in fleet.paths()
                   for t in [n for n in names if ring.lookup(n) == p][:3]]
        errs = []

        def worker(t, seed):
            rng = np.random.default_rng(seed)
            try:
                with serve.RouterClient(fleet.paths(), tenant=t,
                                        timeout=60.0) as rc:
                    for _ in range(8):
                        x = rng.standard_normal(257).astype(np.float32)
                        got = rc.sort(x)
                        if not np.array_equal(got, np.sort(x)):
                            errs.append((t, "wrong"))
            except Exception as e:  # reported by the assertion below
                errs.append((t, repr(e)))

        threads = [threading.Thread(target=worker, args=(t, i))
                   for i, t in enumerate(tenants)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120.0)
        assert not errs, errs[:4]
        served = {s.path: s.stats()["requests"] for s in fleet._servers}
        assert all(n > 0 for n in served.values()), served
        assert len(calls) == 8 * len(tenants)
        assert peak[0] == 1, peak
        assert daemon_mod._RANKS.busy == 0
    finally:
        fleet.stop()


def test_serve_reset_stops_fleets(tmp_path):
    """``serve.reset()`` stops a leaked fleet before the daemons, as the
    JAX package's does: its sockets are gone and no fleet is live."""
    fleet = _fleet(tmp_path, "leak")
    paths = fleet.paths()
    assert all(os.path.exists(p) for p in paths)
    assert list(router_mod._live_routers) == [fleet]
    serve.reset()
    assert not any(os.path.exists(p) for p in paths)
    assert not list(router_mod._live_routers)
    assert fleet.stats()["alive"] == [] and fleet.paths() == []


# ---------------------------------------------------------------------------
# parity: a fleet's replies and the story's router fields
# ---------------------------------------------------------------------------

def _fleet_ops(rng):
    x = rng.standard_normal(203).astype(np.float32)
    y = rng.standard_normal(203).astype(np.float32)
    k = rng.integers(0, 13, 203).astype(np.float32)
    return x, y, k


def test_fleet_replies_match_the_jax_fleet(tmp_path):
    """The same numpy inputs through a JAX fleet and a port fleet of two
    in-process CPU replicas each, four tenants through each package's
    ``RouterClient``: data movement, sort, integers and min/max bit for
    bit; float sums and scans within ``tests/test_torch_serve.py``'s
    tolerances."""
    import dr_tpu
    from dr_tpu import serve as jserve
    dr_tpu.init()
    jf = jserve.Router(str(tmp_path / "j"), replicas=2, cpu=True,
                       batch_window=0.0).start()
    tf = _fleet(tmp_path, "t")
    try:
        for i in range(4):
            x, y, k = _fleet_ops(np.random.default_rng(i))
            got = []
            for pkg, fleet in ((jserve, jf), (serve, tf)):
                with pkg.RouterClient(fleet.paths(), tenant=f"t{i}",
                                      timeout=120.0) as rc:
                    rc.put("x", x)
                    got.append({
                        "reduce": rc.reduce(pkg.Ref("x")),
                        "dot": rc.dot(pkg.Ref("x"), y),
                        "scan": rc.scan(x),
                        "sort": rc.sort(pkg.Ref("x")),
                        "get": rc.get("x"),
                        "hist": rc.histogram(x, 9, -2.0, 2.0),
                        "topk": rc.top_k(x, 7),
                        "unique": rc.unique(k),
                        "gmin": rc.groupby(k, x, agg="min"),
                        "scale": rc.scale(x, a=1.5, b=-0.25),
                        "fill": rc.fill(77, -1.25)})
            j, t = got
            for key in ("reduce", "dot"):
                # f32 sums in two orders: 1e-5 of the magnitude summed
                assert abs(j[key] - t[key]) <= 1e-5 * float(
                    np.abs(x).sum() * max(1.0, np.abs(y).max()))
            # f32 prefixes in two orders: 1e-5 of the largest prefix
            np.testing.assert_allclose(t["scan"], j["scan"],
                                       atol=1e-5 * np.abs(j["scan"]).max())
            # x * a + b: the JAX package may fuse the multiply-add
            np.testing.assert_allclose(t["scale"], j["scale"], rtol=1e-6,
                                       atol=1e-7)
            for key in ("sort", "get", "hist", "topk", "unique", "gmin",
                        "fill"):
                a = j[key] if isinstance(j[key], (list, tuple)) else [j[key]]
                b = t[key] if isinstance(t[key], (list, tuple)) else [t[key]]
                assert len(a) == len(b), key
                for u, v in zip(a, b):
                    u, v = np.asarray(u), np.asarray(v)
                    assert u.dtype == v.dtype and u.shape == v.shape, key
                    np.testing.assert_array_equal(u.view(np.uint8),
                                                  v.view(np.uint8))
            np.testing.assert_array_equal(t["get"], x)
    finally:
        jf.stop()
        tf.stop()
        jserve.reset()


def test_session_story_router_fields_match_the_jax_package(tmp_path):
    """The router's markers give the serve chapter the JAX package's
    ``degradation_story`` gives for the same values, for set values and
    for the markers a real re-hash, drain and re-admission publish."""
    from dr_tpu.utils import resilience as jres
    marks = {"ROUTER_DEAD": "2", "ROUTER_REASON": "replica x re-hashed",
             "ROUTER_DRAINED": "3", "ROUTER_RECOVERED": "1",
             "RESPAWNS": "4"}
    j = jres.degradation_story({f"_DR_TPU_SERVE_{k}": v
                                for k, v in marks.items()})
    t = resilience.session_story({f"_DR_GPU_SERVE_{k}": v
                                  for k, v in marks.items()})
    assert t["serve"] == j["serve"] and t["reason"] == j["reason"]
    with env_override(DR_GPU_SERVE_PROBE_S="0.0"):
        fleet = _fleet(tmp_path, "st")
        try:
            with serve.RouterClient(fleet.paths(), timeout=60.0) as rc:
                t0 = next(t for t in (f"t{i}" for i in range(64))
                          if rc.route(t) == fleet.paths()[0])
                fleet._servers[0].stop()
                rc.reduce(X, tenant=t0)
                fleet.restart_replica(0)
                rc.reduce(X, tenant=t0)
                assert rc.recoveries == 1
        finally:
            fleet.stop()
    live = {k: v for k, v in os.environ.items()
            if k.startswith("_DR_GPU_SERVE_")}
    assert live["_DR_GPU_SERVE_ROUTER_DEAD"] == "1"
    assert live["_DR_GPU_SERVE_ROUTER_RECOVERED"] == "1"
    t = resilience.session_story(live)
    j = jres.degradation_story({k.replace("_DR_GPU_", "_DR_TPU_"): v
                                for k, v in live.items()})
    assert t["serve"] == j["serve"] and t["reason"] == j["reason"]
    assert t["serve"]["router_dead"] == 1


# ---------------------------------------------------------------------------
# spawned fleets
# ---------------------------------------------------------------------------

def test_subprocess_sigkill_respawn_serves_journal(tmp_path):
    with env_override(DR_GPU_SERVE_PROBE_S="0.1"):
        fleet = serve.Router(str(tmp_path / "sk"), replicas=2, cpu=True,
                             spawn=True,
                             state_dir=str(tmp_path / "state")).start()
        try:
            rc = serve.RouterClient(fleet.paths(), tenant="kv",
                                    timeout=120.0, router=fleet)
            x = np.arange(1 << 12, dtype=np.float32)
            rc.put("feat", x)
            victim = rc.route("kv")
            vi = fleet.paths().index(victim)
            fleet._procs[vi].send_signal(signal.SIGKILL)
            fleet._procs[vi].wait(timeout=30)
            # the supervisor poll rides rc calls (router=fleet): the
            # traffic notices the death (re-hash), the poll respawns,
            # the breaker probe re-admits; then the journal serves the
            # tenant's resident BIT-EQUAL from the fresh process.  The
            # ring lists the corpse until a request hits it.
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                try:
                    rc.reduce(np.ones(8, np.float32), tenant="kv")
                    if fleet.stats()["respawns"] >= 1 \
                            and victim in rc.live_replicas():
                        break
                except resilience.ResilienceError:
                    pass  # mid-churn classified: acceptable
                time.sleep(0.05)
            assert fleet.stats()["respawns"] >= 1, "never respawned"
            assert victim in rc.live_replicas(), "never re-admitted"
            np.testing.assert_array_equal(rc.get("feat", tenant="kv"), x)
            assert env_int("_DR_GPU_SERVE_RESPAWNS", 0, floor=0) >= 1
            story = resilience.session_story()
            assert story is not None and story["serve"]["respawns"] >= 1
            with serve.Client(victim, timeout=60.0) as c:
                assert c.route() == {"requested": "cpu", "current": "cpu"}
            rc.close()
        finally:
            fleet.stop()


@pytest.mark.slow  # two daemon subprocesses; SIGTERM is the __main__
# drain path, the spawn-mode half of the rolling-restart case
def test_subprocess_sigterm_drains_and_rolling_restart(tmp_path):
    with env_override(DR_GPU_SERVE_PROBE_S="0.1"):
        fleet = serve.Router(str(tmp_path / "rrs"), replicas=2, cpu=True,
                             spawn=True,
                             state_dir=str(tmp_path / "state")).start()
        try:
            rc = serve.RouterClient(fleet.paths(), tenant="alice",
                                    timeout=120.0, router=fleet)
            x = np.arange(256, dtype=np.float32)
            rc.put("feat", x)
            # SIGTERM = graceful drain (__main__): clean exit 0
            proc = fleet._procs[1]
            proc.terminate()
            assert proc.wait(timeout=60) == 0
            fleet._procs[1] = fleet._spawn(fleet.paths()[1])
            # full wire-drain rolling restart over both replicas
            restarted = fleet.rolling_restart()
            assert len(restarted) == 2
            deadline = time.monotonic() + 60.0
            while len(rc.live_replicas()) < 2 \
                    and time.monotonic() < deadline:
                try:
                    rc.reduce(np.ones(8, np.float32), tenant="bob")
                except resilience.ResilienceError:
                    pass
                time.sleep(0.05)
            np.testing.assert_array_equal(rc.get("feat"), x)
            rc.close()
        finally:
            fleet.stop()


@pytest.mark.slow  # two daemon subprocesses, four churning clients and
# a replica kill, as the JAX file's soak
def test_router_subprocess_fleet_churn_and_kill(tmp_path):
    fleet = serve.Router(str(tmp_path / "sub"), replicas=2, cpu=True,
                         spawn=True).start()
    try:
        errs = []

        def churn(i):
            try:
                rng = np.random.default_rng(i)
                for _r in range(4):
                    with serve.RouterClient(fleet.paths(), tenant=f"t{i}",
                                            timeout=120.0) as rc:
                        x = rng.standard_normal(1 << 15).astype(np.float32)
                        got = rc.scale(x, a=2.0)
                        np.testing.assert_array_equal(
                            got, x * np.float32(2.0))
            except resilience.ResilienceError:
                pass  # classified is an acceptable churn outcome
            except Exception as e:  # pragma: no cover
                errs.append(repr(e))

        threads = [threading.Thread(target=churn, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=240.0)
        assert not errs, errs[:3]
        # kill replica 0 mid-fleet: a fresh RouterClient re-hashes onto
        # the survivor and still serves
        fleet._procs[0].kill()
        fleet._procs[0].wait(timeout=30)
        with serve.RouterClient(fleet.paths(), tenant="after",
                                timeout=120.0) as rc:
            assert abs(rc.reduce(np.ones(64, np.float32)) - 64.0) < 1e-3
    finally:
        fleet.stop()
        serve.reset()


def test_phase26_rehearsal():
    """``chip_smoke.py`` phase 26 on the CPU at a small size: every reply
    of the 4-tenant mix through an in-process fleet equals the direct
    call bit for bit with each tenant's residents on its ring's replica
    alone, each router (site, kind) ends classified at its site, and
    the spawned fleet survives a SIGKILL (re-hash, respawn, journal,
    re-admission) and a rolling restart under load with every reply
    right."""
    from dr_tpu_torch.ops import kernels
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    out = chip.router_phase(dt, kernels, 5, "cpu", device="cpu",
                            replicas=2, tenants=4, res_log2=14,
                            inline_log2=12, k6_n=256, bins=64, k=16)
    assert out["in_process"]["requests"] == 4 * 64
    assert out["chaos"] == {
        f"{s}:{k}": f"{chip.KIND_CLASS[k]}@{s}"
        for s, k in chip.router_sites(faults)}
    sp = out["spawned"]
    assert sp["rate_all"]["requests"] == 4 * 64
    assert sp["rolling_requests"] > 0 and sp["respawn_s"] > 0
