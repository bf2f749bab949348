"""dr_tpu_torch's serving control plane, the router aside: the shared
retry budget, the graceful drain and the crash-safe resident journal
(``dr_tpu_torch/serve``), against dr_tpu's.

Mirrors the budget, drain and journal cases of
``tests/test_serve_controlplane.py`` (``test_token_budget_spend_refill``
to ``test_client_retries_draw_shared_budget``,
``test_drain_completes_inflight_then_stops`` to
``test_drain_wire_op_fault_classified``, and
``test_journal_replay_restores_residents`` to
``test_degradation_story_controlplane_counters``) on
``dt.init(["cpu"] * 8)`` with ``Server(cpu=True)``; the breaker, fleet,
rolling-restart and respawn cases are in
``tests/test_torch_serve_router.py``.  The
story case reads ``resilience.session_story`` (the port's counterpart of
``degradation_story``) from the ``_DR_GPU_SERVE_*`` markers.  The
journal parity case reads each package's journal file with the other's
reader.
"""

import os
import threading
import time

import numpy as np
import pytest

import dr_tpu_torch as dt
from dr_tpu_torch import serve
from dr_tpu_torch.serve import journal as journal_mod
from dr_tpu_torch.utils import elastic, faults, resilience
from dr_tpu_torch.utils.env import env_int

P = 8
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
    srv = serve.Server(str(tmp_path / "cp.sock"), cpu=True,
                       state_dir=str(tmp_path / "state"))
    srv.start()
    yield srv
    srv.stop()


def _client(srv, **kw):
    kw.setdefault("timeout", 60.0)
    return serve.Client(srv.path, **kw)


def _restart(server, tmp_path):
    return serve.Server(server.path, cpu=True,
                        state_dir=str(tmp_path / "state")).start()


# ---------------------------------------------------------------------------
# retry budget
# ---------------------------------------------------------------------------

def test_token_budget_spend_refill():
    b = resilience.TokenBudget(2, ratio=0.5)
    assert b.spend() and b.spend() and not b.spend()
    b.note_success()
    assert not b.spend()  # half a token is not a whole one
    b.note_success()
    assert b.spend()
    snap = b.snapshot()
    assert snap["spent"] == 3 and snap["denied"] == 2


def test_retry_budget_exhausted_fails_fast():
    calls = []

    def boom():
        calls.append(1)
        raise resilience.TransientBackendError("UNAVAILABLE: synthetic")

    t0 = time.perf_counter()
    with pytest.raises(resilience.TransientBackendError):
        resilience.retry(boom, attempts=8, base=5.0,
                         budget=resilience.TokenBudget(0))
    assert len(calls) == 1
    assert time.perf_counter() - t0 < 1.0


def test_client_retries_draw_shared_budget(server):
    budget = resilience.TokenBudget(1, ratio=0.0)
    with faults.injected("serve.request", "transient",
                         times=None) as sp:
        with _client(server, retries=5, budget=budget) as c:
            with pytest.raises(resilience.TransientBackendError):
                c.reduce(X)
            first = sp.fired
            assert first == 2  # initial attempt + the one budgeted retry
            with pytest.raises(resilience.TransientBackendError):
                c.reduce(X)
            assert sp.fired == first + 1
    with _client(server, retries=5,
                 budget=resilience.TokenBudget(4, ratio=1.0)) as c:
        assert abs(c.reduce(np.ones(8, np.float32)) - 8.0) < 1e-3


def test_shared_retry_budget_reads_the_port_variables(monkeypatch):
    monkeypatch.setenv("DR_TPU_SERVE_RETRY_BUDGET", "99")
    monkeypatch.setenv("DR_GPU_SERVE_RETRY_BUDGET", "3")
    serve.reset_retry_budget()
    b = serve.shared_retry_budget()
    assert b is serve.shared_retry_budget()
    assert b.snapshot()["capacity"] == 3
    serve.reset_retry_budget()
    assert serve.shared_retry_budget() is not b


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------

def test_drain_completes_inflight_then_stops(tmp_path):
    srv = serve.Server(str(tmp_path / "d.sock"), batch_window=0.0,
                       cpu=True)
    srv.start()
    try:
        srv.hold()
        res = {}

        def worker():
            with _client(srv) as c:
                res["got"] = c.reduce(np.ones(32, np.float32))

        t = threading.Thread(target=worker)
        t.start()
        deadline = time.monotonic() + 10.0
        while len(srv._queue) == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(srv._queue) == 1
        dth = threading.Thread(target=srv.drain)
        dth.start()
        deadline = time.monotonic() + 10.0
        while not srv.draining() and time.monotonic() < deadline:
            time.sleep(0.005)
        with _client(srv) as c2:
            assert c2.ping().get("draining") is True
            with pytest.raises(resilience.ServerDraining):
                c2.reduce(np.ones(8, np.float32))
        assert not srv._stopped.is_set()
        srv.release()
        dth.join(timeout=30.0)
        t.join(timeout=30.0)
        assert abs(res["got"] - 32.0) < 1e-3  # in-flight COMPLETED
        assert srv._stopped.is_set()
        assert srv._drains == 1 and srv._drain_rejects == 1
        assert env_int("_DR_GPU_SERVE_DRAINS", 0, floor=0) >= 1
        # a planned drain alone tells no story
        assert resilience.session_story() is None
    finally:
        srv.release()
        srv.stop()


def test_drain_wire_op_stops_daemon(server):
    with _client(server) as c:
        ack = c.drain()
        assert ack.get("draining") is True
    deadline = time.monotonic() + 10.0
    while not server._stopped.is_set() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server._stopped.is_set()
    with pytest.raises(resilience.RelayDownError):
        serve.Client(server.path, timeout=5.0)


def test_drain_fault_site_classified(server):
    with faults.injected("serve.drain", "program") as sp:
        with pytest.raises(resilience.ProgramError):
            server.drain()
        assert sp.fired == 1
    assert not server.draining()
    with _client(server) as c:
        assert abs(c.reduce(np.ones(8, np.float32)) - 8.0) < 1e-3


def test_drain_wire_op_fault_classified(server):
    with faults.injected("serve.drain", "program") as sp:
        with _client(server) as c:
            with pytest.raises(resilience.ProgramError):
                c.drain()
            assert sp.fired == 1
    assert not server.draining()
    with _client(server) as c:
        assert abs(c.reduce(np.ones(8, np.float32)) - 8.0) < 1e-3


# ---------------------------------------------------------------------------
# crash-safe resident journal
# ---------------------------------------------------------------------------

def test_journal_replay_restores_residents(tmp_path, server):
    with _client(server) as c:
        c.put("a", X)
        c.put("b", X * 2)
        c.put("gone", X * 3)
        c.drop("gone")
        appends = server._journal.appends
        c.put("a", X)
        assert server._journal.appends == appends
    server.stop()
    srv2 = _restart(server, tmp_path)
    try:
        with _client(srv2) as c:
            np.testing.assert_array_equal(c.get("a"), X)
            np.testing.assert_array_equal(c.get("b"), X * 2)
            with pytest.raises(resilience.ProgramError):
                c.get("gone")
            assert abs(c.reduce(serve.Ref("b")) - 2 * X.sum()) < 1e-2
        st = srv2.stats()["journal"]
        assert st["replayed"] == 2 and st["live"] == 2
        assert env_int("_DR_GPU_SERVE_JOURNAL_RECOVERED", 0,
                       floor=0) == 2
        story = resilience.session_story()
        # a clean replay after a clean stop is NOT a story
        assert story is None or "journal_recovered" in story["serve"]
    finally:
        srv2.stop()


def test_journal_torn_tail_truncates_cleanly(tmp_path, server):
    with _client(server) as c:
        c.put("keep", X)
    server.stop()
    jr = journal_mod.Journal(str(tmp_path / "state"), server.path)
    good = os.path.getsize(jr.path)
    with open(jr.path, "ab") as fh:
        fh.write(b"\x20\x00\x00\x00\x10")  # half a record prefix
    with pytest.raises(resilience.CheckpointCorruptError):
        jr.scan()
    srv2 = _restart(server, tmp_path)
    try:
        with _client(srv2) as c:
            np.testing.assert_array_equal(c.get("keep"), X)
        assert os.path.getsize(jr.path) >= good
        assert env_int("_DR_GPU_SERVE_JOURNAL_TRUNCATED", 0,
                       floor=0) == 5
        story = resilience.session_story()
        assert story is not None
        assert story["serve"]["journal_truncated"] == 5
        assert story["reason"] == "journal tail truncated (5 bytes)"
    finally:
        srv2.stop()


def test_journal_corrupt_payload_classified(tmp_path):
    jr = journal_mod.Journal(str(tmp_path / "jc"), "/tmp/x.sock")
    jr.claim()
    jr.append("put", "t", "n", "tag",
              np.arange(8, dtype=np.float32).tobytes())
    with open(jr.path, "r+b") as fh:
        fh.seek(-2, os.SEEK_END)
        fh.write(b"\xff\xff")
    with pytest.raises(resilience.CheckpointCorruptError):
        jr.scan()
    assert jr.replay() == {}
    assert jr.truncated_bytes > 0


def test_journal_stale_generation_fenced(tmp_path, server):
    with _client(server) as c:
        c.put("a", X)
        journal_mod.Journal(str(tmp_path / "state"), server.path).claim()
        with pytest.raises(resilience.ProgramError):
            c.put("b", X * 2)
    deadline = time.monotonic() + 10.0
    while not server._stopped.is_set() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server._stopped.is_set()
    assert server._journal.fenced
    assert "fenced" in (server.degraded or "")


def test_journal_append_fault_degrades_durability_only(server):
    with faults.injected("serve.journal", "transient") as sp:
        with _client(server) as c:
            c.put("soft", X)
            assert sp.fired == 1
            np.testing.assert_array_equal(c.get("soft"), X)
    assert server._journal_errors == 1
    assert any("durability degraded" in n
               for n in server.stats()["notes"])


def test_journal_replay_fault_starts_empty(tmp_path, server):
    with _client(server) as c:
        c.put("a", X)
    server.stop()
    with faults.injected("serve.journal", "program") as sp:
        srv2 = _restart(server, tmp_path)
        try:
            assert sp.fired >= 1
            with _client(srv2) as c:
                with pytest.raises(resilience.ProgramError):
                    c.get("a")
                assert abs(c.reduce(np.ones(8, np.float32)) - 8.0) < 1e-3
        finally:
            srv2.stop()


def test_journal_compact_fault_keeps_replayed_residents(tmp_path, server):
    with _client(server) as c:
        c.put("a", X)
    server.stop()
    with faults.injected("serve.journal", "transient", after=1) as sp:
        srv2 = _restart(server, tmp_path)
        try:
            assert sp.fired == 1
            with _client(srv2) as c:
                np.testing.assert_array_equal(c.get("a"), X)
        finally:
            srv2.stop()


def test_journal_append_oserror_degrades_durability_only(server):
    with _client(server) as c:
        server._journal.path = os.path.join(
            os.path.dirname(server._journal.path), "missing-dir",
            "j.journal")
        c.put("soft", X)
        np.testing.assert_array_equal(c.get("soft"), X)
    assert server._journal_errors == 1


def test_journal_replay_oserror_starts_empty(tmp_path, server):
    with _client(server) as c:
        c.put("a", X)
    server.stop()
    jr = journal_mod.Journal(str(tmp_path / "state"), server.path)
    os.unlink(jr.path)
    os.makedirs(jr.path)  # open("rb") now raises IsADirectoryError
    srv2 = _restart(server, tmp_path)
    try:
        with _client(srv2) as c:
            with pytest.raises(resilience.ProgramError):
                c.get("a")
            assert abs(c.reduce(np.ones(8, np.float32)) - 8.0) < 1e-3
    finally:
        srv2.stop()


def test_journal_unavailable_state_dir_serves_without_durability(
        tmp_path):
    bad = tmp_path / "statefile"
    bad.write_text("not a dir")
    srv = serve.Server(str(tmp_path / "cp2.sock"), cpu=True,
                       state_dir=str(bad))
    srv.start()
    try:
        assert srv._journal is None
        with _client(srv) as c:
            c.put("a", X)
            np.testing.assert_array_equal(c.get("a"), X)
    finally:
        srv.stop()


def test_journal_state_dir_from_the_port_variable(tmp_path, monkeypatch):
    monkeypatch.setenv("DR_TPU_SERVE_STATE_DIR", str(tmp_path / "jax"))
    assert serve.Server(str(tmp_path / "v.sock")).state_dir is None
    monkeypatch.setenv("DR_GPU_SERVE_STATE_DIR", str(tmp_path / "gpu"))
    assert serve.Server(str(tmp_path / "v.sock")).state_dir == \
        str(tmp_path / "gpu")


def test_parity_journal_files_cross_read(tmp_path):
    """A journal either package wrote replays in the other, record for
    record and bit for bit (the same record format and file name)."""
    from dr_tpu.serve import journal as jjournal
    rng = np.random.default_rng(3)
    vals = {f"v{i}": rng.standard_normal(17 + i).astype(np.float32)
            for i in range(3)}
    for writer, reader in ((jjournal, journal_mod),
                           (journal_mod, jjournal)):
        d = str(tmp_path / writer.__name__.replace(".", "_"))
        w = writer.Journal(d, "/tmp/p.sock")
        w.claim()
        for name, v in vals.items():
            w.append("put", "t", name, "tag-" + name, _npy(v))
        w.append("drop", "t", "v1")
        r = reader.Journal(d, "/tmp/p.sock")
        assert r.path == w.path
        live = r.replay()
        assert set(live) == {("t", "v0"), ("t", "v2")}
        for (_t, name), (tag, payload) in live.items():
            assert tag == "tag-" + name
            got = reader.decode_payload(payload)
            np.testing.assert_array_equal(got.view(np.uint8),
                                          vals[name].view(np.uint8))
        jjournal.reset_state()
        journal_mod.reset_state()


def _npy(v):
    from dr_tpu_torch.serve.arena import npy_bytes
    return npy_bytes(v)


# ---------------------------------------------------------------------------
# story
# ---------------------------------------------------------------------------

def test_session_story_controlplane_counters(monkeypatch):
    for m, v in (("_DR_GPU_SERVE_RESPAWNS", "2"),
                 ("_DR_GPU_SERVE_DRAINS", "3"),
                 ("_DR_GPU_SERVE_ROUTER_RECOVERED", "1"),
                 ("_DR_GPU_SERVE_JOURNAL_RECOVERED", "4")):
        monkeypatch.setenv(m, v)
    story = resilience.session_story()
    assert story is not None  # respawns alone make it a story
    assert story["serve"]["respawns"] == 2
    assert story["serve"]["drains"] == 3
    assert story["serve"]["router_recovered"] == 1
    assert story["serve"]["journal_recovered"] == 4
    assert "respawned" in story["reason"]


def test_session_story_serve_chapter_matches_the_jax_package():
    """The serve chapter has the JAX package's keys and values for the
    same markers (each package reads its own names)."""
    from dr_tpu.utils import resilience as jres
    marks = {"DEGRADED": "serve: device loss mid-batch",
             "QUEUE_DEPTH": "5", "SHED": "1", "RESTARTS": "0",
             "DRAINS": "2", "JOURNAL_RECOVERED": "3",
             "JOURNAL_TRUNCATED": "9", "ROUTER_DEAD": "1",
             "ROUTER_REASON": "re-hashed"}
    j = jres.degradation_story({f"_DR_TPU_SERVE_{k}": v
                                for k, v in marks.items()})
    t = resilience.session_story({f"_DR_GPU_SERVE_{k}": v
                                  for k, v in marks.items()})
    assert t["serve"] == j["serve"]
    assert t["reason"] == j["reason"]
    quiet = {"QUEUE_DEPTH": "5", "SHED": "0", "RESTARTS": "0",
             "DRAINS": "1"}
    assert resilience.session_story(
        {f"_DR_GPU_SERVE_{k}": v for k, v in quiet.items()}) is None
    assert jres.degradation_story(
        {f"_DR_TPU_SERVE_{k}": v for k, v in quiet.items()}) is None
