"""dr_tpu_torch's elastic shrink and grow-back (``dr_tpu_torch/utils/
elastic.py``) against dr_tpu's.

Mirrors the single-process cases of ``tests/test_elastic.py``.  Each
case runs the same loss on the same rank through dr_tpu on its 8-device
CPU mesh and through ``dt.init(["cpu"] * 8)``, and compares the fates,
``nprocs_after``, the rows rank by rank and the story's ``shrink`` and
``grow`` fields (``resilience.session_story`` against
``degradation_story``), wall times aside.  The data are integers or
arange floats, so every comparison is bit for bit; a case whose data
could hold -0.0 on an uneven layout compares the port against numpy
instead (dr_tpu's readback drops the sign there).

Elsewhere or left out:

* the ``redistribute`` cases (``test_redistribute_roundtrip_and_
  validation``, ``_cross_runtime``, ``_matrix_reblock``,
  ``_halo_vector``, ``test_failed_redistribute_leaves_vector_intact``,
  ``test_redistribute_collective_forced_vs_host_bit_identical``,
  ``test_redistribute_exchange_fault_leaves_vector_intact`` and
  ``test_redistribute_forced_collective_cross_mesh_falls_back``) are in
  ``tests/test_torch_redistribute.py``;
* the serving daemon's mesh cases are here:
  ``test_serve_daemon_survives_device_loss``, the ``"serve"`` arm of
  ``test_chaos_device_loss_every_kind``,
  ``test_serve_mesh_growback_between_batches`` and
  ``test_serve_shrink_recorded_even_when_replay_fails``, each daemon a
  ``serve.Server(cpu=True)`` on the 8 CPU ranks;
* not carried over: the daemon's route re-promotion cases
  (``test_serve_requested_cpu_route_is_pinned``,
  ``test_serve_repromotion_end_to_end`` and
  ``test_serve_promotion_grow_fault_stays_on_cpu_route``).  They test a
  daemon that degraded to the CPU route finding its way back to the
  device; the port's daemon never leaves its requested route, so there
  is no degraded route to pin or to leave (``tests/test_torch_serve.py::
  test_serve_flush_relay_down_fails_classified_same_ranks``);
* ``test_multihost_killed_worker_downgrades_mesh`` (two processes, a
  killed worker, the survivor's shrink) is carried over in
  ``tests/test_torch_multiprocess_host.py``, which spawns its own gloo
  processes: ``test_killed_worker_shrinks_survivors`` and
  ``test_killed_worker_flush_replays``.
"""

import gc
import os
import subprocess
import sys
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.utils import elastic as jelastic
from dr_tpu.utils import faults as jfaults
from dr_tpu.utils import resilience as jres
from dr_tpu.utils.env import env_override as jenv_override
from dr_tpu_torch.utils import elastic, faults, resilience
from dr_tpu_torch.utils.env import env_override

P = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Pkg:
    """One package's handles, so a case runs the same steps on both."""

    def __init__(self, m, el, res, flt, env, pre, story):
        self.m, self.elastic, self.res, self.faults = m, el, res, flt
        self._env, self._pre, self._story = env, pre, story

    def env(self, **kw):
        return self._env(**{self._pre + k: v for k, v in kw.items()})

    def init(self, p=P):
        if self.m is dt:
            return dt.init(["cpu"] * p)
        return dr_tpu.init(jax.devices()[:p])

    def rows(self, v):
        if self.m is dt:
            return np.concatenate([r.cpu().numpy() for r in v.rows])
        return np.asarray(v._data)

    def story(self):
        """The shrink and grow chapters without their wall times (a
        reason that names a variable names it without the prefix)."""
        s = self._story()
        if s is None:
            return None
        return {ch: {k: v.replace(self._pre, "DR_") if isinstance(v, str)
                     else v for k, v in s[ch].items() if k != "wall_s"}
                for ch in ("shrink", "grow") if ch in s}


J = _Pkg(dr_tpu, jelastic, jres, jfaults, jenv_override, "DR_TPU_",
         jres.degradation_story)
T = _Pkg(dt, elastic, resilience, faults, env_override, "DR_GPU_",
         resilience.session_story)
BOTH = (J, T)


@pytest.fixture(autouse=True)
def _fresh():
    dt.init(["cpu"] * P)
    elastic.reset()
    dt.tuning.clear_session()
    dt.tuning.reload()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", elastic.ElasticWarning)
        yield
    faults.clear()
    elastic.reset()
    dt.tuning.clear_session()
    dt.tuning.reload()
    for mk in elastic.MARKERS + elastic.GROW_MARKERS:
        os.environ.pop(mk, None)
    serve = sys.modules.get("dr_tpu_torch.serve")
    if serve is not None:
        serve.reset()  # a daemon a failed case leaked, and its markers
    dt.final()


@pytest.fixture
def _dirs(tmp_path):
    """A checkpoint directory for each package."""
    for k in BOTH:
        os.makedirs(tmp_path / k._pre, exist_ok=True)
    return tmp_path


def _half(x):
    return x * 0.5


def _mul(x, c):
    return x * c


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _report(rep):
    """A shrink report's counts and fates (the live set is a weak set:
    its order is not the creation order)."""
    return (rep.rescued, rep.restored, rep.lost, rep.nprocs_before,
            rep.nprocs_after, sorted(f[:2] for f in rep.fates))


# ---------------------------------------------------------------------------
# taxonomy and attribution
# ---------------------------------------------------------------------------

def test_device_lost_classification():
    for k in BOTH:
        R = k.res
        assert R.classify("DEVICE_LOST: chip unavailable") \
            is R.DeviceLostError
        assert R.classify("DATA_LOSS: hbm contents gone") \
            is R.DeviceLostError
        e = R.DeviceLostError("x", rank=3)
        assert R.classified(e) is e and e.rank == 3
    # a CUDA launch failure text of a lost card
    assert resilience.classify(
        "CUDA error: unspecified launch failure; device lost") \
        is resilience.DeviceLostError


def test_attribute_collective_failure():
    for k in BOTH:
        raw = k.res.TransientBackendError("UNAVAILABLE: peer gone",
                                          site="collectives.shift")
        de = k.elastic.attribute(raw, 2)
        assert isinstance(de, k.res.DeviceLostError)
        assert (de.rank, de.site) == (2, "collectives.shift")
        assert de.__cause__ is raw
        assert str(de) == "rank 2 presumed lost: TransientBackendError: " \
            "UNAVAILABLE: peer gone"


def test_device_lost_fault_site_registered():
    assert faults.sites() == jfaults.sites()
    assert faults.sites()["device.lost"] == ("device_lost",)
    for site in ("mesh.shrink", "mesh.grow", "device.recover"):
        assert set(faults.sites()[site]) == {"transient", "program"}
        assert site not in faults.PORT_PENDING
    for k in BOTH:
        with k.faults.injected("device.lost", "device_lost", times=1):
            with pytest.raises(k.res.DeviceLostError):
                k.m.fill(k.m.distributed_vector(8), 1.0)


# ---------------------------------------------------------------------------
# the rescue / restore / lost matrix
# ---------------------------------------------------------------------------

def _fates_case(k, tmp):
    k.init()
    n = 4 * P
    src = np.arange(n, dtype=np.float32)
    team = k.m.distributed_vector.from_array(
        src, distribution=[n] + [0] * (P - 1))
    ck = k.m.distributed_vector.from_array(src)
    k.m.checkpoint.save(os.path.join(tmp, "ck.npz"), ck)
    ck.put(np.arange(4), np.full(4, 99.0, np.float32))  # rank 0's window
    gone = k.m.distributed_vector.from_array(src * 3)
    rep = k.elastic.rescue_session(k.res.DeviceLostError("test loss",
                                                         rank=P - 1))
    out = {"report": _report(rep), "nprocs": k.m.nprocs(),
           "team": k.rows(team), "ck": k.rows(ck),
           "team_v": k.m.to_numpy(team), "ck_v": k.m.to_numpy(ck)}
    for use in (lambda: k.m.to_numpy(gone), lambda: k.m.fill(gone, 0.0)):
        with pytest.raises(k.res.DeviceLostError):
            use()
    out["story"] = k.story()
    k.elastic.reset()
    out["story_after_reset"] = k.story()
    return out


def test_rescue_matrix_fates(_dirs):
    """One shrink, three fates: a team vector off the lost rank is
    rescued, a checkpointed vector restored per segment (the survivor's
    write after the checkpoint stays), an uncheckpointed one lost."""
    got = {k: _fates_case(k, str(_dirs / k._pre)) for k in BOTH}
    t, j = got[T], got[J]
    assert t["report"] == j["report"]
    assert t["report"][:3] == (1, 1, 1) and t["nprocs"] == P - 1
    src = np.arange(4 * P, dtype=np.float32)
    expect = src.copy()
    expect[:4] = 99.0  # the survivor keeps its write after the checkpoint
    _same(t["team_v"], src)
    _same(t["ck_v"], expect)
    for key in ("team", "ck", "team_v", "ck_v"):
        _same(t[key], j[key])
    assert t["story"] == j["story"]
    assert t["story"]["shrink"]["lost_ranks"] == str(P - 1)
    assert t["story_after_reset"] is None is j["story_after_reset"]


def test_rescue_restores_matrix_container(_dirs):
    got = {}
    for k in BOTH:
        k.init()
        src = np.arange(4 * P * 3, dtype=np.float32).reshape(4 * P, 3)
        m = k.m.dense_matrix.from_array(src, k.m.row_tiles())
        k.m.checkpoint.save(str(_dirs / k._pre / "m.npz"), m)
        m2 = k.m.dense_matrix.from_array(src * 2, k.m.row_tiles())
        rep = k.elastic.rescue_session(k.res.DeviceLostError("loss",
                                                             rank=0))
        with pytest.raises(k.res.DeviceLostError):
            m2.materialize()
        got[k] = (_report(rep), m.materialize(), k.story())
    assert got[T][0] == got[J][0]
    assert got[T][0][1] >= 1 and got[T][0][2] >= 1
    _same(got[T][1], got[J][1])
    _same(got[T][1], np.arange(4 * P * 3, dtype=np.float32)
          .reshape(4 * P, 3))
    assert got[T][2] == got[J][2]


def test_min_devices_floor():
    for k in BOTH:
        k.init()
        with k.env(ELASTIC_MIN_DEVICES=str(P)):
            with pytest.raises(k.res.DeviceLostError):
                k.elastic.rescue_session(k.res.DeviceLostError("loss",
                                                               rank=0))
        assert k.m.nprocs() == P  # nothing shrank
    assert T.story() == J.story()
    assert T.story()["shrink"]["reason"].startswith("shrink failed")


def test_mesh_shrink_fault_fails_rescue_cleanly():
    for k in BOTH:
        k.init()
        v = k.m.distributed_vector.from_array(np.arange(8,
                                                        dtype=np.float32))
        with k.faults.injected("mesh.shrink", "transient", times=1) as sp:
            with pytest.raises(k.res.TransientBackendError) as ei:
                k.elastic.rescue_session(k.res.DeviceLostError(
                    "loss", rank=P - 1))
            assert sp.fired == 1 and ei.value.site == "mesh.shrink"
        assert k.m.nprocs() == P
        _same(k.m.to_numpy(v), np.arange(8, dtype=np.float32))


def test_invalid_rank_attribution_raises():
    for k in BOTH:
        k.init()
        with pytest.raises(k.res.ProgramError):
            k.elastic.rescue_session(lost_ranks=[P + 5])
        with pytest.raises(k.res.ProgramError):
            k.elastic.rescue_session(k.res.DeviceLostError("stale",
                                                           rank=P))
        assert k.m.nprocs() == P


def test_gather_failure_falls_back_to_checkpoint(_dirs):
    """A second fault on the rescue's gather does not poison a
    checkpointed container: its fate becomes a whole restore."""
    got = {}
    for k in BOTH:
        k.init()
        src = np.arange(3 * P, dtype=np.float32)
        team = k.m.distributed_vector.from_array(
            src, distribution=[len(src)] + [0] * (P - 1))
        k.m.checkpoint.save(str(_dirs / k._pre / "g.npz"), team)
        with k.faults.injected("device.lost", "device_lost", times=1):
            rep = k.elastic.rescue_session(
                k.res.DeviceLostError("loss", rank=P - 1))
        got[k] = (_report(rep), k.rows(team))
        _same(k.m.to_numpy(team), src)
    assert got[T][0] == got[J][0]
    assert got[T][0][:3] == (0, 1, 0)
    assert got[T][0][5] == [("restore", "distributed_vector")]
    _same(got[T][1], got[J][1])


def test_checkpoint_registry_prunes_dead_containers(tmp_path):
    for k in BOTH:
        k.init()
        before = len(k.elastic._ckpts)
        v = k.m.distributed_vector.from_array(np.arange(8,
                                                        dtype=np.float32))
        k.m.checkpoint.save(str(tmp_path / f"{k._pre}p.npz"), v)
        assert len(k.elastic._ckpts) == before + 1
        assert k.elastic.checkpoint_path(v).endswith(f"{k._pre}p.npz")
        del v
        gc.collect()
        assert len(k.elastic._ckpts) == before


def _sparse_case(k, d):
    k.init()
    n = 2 * P
    rows = np.arange(n)
    cols = np.tile(np.arange(2), P)
    vals = np.arange(n, dtype=np.float32)
    sm = k.m.sparse_matrix.from_coo((n, 4), rows, cols, vals)
    k.m.checkpoint.save(str(d / "sp.npz"), sm)
    rep = k.elastic.rescue_session(k.res.DeviceLostError("loss", rank=0))
    dense = np.zeros((n, 4), np.float32)
    for seg in sm.__dr_segments__():
        r, c, v = seg.triples()
        dense[r, c] = v
    y = k.m.distributed_vector(n)
    k.m.fill(y, 0.0)
    k.m.gemv(y, sm, np.ones(4, np.float32))
    return _report(rep), rep.fates, dense, k.m.to_numpy(y)


def test_sparse_matrix_restores_per_tile(_dirs):
    got = {k: _sparse_case(k, _dirs / k._pre) for k in BOTH}
    assert got[T][0] == got[J][0]
    assert got[T][0][1] == 1 and got[T][0][2] == 0
    assert ("restore", "sparse_matrix", "snap") in got[T][1]
    n = 2 * P
    expect = np.zeros((n, 4), np.float32)
    expect[np.arange(n), np.tile(np.arange(2), P)] = np.arange(
        n, dtype=np.float32)
    _same(got[T][2], expect)
    _same(got[T][2], got[J][2])
    _same(got[T][3], got[J][3])
    _same(got[T][3], expect @ np.ones(4, np.float32))


def test_dense_matrix_restores_per_tile(_dirs):
    got = {}
    for k in BOTH:
        k.init()
        src = np.arange(4 * P * 3, dtype=np.float32).reshape(4 * P, 3)
        m = k.m.dense_matrix.from_array(src, k.m.row_tiles())
        k.m.checkpoint.save(str(_dirs / k._pre / "pt.npz"), m)
        m[0, 0] = 99.0            # rank 0's tile survives: stays live
        m[4 * P - 1, 2] = -77.0   # the last rank's tile dies: rewinds
        rep = k.elastic.rescue_session(
            k.res.DeviceLostError("loss", rank=P - 1))
        got[k] = (_report(rep), rep.fates, m.materialize())
    assert got[T][0] == got[J][0]
    assert got[T][0][1:3] == (1, 0)
    assert ("restore", "dense_matrix", "snap") in got[T][1]
    expect = np.arange(4 * P * 3, dtype=np.float32).reshape(4 * P, 3)
    expect[0, 0] = 99.0
    _same(got[T][2], expect)
    _same(got[T][2], got[J][2])


def test_every_container_kind_is_poisoned_when_lost():
    """The lost fate on each container of the port: the class swap works
    on a vector, a dense and a sparse matrix and an mdarray, and every
    use raises the classified loss, a deferred record included."""
    n = 4 * P
    v = dt.distributed_vector.from_array(np.arange(n, dtype=np.float32))
    dm = dt.dense_matrix.from_array(np.ones((P, 4), np.float32))
    sm = dt.sparse_matrix.from_coo((n, n), np.arange(n), np.arange(n),
                                   np.ones(n, np.float32))
    md = dt.distributed_mdarray.from_array(np.ones((P, 2, 3), np.float32))
    rep = elastic.rescue_session(resilience.DeviceLostError("loss", rank=0))
    assert rep.lost == 4 and rep.rescued == rep.restored == 0
    for c in (v, dm, sm, md):
        assert elastic.is_lost(c) and type(c).__name__.startswith("Lost")
        assert isinstance(c, type(c).__mro__[1])
        with pytest.raises(resilience.DeviceLostError) as ei:
            c.materialize()
        assert ei.value.site == "device.lost"
    for use in (lambda: dt.fill(v, 1.0), lambda: dt.to_numpy(v),
                lambda: dt.reduce(v), lambda: dt.to_numpy(dm),
                lambda: dt.gemv(dt.distributed_vector(n), sm,
                                np.ones(n, np.float32))):
        with pytest.raises(resilience.DeviceLostError):
            use()
    w = dt.distributed_vector(n)
    with pytest.raises(resilience.DeviceLostError):
        with dt.deferred():
            dt.fill(w, 1.0)
            dt.fill(v, 1.0)
    assert not elastic.is_lost(w)


# ---------------------------------------------------------------------------
# the automatic hooks: retry and the flush
# ---------------------------------------------------------------------------

def _retry_case(k, d):
    k.init()
    n = 4 * P
    src = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    v = k.m.distributed_vector.from_array(src)
    k.m.checkpoint.save(str(d / "v.npz"), v)
    with k.env(ELASTIC="1"):
        with k.faults.injected("device.lost", "device_lost",
                               times=1) as sp:
            k.res.retry(lambda: k.m.sort(v), attempts=2,
                        sleep=lambda s: None)
            assert sp.fired == 1
    return k.m.nprocs(), k.m.to_numpy(v), v.layout, k.story()


def test_eager_retry_shrinks_and_recovers(_dirs):
    """A loss under ``retry`` with elastic armed: shrink, restore, the
    sort again on 7 ranks.  (The sort leaves its own pad cells, which
    differ between the packages: the layouts and values are compared.)"""
    got = {k: _retry_case(k, _dirs / k._pre) for k in BOTH}
    src = np.random.default_rng(5).standard_normal(4 * P).astype(np.float32)
    assert got[T][0] == got[J][0] == P - 1
    _same(got[T][1], np.sort(src))
    _same(got[T][1], got[J][1])
    assert got[T][2] == tuple(got[J][2])
    assert got[T][3] == got[J][3]


def test_eager_loss_without_elastic_is_classified():
    for k in BOTH:
        k.init()
        v = k.m.distributed_vector.from_array(np.arange(8,
                                                        dtype=np.float32))
        slept = []
        with k.faults.injected("device.lost", "device_lost", times=1):
            with pytest.raises(k.res.DeviceLostError):
                k.res.retry(lambda: k.m.sort(v), attempts=3,
                            sleep=slept.append)
        assert k.m.nprocs() == P and not slept
        assert k.story() is None


def _flush_case(k, d, relayout=False):
    k.init()
    n = 4 * P
    src = np.arange(n, dtype=np.float32)
    v = k.m.distributed_vector.from_array(src)
    k.m.checkpoint.save(str(d / "v.npz"), v)
    with k.env(ELASTIC="1"):
        with k.faults.injected("device.lost", "device_lost", times=1):
            with k.m.deferred() as p:
                k.m.fill(v, 2.0)
                if relayout:
                    k.m.redistribute(v, None)
                k.m.for_each(v, _half)
                tot = k.m.reduce(v)
    return (float(tot), k.m.to_numpy(v), k.rows(v), k.m.nprocs(),
            [e["reason"] for e in p.log],
            [e.get("elastic_replayed") for e in p.log], k.story())


@pytest.mark.parametrize("relayout", [False, True],
                         ids=["plain", "with_redistribute"])
def test_plan_flush_replay(_dirs, relayout):
    """A loss at the flush: the unexecuted queue (a recorded re-layout
    included, which undoes first) records again on the shrunken runtime
    and flushes with reason "elastic replay"; the handle resolves."""
    got = {k: _flush_case(k, _dirs / k._pre, relayout) for k in BOTH}
    n = 4 * P
    t, j = got[T], got[J]
    assert t[0] == j[0] == n
    _same(t[1], np.ones(n, np.float32))
    _same(t[2], j[2])
    assert t[3] == j[3] == P - 1
    assert "elastic replay" in t[4]
    assert t[4] == j[4]
    assert any(t[5]) and t[5] == j[5]
    assert t[6] == j[6]


def test_plan_flush_loss_without_elastic_drops_queue():
    for k in BOTH:
        k.init()
        n = 4 * P
        src = np.arange(n, dtype=np.float32)
        v = k.m.distributed_vector.from_array(src)
        with k.faults.injected("device.lost", "device_lost", times=1):
            with pytest.raises(k.res.DeviceLostError):
                with k.m.deferred():
                    k.m.fill(v, 2.0)
                    tot = k.m.reduce(v)
        _same(k.m.to_numpy(v), src)
        with pytest.raises(RuntimeError):
            float(tot)
        assert k.m.nprocs() == P


def _serve_pkg(k):
    """The package's ``serve`` module."""
    import importlib
    return importlib.import_module(k.m.__name__ + ".serve")


def _server(k, path):
    srv = _serve_pkg(k).Server
    return (srv(path, batch_window=0.0, cpu=True) if k is T
            else srv(path, batch_window=0.0)).start()


@pytest.mark.parametrize("kind", ["eager", "plan", "serve"])
def test_chaos_device_loss_every_kind(kind, _dirs):
    """An injected loss at each dispatch kind ends in the right result on
    the shrunken runtime, with the shrink chapter in the story."""
    n = 4 * P
    src = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    got = {}
    for k in BOTH:
        k.init()

        def run():
            if kind == "serve":
                srv = _server(k, str(_dirs / f"{k._pre}c.sock"))
                try:
                    with _serve_pkg(k).Client(srv.path, timeout=60.0) as c:
                        k.faults.inject("device.lost", "device_lost",
                                        times=1)
                        return (c.scale(src, a=2.0, b=1.0),
                                src * 2.0 + 1.0)
                finally:
                    srv.stop()
                    _serve_pkg(k).reset()
            v = k.m.distributed_vector.from_array(src)
            k.m.checkpoint.save(str(_dirs / k._pre / "c.npz"), v)
            k.faults.inject("device.lost", "device_lost", times=1)
            if kind == "eager":
                k.res.retry(lambda: k.m.sort(v), attempts=2,
                            sleep=lambda s: None)
                return k.m.to_numpy(v), np.sort(src)
            with k.m.deferred():
                k.m.for_each(v, _half)
            return k.m.to_numpy(v), src * 0.5

        with k.env(ELASTIC="1"):
            try:
                res = k.res.with_deadline(run, 120.0, site=f"e:{kind}",
                                          dump=False)
            finally:
                k.faults.clear()
        got[k] = res + (k.m.nprocs(), k.story())
    _same(got[T][0], got[T][1])
    _same(got[T][0], got[J][0])
    assert got[T][2] == got[J][2] == P - 1
    assert got[T][3] == got[J][3] and got[T][3]["shrink"]["shrinks"] == 1


def test_retry_shrink_takes_no_budget_token_and_no_sleep(_dirs):
    """The shrink paid the recovery: no backoff sleep, no budget token;
    the retry event says ``shrunk``."""
    v = dt.distributed_vector.from_array(np.arange(4 * P, dtype=np.float32))
    dt.checkpoint.save(str(_dirs / "DR_GPU_" / "b.npz"), v)
    budget = resilience.TokenBudget(0)
    slept = []
    dt.obs.arm(True)
    dt.obs.reset()
    try:
        with env_override(DR_GPU_ELASTIC="1"):
            with faults.injected("device.lost", "device_lost", times=1):
                resilience.retry(lambda: dt.reduce(v), attempts=2,
                                 sleep=slept.append, budget=budget)
        evs = [e for e in dt.obs.events() if e["name"] == "retry"]
    finally:
        dt.obs.arm(False)
        dt.obs.reset()
    assert not slept and budget.spent == 0 and budget.denied == 0
    assert [e["args"]["shrunk"] for e in evs] == [True]
    assert dt.nprocs() == P - 1


# ---------------------------------------------------------------------------
# fuzz: kill a rank over random populations
# ---------------------------------------------------------------------------

def _kill_population(k, rng_seed, it, d):
    """One seeded population and loss, as ``test_fuzz_elastic_kill_a_
    rank`` draws it; returns what the case compares."""
    rng = np.random.default_rng(rng_seed)
    p = int(rng.integers(2, P + 1))
    k.init(p)
    k.elastic.reset()
    lost = int(rng.integers(0, p))
    pop = []
    for j in range(int(rng.integers(1, 4))):
        n = int(rng.integers(1, 64))
        src = rng.standard_normal(n).astype(np.float32)
        shape = rng.integers(0, 3)
        if shape == 0:
            sizes = np.zeros(p, np.int64)
            home = int(rng.integers(0, p))
            sizes[home] = n
            c = k.m.distributed_vector.from_array(
                src, distribution=sizes.tolist())
            pop.append((c, src, home == lost))
        elif shape == 1:
            cuts = np.sort(rng.integers(0, n + 1, size=p - 1))
            b = np.concatenate(([0], cuts, [n]))
            sizes = [int(y - x) for x, y in zip(b[:-1], b[1:])]
            c = k.m.distributed_vector.from_array(src, distribution=sizes)
            pop.append((c, src, sizes[lost] > 0))
        elif rng.integers(0, 2):
            c = k.m.distributed_vector.from_array(src)
            k.m.checkpoint.save(str(d / f"f{it}_{j}.npz"), c)
            pop.append((c, src, False))
        else:
            c = k.m.distributed_vector.from_array(src)
            b0, e0 = c._rank_window(lost)
            pop.append((c, src, b0 < e0))
    rep = k.elastic.rescue_session(
        k.res.DeviceLostError(f"fuzz kill {it}", rank=lost))
    assert rep.nprocs_after == p - 1
    assert rep.rescued + rep.restored + rep.lost == len(pop)
    vals = []
    for c, oracle, may_lose in pop:
        try:
            got = k.m.to_numpy(c)
        except k.res.DeviceLostError:
            assert may_lose, "a rescuable container was lost"
            vals.append(None)
            continue
        # standard normal data hold no -0.0: numpy is the oracle bit for
        # bit
        _same(got, oracle)
        vals.append(k.rows(c))
    w = k.m.distributed_vector.from_array(np.ones(2 * (p - 1), np.float32))
    assert float(k.m.reduce(w)) == 2 * (p - 1)
    return _report(rep), vals


def test_fuzz_elastic_kill_a_rank(_dirs):
    for it in range(4):
        got = {k: _kill_population(k, 1800 + it, it, _dirs / k._pre)
               for k in BOTH}
        assert got[T][0] == got[J][0], it
        for a, b in zip(got[T][1], got[J][1]):
            assert (a is None) == (b is None)
            if a is not None:
                _same(a, b)


def _kill_and_revive(k, seed, it, d):
    """One pass of ``tests/test_fuzz.py::test_fuzz_elastic_kill_and_
    revive``: a seeded population, a random lost rank, the shrink and
    the grow that re-admits that rank."""
    rng = np.random.default_rng(seed * 100 + it)
    p = int(rng.integers(2, P + 1))
    k.init(p)
    k.elastic.reset()
    lost = int(rng.integers(0, p))
    pop = []
    for j in range(int(rng.integers(1, 4))):
        n = int(rng.integers(1, 48))
        src = rng.standard_normal(n).astype(np.float32)
        shape = rng.integers(0, 3)
        if shape == 0:
            sizes = [0] * p
            home = int(rng.integers(0, p))
            sizes[home] = n
            c = k.m.distributed_vector.from_array(src, distribution=sizes)
            pop.append((c, src, home == lost))
        elif shape == 1:
            c = k.m.distributed_vector.from_array(src)
            k.m.checkpoint.save(str(d / f"kr{seed}_{it}_{j}.npz"), c)
            pop.append((c, src, False))
        else:
            c = k.m.distributed_vector.from_array(src)
            b0, e0 = c._rank_window(lost)
            pop.append((c, src, b0 < e0))
    msrc = rng.standard_normal((2 * p, 2)).astype(np.float32)
    mat = k.m.dense_matrix.from_array(msrc, k.m.row_tiles())
    k.m.checkpoint.save(str(d / f"kr{seed}_{it}_m.npz"), mat)
    devs = list(k.m.devices())
    rep = k.elastic.rescue_session(
        k.res.DeviceLostError(f"fuzz kill {it}", rank=lost))
    grown = k.elastic.grow_session(
        devices=None if k.m is dt else list(k.m.devices()) + [devs[lost]],
        reason=f"fuzz revive {it}")
    assert rep.nprocs_after == p - 1 and grown.nprocs_after == p
    assert k.m.nprocs() == p and grown.kept == 0, grown.fates
    vals, survived = [], 0
    for c, oracle, may_lose in pop:
        try:
            got = k.m.to_numpy(c)
        except k.res.DeviceLostError:
            assert may_lose, f"it={it}: a rescuable container was lost"
            vals.append(None)
            continue
        survived += 1
        _same(got, oracle)
        vals.append(got)
    assert survived + 1 == rep.rescued + rep.restored
    _same(mat.materialize(), msrc)
    return _report(rep), (grown.moved, grown.poisoned), vals


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_elastic_kill_and_revive(seed, _dirs):
    """Seeded kill-and-revive passes: rescued and restored containers
    ride the grow bit for bit, a lost one stays lost, in both packages
    alike."""
    for it in range(2):
        got = {k: _kill_and_revive(k, 1850 + seed, it, _dirs / k._pre)
               for k in BOTH}
        assert got[T][:2] == got[J][:2], it
        for a, b in zip(got[T][2], got[J][2]):
            assert (a is None) == (b is None)
            if a is not None:
                _same(a, b)


# ---------------------------------------------------------------------------
# grow-back
# ---------------------------------------------------------------------------

def test_grow_sites_registered():
    for k in BOTH:
        sites = k.faults.sites()
        assert set(sites["device.recover"]) == {"transient", "program"}
        assert set(sites["mesh.grow"]) == {"transient", "program"}


def _grow_case(k, d):
    k.init()
    n = 4 * P
    src = np.arange(n, dtype=np.float32)
    team = k.m.distributed_vector.from_array(
        src, distribution=[n] + [0] * (P - 1))
    ck = k.m.distributed_vector.from_array(src * 2)
    k.m.checkpoint.save(str(d / "g.npz"), ck)
    gone = k.m.distributed_vector.from_array(src * 3)
    k.elastic.rescue_session(k.res.DeviceLostError("loss", rank=P - 1))
    assert k.m.nprocs() == P - 1
    rep = k.elastic.grow_session(reason="rank returned")
    assert isinstance(rep, k.elastic.GrowReport)
    with pytest.raises(k.res.DeviceLostError):
        k.m.to_numpy(gone)
    out = ((rep.nprocs_before, rep.nprocs_after, rep.moved, rep.kept,
            rep.poisoned, [f[:2] for f in rep.fates]), k.m.nprocs(),
           k.rows(team), k.rows(ck), k.m.to_numpy(team),
           k.m.to_numpy(ck), float(k.m.reduce(team)), k.story())
    k.elastic.reset()
    assert k.story() is None
    return out


def test_grow_session_roundtrip(_dirs):
    """shrink -> grow: the rescued and restored values ride the grow bit
    for bit, the runtime is whole again, the story has both chapters, a
    poisoned container stays poisoned."""
    got = {k: _grow_case(k, _dirs / k._pre) for k in BOTH}
    t, j = got[T], got[J]
    src = np.arange(4 * P, dtype=np.float32)
    assert t[0] == j[0] and t[0][:4] == (P - 1, P, 2, 0)
    assert t[1] == j[1] == P
    for i in (2, 3, 4, 5):
        _same(t[i], j[i])
    _same(t[4], src)
    _same(t[5], src * 2)
    assert t[6] == j[6] == float(src.sum())
    assert t[7] == j[7]
    assert t[7]["grow"]["grows"] == 1 and t[7]["grow"]["moved"] == 2


def test_grow_session_refuses_nothing_to_admit():
    for k in BOTH:
        k.init()
        with pytest.raises(k.res.ProgramError):
            k.elastic.grow_session()
        with pytest.raises(k.res.ProgramError):
            k.elastic.grow_session(devices=k.m.devices())
        assert k.m.nprocs() == P


def test_mesh_grow_fault_never_makes_worse():
    got = {}
    for k in BOTH:
        k.init()
        n = 4 * P
        src = np.arange(n, dtype=np.float32)
        team = k.m.distributed_vector.from_array(
            src, distribution=[n] + [0] * (P - 1))
        k.elastic.rescue_session(k.res.DeviceLostError("loss", rank=P - 1))
        with k.faults.injected("mesh.grow", "transient", times=1):
            with pytest.raises(k.res.TransientBackendError) as ei:
                k.elastic.grow_session()
        assert ei.value.site == "mesh.grow"
        assert k.m.nprocs() == P - 1 and k.elastic.grow_count() == 0
        _same(k.m.to_numpy(team), src)
        small = k.rows(team)
        rep = k.elastic.grow_session()
        assert rep.nprocs_after == P and k.m.nprocs() == P
        _same(k.m.to_numpy(team), src)
        got[k] = (small, k.rows(team), k.story())
    for a, b in zip(got[T], got[J]):
        if isinstance(a, np.ndarray):
            _same(a, b)
        else:
            assert a == b


def test_device_recover_fault_classified():
    for k in BOTH:
        k.init()
        k.elastic.rescue_session(k.res.DeviceLostError("loss", rank=P - 1))
        with k.faults.injected("device.recover", "program", times=1):
            with pytest.raises(k.res.ProgramError) as ei:
                k.elastic.grow_session()
        assert ei.value.site == "device.recover"
        assert k.m.nprocs() == P - 1
        # the polled supervisor absorbs a probe fault, then grows
        with k.env(ELASTIC_GROW="1", ELASTIC_GROW_PROBE_S="0"):
            with k.faults.injected("device.recover", "transient", times=1):
                assert k.elastic.maybe_grow() is None
            assert k.m.nprocs() == P - 1
            rep = k.elastic.maybe_grow()
            assert rep is not None and k.m.nprocs() == P
    assert T.story() == J.story()


def test_grow_supervisor_bounded_backoff():
    for k in BOTH:
        with k.env(ELASTIC_GROW_PROBE_S="0.05",
                   ELASTIC_GROW_PROBE_CAP_S="0.2",
                   ELASTIC_GROW_PROBES="3"):
            sup = k.elastic.GrowSupervisor()
            assert sup.budget == 3
            assert not sup.due(now=0.0)

            def boom():
                raise k.res.TransientBackendError("probe died")

            deadline = time.monotonic() + 10.0
            while not sup.exhausted() and time.monotonic() < deadline:
                sup.poll(boom)
                time.sleep(0.005)
            assert sup.exhausted() and sup.probes == 3
            assert sup.failures == 3
            assert sup.poll(boom) is None and sup.probes == 3
    # the same seeded schedule in both packages
    with env_override(DR_GPU_ELASTIC_GROW_PROBE_S="0.05"), \
            jenv_override(DR_TPU_ELASTIC_GROW_PROBE_S="0.05"):
        assert elastic.GrowSupervisor()._delays == \
            jelastic.GrowSupervisor()._delays


def _region_grow_case(k, d):
    k.init()
    n = 4 * P
    src = np.arange(n, dtype=np.float32)
    v = k.m.distributed_vector.from_array(src)
    k.m.checkpoint.save(str(d / "v.npz"), v)
    with k.env(ELASTIC="1", ELASTIC_GROW="1", ELASTIC_GROW_PROBE_S="0"):
        with k.faults.injected("device.lost", "device_lost", times=1):
            with k.m.deferred():
                k.m.fill(v, 2.0)
                k.m.for_each(v, _half)
        assert k.m.nprocs() in (P - 1, P)
        with k.m.deferred():
            k.m.for_each(v, _half)
    return k.m.nprocs(), k.m.to_numpy(v), k.rows(v), k.story()


def test_plan_region_exit_polls_growback(_dirs):
    got = {k: _region_grow_case(k, _dirs / k._pre) for k in BOTH}
    assert got[T][0] == got[J][0] == P
    _same(got[T][1], np.full(4 * P, 0.5, np.float32))
    _same(got[T][2], got[J][2])
    assert got[T][3] == got[J][3] and got[T][3]["grow"]["grows"] == 1


def _soak(k, seed, d):
    """``test_fuzz_elastic_shrink_grow_shrink``'s kill/revive walk, with
    the grow re-admitting every dropped rank (the JAX package's probe
    would also admit devices the session never had)."""
    rng = np.random.default_rng(seed)
    p = int(rng.integers(2, P + 1))
    k.init(p)
    k.elastic.reset()
    first = list(k.m.devices())
    n = int(rng.integers(8, 64))
    oracle = rng.standard_normal(n).astype(np.float32)
    v = k.m.distributed_vector.from_array(oracle)
    msrc = rng.standard_normal((2 * p, 3)).astype(np.float32)
    m = k.m.dense_matrix.from_array(msrc, k.m.row_tiles())
    steps = []
    for step in range(int(rng.integers(2, 5))):
        cur = k.m.nprocs()
        if cur > 1 and (cur >= p or rng.integers(0, 2)):
            k.m.checkpoint.save(str(d / f"s{step}v.npz"), v)
            k.m.checkpoint.save(str(d / f"s{step}m.npz"), m)
            lost = int(rng.integers(0, cur))
            k.elastic.rescue_session(k.res.DeviceLostError(
                f"soak kill {step}", rank=lost))
        elif k.m is dt:
            k.elastic.grow_session(reason=f"soak revive {step}")
        else:
            have = {x.id for x in k.m.devices()}
            k.elastic.grow_session(
                devices=list(k.m.devices()) + [x for x in first
                                               if x.id not in have],
                reason=f"soak revive {step}")
        _same(k.m.to_numpy(v), oracle)
        _same(m.materialize(), msrc)
        steps.append((k.m.nprocs(), k.rows(v)))
    got = float(k.m.reduce(v))
    want = float(oracle.astype(np.float64).sum())
    assert abs(got - want) <= 1e-3 * max(1.0, abs(want))
    return steps, k.story()


def test_fuzz_elastic_shrink_grow_shrink(_dirs):
    for seed in (1900, 1901):
        got = {k: _soak(k, seed, _dirs / k._pre) for k in BOTH}
        assert [s[0] for s in got[T][0]] == [s[0] for s in got[J][0]]
        for (_pa, a), (_pb, b) in zip(got[T][0], got[J][0]):
            _same(a, b)
        assert got[T][1] == got[J][1]


# ---------------------------------------------------------------------------
# the port's own bookkeeping
# ---------------------------------------------------------------------------

def test_rank_slots_and_probe_recovered():
    """A lost rank is a slot: the shrunken runtime remembers which slot
    it dropped, the probe answers for it (a CPU slot always answers,
    after the ``device.recover`` site), and the grow puts it back."""
    from dr_tpu_torch.parallel import runtime as rtm
    assert rtm.probe_recovered() == []
    elastic.rescue_session(lost_ranks=[2, 5])
    rt = dt.runtime()
    assert rt.slots == [0, 1, 3, 4, 6, 7]
    assert [s for s, _d in rt.dropped] == [2, 5]
    assert rtm.probe_recovered() == [torch.device("cpu")] * 2
    faults.arm_counting()
    rtm.probe_recovered()
    assert faults.stats()["device.recover"] == 1
    faults.clear()
    rep = elastic.grow_session()
    assert rep.nprocs_after == P
    assert dt.runtime().slots == [0, 1, 3, 4, 6, 7, 2, 5]
    assert dt.runtime().dropped == []
    # a second shrink of a re-admitted slot drops it again
    elastic.rescue_session(lost_ranks=[6])
    assert [s for s, _d in dt.runtime().dropped] == [2]
    assert dt.runtime().slots == [0, 1, 3, 4, 6, 7, 5]


def test_shrink_drops_the_old_runtime_cache_entries():
    """Every dispatch-cache entry keyed on the replaced runtime goes with
    it (a plan entry holds a CUDA graph and its pool on a card)."""
    from dr_tpu_torch.core import pinning
    from dr_tpu_torch.plan import _plan_cache
    v = dt.distributed_vector.from_array(np.arange(4 * P, dtype=np.float32),
                                         distribution=[4 * P] + [0] * (P - 1))
    for _ in range(2):
        with dt.deferred():
            dt.for_each(v, _mul, 2.0)
    old = dt.runtime()
    oid = id(old)

    def mentions(ident):
        return [k for ref in pinning._caches
                for c in [ref()] if c is not None
                for k in c if pinning._key_mentions(k, {ident})]

    assert mentions(oid) and any(k[0] == "plan" for k in mentions(oid))
    assert len(_plan_cache)
    elastic.rescue_session(lost_ranks=[P - 1])
    assert not mentions(oid) and oid not in pinning._pins
    new = dt.runtime()
    dt.for_each(v, _mul, 2.0)
    assert mentions(id(new))
    elastic.grow_session()
    assert not mentions(id(new))
    _same(dt.to_numpy(v), np.arange(4 * P, dtype=np.float32) * 8)


def test_obs_spans_of_shrink_and_grow():
    """``mesh.shrink`` and ``mesh.grow`` spans, with the ``device.lost``
    and ``device.recover`` events inside them, as the JAX package
    records them."""
    from dr_tpu import obs as jobs
    shapes = {}
    for k, o in ((J, jobs), (T, dt.obs)):
        k.init()
        o.arm(True)
        o.reset()
        try:
            k.m.distributed_vector.from_array(np.arange(8, dtype=np.float32))
            k.elastic.rescue_session(k.res.DeviceLostError("loss", rank=3))
            k.elastic.grow_session()
            evs = [e for e in o.events() if e.get("cat") == "elastic"]
        finally:
            o.arm(False)
            o.reset()
        shapes[k] = [(e["name"], e["ph"]) for e in evs]
        spans = {e["name"]: e for e in evs if e["ph"] == "X"}
        assert spans["mesh.shrink"]["args"]["survivors"] == P - 1
        assert spans["mesh.grow"]["args"]["nprocs"] == P
        lost = next(e for e in evs if e["name"] == "device.lost")
        s = spans["mesh.shrink"]
        assert s["ts"] <= lost["ts"] <= s["ts"] + s["dur"]
    assert shapes[T] == shapes[J]


def test_sanitize_shrink_subprocess():
    """``DR_GPU_SANITIZE=1`` over the shrink and the grow: the rebuilt
    runtimes' keys are canon-portable, and the same chain again on the
    shrunken (then grown) runtime recompiles nothing."""
    code = """
import numpy as np
import dr_tpu_torch as dt
from dr_tpu_torch.utils import elastic, resilience, sanitize

assert sanitize.installed()


def _mul(x, c):
    return x * c


dt.init(["cpu"] * 8)
P = dt.nprocs()
n = 4 * P
src = np.arange(n, dtype=np.float32)
v = dt.distributed_vector.from_array(src, distribution=[n] + [0] * (P - 1))
sanitize.reset_epoch()
elastic.rescue_session(resilience.DeviceLostError("smoke", rank=P - 1))
assert dt.nprocs() == P - 1
np.testing.assert_array_equal(dt.to_numpy(v), src)
a = dt.distributed_vector(n, np.float32)
dt.fill(a, 2.0)
dt.transform(a, a, _mul, 3.0)
assert float(dt.reduce(a)) == 6.0 * n
with sanitize.zero_recompile("post-shrink re-run"):
    dt.fill(a, 4.0)
    dt.transform(a, a, _mul, 5.0)
    assert float(dt.reduce(a)) == 20.0 * n
sanitize.check_recompiles()
sanitize.reset_epoch()
gr = elastic.grow_session(reason="sanitize grow smoke")
assert gr.nprocs_after == P and dt.nprocs() == P
np.testing.assert_array_equal(dt.to_numpy(v), src)
dt.fill(a, 2.0)
dt.transform(a, a, _mul, 3.0)
assert float(dt.reduce(a)) == 6.0 * n
with sanitize.zero_recompile("post-grow re-run"):
    dt.fill(a, 4.0)
    dt.transform(a, a, _mul, 5.0)
    assert float(dt.reduce(a)) == 20.0 * n
sanitize.check_recompiles()
print("SANITIZED-SHRINK-OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(DR_GPU_SANITIZE="1", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SANITIZED-SHRINK-OK" in r.stdout


def test_phase24_rehearsal(tmp_path):
    """chip_smoke's phase 24 functions on the CPU at small shapes: every
    check passes (the graph and launch checks are the card's)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    from dr_tpu_torch.ops import kernels
    tun = chip.tuning_phase(dt, 5, str(tmp_path), device="cpu", m_log2=12,
                            join=(10, 6), turns=1)
    assert tun["spmv_winner"] in ("ell", "csr")
    assert tun["context"] == {"backend": "cpu", "kind": "cpu", "nshards": 1}
    out = chip.elastic_sessions(dt, kernels, 5, str(tmp_path), device="cpu",
                                log2=14, path_n=3 << 12, replay_log2=12,
                                t_block=8, halo=1024)
    assert out["story"]["shrink"]["shrinks"] == 2
    assert [f["fate"] for f in out["grow_fates"]] == ["moved", "moved"]


# ---------------------------------------------------------------------------
# the serving daemon's mesh (tests/test_elastic.py's serve cases)
# ---------------------------------------------------------------------------

def test_serve_daemon_survives_device_loss(tmp_path):
    """Mid-batch device loss: the batch's retry shrinks the claim and
    replays it — the live client gets its answer, later requests land,
    and stats and the story's serve chapter carry the shrink."""
    from dr_tpu_torch import serve
    with env_override(DR_GPU_ELASTIC="1"):
        srv = _server(T, str(tmp_path / "el.sock"))
        try:
            with serve.Client(srv.path, timeout=60.0) as c:
                x = np.arange(16, dtype=np.float32)
                np.testing.assert_array_equal(c.scale(x, a=2.0), x * 2.0)
                faults.inject("device.lost", "device_lost", times=1)
                np.testing.assert_array_equal(c.scale(x, a=3.0),
                                              x * np.float32(3.0))
                st = c.stats()
                assert st["shrinks"] == 1 and st["restarts"] == 0
                assert "shrunken mesh" in st["degraded"]
                assert abs(c.reduce(np.ones(8, np.float32)) - 8.0) < 1e-4
        finally:
            faults.clear()
            srv.stop()
    assert dt.nprocs() == P - 1
    story = resilience.session_story()
    assert story and story["shrink"]["shrinks"] == 1
    assert story["serve"]["reason"].startswith("serve: device loss")
    serve.reset()


def test_serve_mesh_growback_between_batches(tmp_path):
    """The shrunken claim grows back between batches with the grow hook
    armed: same client, bit-equal answers, the grow in stats()."""
    from dr_tpu_torch import serve
    with env_override(DR_GPU_ELASTIC="1", DR_GPU_ELASTIC_GROW="1",
                      DR_GPU_ELASTIC_GROW_PROBE_S="0.01"):
        srv = _server(T, str(tmp_path / "gb.sock"))
        try:
            with serve.Client(srv.path, timeout=60.0) as c:
                x = np.arange(16, dtype=np.float32)
                faults.inject("device.lost", "device_lost", times=1)
                np.testing.assert_array_equal(c.scale(x, a=3.0),
                                              x * np.float32(3.0))
                st = c.stats()
                assert st["shrinks"] == 1
                deadline = time.monotonic() + 60.0
                while time.monotonic() < deadline:
                    np.testing.assert_array_equal(c.scale(x, a=4.0),
                                                  x * np.float32(4.0))
                    st = c.stats()
                    if st["grows"]:
                        break
                    time.sleep(0.02)
                assert st["grows"] == 1, st
                assert st["degraded"] is None
        finally:
            faults.clear()
            srv.stop()
    assert dt.nprocs() == P
    story = resilience.session_story()
    assert story and story["shrink"]["shrinks"] == 1
    assert story["grow"]["grows"] == 1
    serve.reset()


def test_serve_shrink_recorded_even_when_replay_fails(tmp_path):
    """A shrink whose replay then fails still changed the claim:
    stats()["shrinks"] and the degraded marker record it."""
    from dr_tpu_torch import serve
    with env_override(DR_GPU_ELASTIC="1"):
        srv = _server(T, str(tmp_path / "sf.sock"))
        try:
            with serve.Client(srv.path, timeout=60.0) as c:
                x = np.arange(8, dtype=np.float32)
                np.testing.assert_array_equal(c.scale(x, a=2.0), x * 2.0)
                # attempt 1: a clean serve.flush visit, then the loss;
                # attempt 2 (the replay): a deterministic fault
                faults.inject("device.lost", "device_lost", times=1)
                faults.inject("serve.flush", "program", after=1)
                with pytest.raises(resilience.ResilienceError):
                    c.scale(x, a=3.0)
                faults.clear()
                st = c.stats()
                assert st["shrinks"] == 1, st
                assert "shrunken mesh" in (st["degraded"] or ""), st
                np.testing.assert_array_equal(c.scale(x, a=4.0), x * 4.0)
        finally:
            faults.clear()
            srv.stop()
    serve.reset()
