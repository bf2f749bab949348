"""dr_tpu_torch's tuning database (``dr_tpu_torch/tuning.py``) and the
pickers that read it, against dr_tpu's.

Mirrors the tuning cases of ``tests/test_plan_opt.py`` on 8 CPU ranks:
the five ``test_tuning_*`` cases (the pickers case and the fresh-process
case use ``spmv.format`` and ``join.broadcast_max``: the JAX package's
``scan.chunk`` is a TPU tiling rule the port does not carry),
``test_capinfer_hint_skips_probe_and_survives_undershoot`` and
``test_joinroute_reads_tuning_db_and_env_pin_wins``.  Each case runs the
same records and lookups through both packages (``DR_GPU_*`` beside
``DR_TPU_*``); the relational results agree bit for bit.
"""

import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu import tuning as jtuning
from dr_tpu.utils.env import env_override as jenv_override
from dr_tpu_torch import tuning
from dr_tpu_torch.algorithms import relational as trel
from dr_tpu_torch.utils.env import env_override

P = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = ("DR_GPU_TUNING_DB", "DR_GPU_TUNING_DIR", "DR_GPU_SPMV_FORMAT",
        "DR_GPU_JOIN_BROADCAST_MAX", "DR_GPU_PLAN_OPT",
        "DR_GPU_PLAN_OPT_DISABLE")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for v in _ENV:
        monkeypatch.delenv(v, raising=False)
    dr_tpu.init(jax.devices()[:P])
    dt.init(["cpu"] * P)
    tuning.clear_session()
    tuning.reload()
    yield
    dt.utils.elastic.reset()
    tuning.clear_session()
    tuning.reload()
    for m in dt.utils.elastic.MARKERS + dt.utils.elastic.GROW_MARKERS:
        os.environ.pop(m, None)
    dt.final()


def _vec(m, src):
    return m.distributed_vector.from_array(np.asarray(src))


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_tuning_record_lookup_roundtrip(tmp_path):
    db = str(tmp_path / "tuning_db.json")
    with env_override(DR_GPU_TUNING_DB=db):
        assert tuning.enabled() and tuning.db_path() == db
        assert tuning.lookup("spmv", "format", "csr") == "csr"
        key = tuning.record("spmv", "format", "ell", source="unit")
        assert key == "spmv.format@backend=cpu,kind=cpu,nshards=8"
        tuning.clear_session()
        tuning.reload()
        assert tuning.lookup("spmv", "format") == "ell"
    # another store: the entry does not leak
    with env_override(DR_GPU_TUNING_DB=str(tmp_path / "other.json")):
        tuning.clear_session()
        tuning.reload()
        assert tuning.lookup("spmv", "format") is None
    # the directory variable names the same file layout
    with env_override(DR_GPU_TUNING_DIR=str(tmp_path)):
        tuning.reload()
        assert tuning.db_path() == db
        assert tuning.lookup("spmv", "format") == "ell"
    # the file is the JAX package's format, and the JAX package reads
    # its own entry back through the same steps
    import json
    raw = json.loads(open(db, encoding="utf-8").read())
    assert raw["version"] == 1 and key in raw["entries"]
    assert raw["entries"][key]["value"] == "ell"
    with jenv_override(DR_TPU_TUNING_DB=str(tmp_path / "jax.json")):
        jtuning.record("spmv", "format", "ell", source="unit")
        jtuning.clear_session()
        jtuning.reload()
        assert jtuning.lookup("spmv", "format") == "ell"
    jtuning.clear_session()
    jtuning.reload()


def test_tuning_context_isolation(tmp_path):
    """A CPU record never answers a card's lookup (and back): backend,
    device kind and rank count are part of the key."""
    db = str(tmp_path / "tuning_db.json")
    card = {"backend": "cuda", "kind": "NVIDIA H100 80GB HBM3", "nshards": 4}
    with env_override(DR_GPU_TUNING_DB=db):
        tuning.record("join", "broadcast_max", 256)          # live ctx
        key = tuning.record("join", "broadcast_max", 4096, ctx=card)
        assert key == ("join.broadcast_max@backend=cuda,"
                       "kind=NVIDIA_H100_80GB_HBM3,nshards=4")
        tuning.clear_session()
        tuning.reload()
        assert tuning.lookup("join", "broadcast_max") == 256
        assert tuning.lookup("join", "broadcast_max", ctx=card) == 4096
        other = dict(card, kind="NVIDIA A100-SXM4-80GB")
        assert tuning.lookup("join", "broadcast_max", 7, ctx=other) == 7
        assert tuning.lookup("join", "broadcast_max", 8192,
                             ctx={"backend": "cpu", "kind": "cpu",
                                  "nshards": 2}) == 8192
    # before init() the context matches nothing, and reading it starts
    # nothing
    dt.final()
    assert tuning.context() == {"backend": "none", "kind": "none",
                                "nshards": 0}
    assert not dt.parallel.runtime.is_initialized()
    # the JAX package isolates on the same fields it has
    tpu = {"backend": "tpu", "nshards": 4, "x64": False}
    with jenv_override(DR_TPU_TUNING_DB=str(tmp_path / "jax.json")):
        jtuning.record("join", "broadcast_max", 256)
        jtuning.record("join", "broadcast_max", 4096, ctx=tpu)
        jtuning.clear_session()
        jtuning.reload()
        assert jtuning.lookup("join", "broadcast_max") == 256
        assert jtuning.lookup("join", "broadcast_max", ctx=tpu) == 4096
    jtuning.clear_session()
    jtuning.reload()


def test_tuning_corrupt_db_single_warn_and_defaults(tmp_path, monkeypatch):
    db = tmp_path / "tuning_db.json"
    db.write_text("{ not json !!", encoding="utf-8")
    A = dt.sparse_matrix.from_coo((16, 16), np.arange(16), np.arange(16),
                                  np.ones(16, np.float32))
    from dr_tpu_torch.algorithms import gemv as tgemv
    with env_override(DR_GPU_TUNING_DB=str(db)):
        tuning.reload()
        monkeypatch.setattr(tuning, "_warned_paths", set())
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            assert tuning.lookup("join", "broadcast_max", 8192) == 8192
            assert tuning.lookup("spmv", "format", "csr") == "csr"
            assert trel._broadcast_max() == 1 << 18
            assert tgemv._pick_format(A) == A.format
        warns = [w for w in rec if "tuning DB" in str(w.message)]
        assert len(warns) == 1
        assert issubclass(warns[0].category, tuning.TuningDBWarning)
        # a later record rebuilds the store from scratch
        tuning.record("join", "broadcast_max", 512)
        tuning.clear_session()
        tuning.reload()
        assert tuning.lookup("join", "broadcast_max") == 512


def test_tuning_pickers_consult_db_between_env_and_default(tmp_path):
    """The pickers: a DB entry flips the SpMV format and the join route
    threshold, an env pin still wins, junk in the DB is ignored; the JAX
    package's SpMV picker does the same."""
    import importlib
    tgemv = importlib.import_module("dr_tpu_torch.algorithms.gemv")
    jgemv = importlib.import_module("dr_tpu.algorithms.gemv")
    db = str(tmp_path / "tuning_db.json")
    m = 64
    rows = np.arange(m)
    with env_override(DR_GPU_TUNING_DB=db), \
            jenv_override(DR_TPU_TUNING_DB=str(tmp_path / "jax.json"),
                          DR_TPU_SPMV_FORMAT=None):
        A = dt.sparse_matrix.from_coo((m, m), rows, rows,
                                      np.ones(m, np.float32))
        J = dr_tpu.sparse_matrix.from_coo((m, m), rows, rows,
                                          np.ones(m, np.float32))
        base = tgemv._pick_format(A)
        assert base == A.format == jgemv._pick_format(J)
        other = "csr" if base != "csr" else "ell"
        for tun, pick, mat, pin in ((tuning, tgemv._pick_format, A,
                                     env_override),
                                    (jtuning, jgemv._pick_format, J,
                                     jenv_override)):
            tun.record("spmv", "format", other)
            assert pick(mat) == other
            var = "DR_GPU_SPMV_FORMAT" if tun is tuning \
                else "DR_TPU_SPMV_FORMAT"
            with pin(**{var: base}):
                assert pick(mat) == base
            tun.record("spmv", "format", 123)   # junk: ignored
            assert pick(mat) == base
        # an ineligible recorded format falls down the chain as a
        # forced one does
        tuning.record("spmv", "format", "ring")
        with env_override(DR_GPU_SPMV_FORMAT="ring"):
            forced = tgemv.resolved_format(A)
        assert tgemv.resolved_format(A) == forced
        # the join route threshold
        assert trel._broadcast_max() == 1 << 18
        tuning.record("join", "broadcast_max", 0)
        assert trel._broadcast_max() == 0
        with env_override(DR_GPU_JOIN_BROADCAST_MAX="1000"):
            assert trel._broadcast_max() == 1000
        tuning.record("join", "broadcast_max", "lots")   # junk
        assert trel._broadcast_max() == 1 << 18
        # the gemv answers the same rows under every recorded format
        b = np.arange(m, dtype=np.float32)
        outs = []
        for fmt in ("csr", "ell", "ring", "bcsr"):
            tuning.record("spmv", "format", fmt)
            c = dt.distributed_vector(m)
            dt.fill(c, 0.0)
            dt.gemv(c, A, b)
            outs.append(dt.to_numpy(c))
        for o in outs:
            _bits(o, b)
    jtuning.clear_session()
    jtuning.reload()


def test_tuning_db_fresh_process_roundtrip(tmp_path):
    """A recorded winner changes the picked config in a fresh process
    with no code edit; without the DB the fresh process keeps the code
    default."""
    db = str(tmp_path / "tuning_db.json")
    with env_override(DR_GPU_TUNING_DB=db):
        tuning.record("spmv", "format", "csr", source="unit-roundtrip")
        tuning.record("join", "broadcast_max", 0, source="unit-roundtrip")
    code = (
        "import numpy as np\n"
        "import dr_tpu_torch as dt\n"
        "from dr_tpu_torch.algorithms import gemv, relational\n"
        "dt.init(['cpu'] * 8)\n"
        "m = 64\n"
        "A = dt.sparse_matrix.from_coo((m, m), np.arange(m), np.arange(m),"
        " np.ones(m, np.float32))\n"
        "print('fmt=%s/%s max=%d' % (A.format, gemv.resolved_format(A),"
        " relational._broadcast_max()))\n"
    )

    def run(extra):
        env = {k: v for k, v in os.environ.items()
               if k not in _ENV and k != "PYTHONPATH"}
        env["PYTHONPATH"] = REPO
        env.update(extra)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300,
                             cwd=REPO)
        assert out.returncode == 0, out.stderr
        return out.stdout

    assert "fmt=ell/csr max=0" in run({"DR_GPU_TUNING_DB": db})
    assert f"fmt=ell/ell max={1 << 18}" in run({})


def test_capinfer_hint_skips_probe_and_survives_undershoot():
    """A noted ratio replaces the count probe; a tiny hint undershoots
    and the auto tier runs the op again at the exact count instead of
    raising the capacity error.  The results equal dr_tpu's under the
    same hint bit for bit."""
    rng = np.random.default_rng(24)
    n = 40
    keys = rng.integers(0, 4, n).astype(np.float32)   # heavy dup keys
    vals = np.ones(n, np.float32)
    _u, cnt = np.unique(keys, return_counts=True)
    m_exp = int((cnt.astype(np.int64) ** 2).sum())
    got = {}
    for m, tun, ovr, var in ((dt, tuning, env_override, "DR_GPU_PLAN_OPT"),
                             (dr_tpu, jtuning, jenv_override,
                              "DR_TPU_PLAN_OPT")):
        kc, vc = _vec(m, keys), _vec(m, vals)
        with ovr(**{var: "all"}):
            tun.clear_session()
            tun.note("relational", "cap_ratio_join_inner", 1e-3)
            tun.note("relational", "cap_ratio_groupby", 1e-3)
            if m is dt:
                dt.obs.arm(True)
                dt.obs.reset()
            try:
                r = m.join_auto(kc, vc, kc, vc)
                g = m.groupby_auto(kc, vc, agg="sum")
                assert r.count == m_exp
                assert g.count == len(cnt)
                got[m] = r.arrays() + g.arrays()
            finally:
                if m is dt:
                    evs = dt.obs.events()
                    dt.obs.arm(False)
                    dt.obs.reset()
            # the observed ratio overwrote the bogus note
            key = tun.context_key("relational", "cap_ratio_join_inner")
            assert tun._session[key] > 1e-3
        tun.clear_session()
    assert not [e for e in evs if e["args"].get("phase") == "cap_probe"]
    for a, b in zip(got[dt], got[dr_tpu]):
        _bits(a, b)
    # with the pass off the hint is not read: the exact probe runs
    kc = _vec(dt, keys)
    tuning.note("relational", "cap_ratio_groupby", 1e-3)
    dt.obs.arm(True)
    dt.obs.reset()
    try:
        u = dt.unique_auto(kc)
        assert u.count == len(cnt)
        evs = dt.obs.events()
    finally:
        dt.obs.arm(False)
        dt.obs.reset()
    assert [e["args"].get("phase") for e in evs
            if e["args"].get("phase") == "cap_probe"] == ["cap_probe"]


def test_joinroute_reads_tuning_db_and_env_pin_wins():
    rng = np.random.default_rng(27)
    n = 32
    k = rng.integers(0, 9, n).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    routes = {}
    rows = {}
    for m, tun, ovr, pre in ((dt, tuning, env_override, "DR_GPU_"),
                             (dr_tpu, jtuning, jenv_override, "DR_TPU_")):
        rel = trel if m is dt else __import__(
            "dr_tpu.algorithms.relational", fromlist=["x"])
        kc, vc = _vec(m, k), _vec(m, v)
        outs = [m.distributed_vector(8 * n, np.float32) for _ in range(3)]

        def route_of():
            m.join(kc, vc, kc, vc, *outs)
            return rel.last_join_route()["impl"]

        got = []
        with ovr(**{pre + "PLAN_OPT": "all",
                    pre + "JOIN_BROADCAST_MAX": None}):
            got.append(route_of())                   # code default: 2^18
            first = [m.to_numpy(o) for o in outs]
            tun.note("join", "broadcast_max", 0)     # measured: partition
            got.append(route_of())
            rows[m] = (first, [m.to_numpy(o) for o in outs])
            with ovr(**{pre + "JOIN_BROADCAST_MAX": str(1 << 18)}):
                got.append(route_of())               # the env pin wins
            with ovr(**{pre + "PLAN_OPT_DISABLE": "joinroute"}):
                got.append(route_of())               # the pass is off
        tun.clear_session()
        routes[m] = got
    assert routes[dt] == ["broadcast", "partition", "broadcast", "broadcast"]
    assert routes[dt] == routes[dr_tpu]
    for a, b in zip(rows[dt][0] + rows[dt][1], rows[dr_tpu][0]
                    + rows[dr_tpu][1]):
        _bits(a, b)
    # both routes give the same rows
    for a, b in zip(rows[dt][0], rows[dt][1]):
        _bits(a, b)
