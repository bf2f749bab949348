"""dr_tpu_torch.utils.profiling against dr_tpu.utils.profiling, mirroring
``tests/test_algorithms.py``'s profiling cases: the marginal timer and
``annotate`` on the port's ``dot_n`` (8 CPU ranks), ``marginal``'s
widening and its ``JitterError`` under a patched clock (both modules on
the same fake op), ``PhaseBreakdown``'s arithmetic held equal to the JAX
class on the same cumulative times, and ``trace`` on the CPU, which
writes a Chrome trace holding the ``annotate`` name and refuses a CUDA
trace where there is no card."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

import dr_tpu_torch as dt
from dr_tpu.utils import profiling as jprof
from dr_tpu_torch.algorithms import sort as dt_sort
from dr_tpu_torch.utils import profiling

P = 8


@pytest.fixture(autouse=True)
def _port_ranks():
    dt.init(["cpu"] * P)
    yield
    dt.final()


def test_device_timer_and_annotate():
    n = 64 * P
    a = dt.distributed_vector(n)
    b = dt.distributed_vector(n)
    dt.fill(a, 1.0)
    dt.fill(b, 2.0)
    secs = profiling.device_timer(lambda r: float(dt.dot_n(a, b, r)),
                                  r1=1, r2=5, samples=2)
    assert np.isfinite(secs)
    with profiling.annotate("dot"):
        assert float(dt.dot_n(a, b, 1)) == 2.0 * n


class _FakeOp:
    """An op of ``per_op`` seconds a round plus a per-call constant, on a
    fake clock."""

    def __init__(self, per_op, constant=0.01):
        self.per_op, self.constant = per_op, constant
        self.clock = [0.0]
        self.calls = []

    def __call__(self, r):
        self.calls.append(r)
        self.clock[0] += self.constant + self.per_op * r


@pytest.mark.parametrize("mod", [jprof, profiling], ids=["jax", "port"])
def test_marginal_widens_and_raises(monkeypatch, mod):
    op = _FakeOp(per_op=1e-4)
    monkeypatch.setattr(mod.time, "perf_counter", lambda: op.clock[0])
    secs = mod.marginal(op, r1=4, r2=36, samples=3, min_spread=0.3,
                        rmax=4096)
    assert secs == pytest.approx(1e-4, rel=1e-6)
    assert max(op.calls) > 36  # widened beyond the pilot loop count
    noise = _FakeOp(per_op=0.0)
    monkeypatch.setattr(mod.time, "perf_counter", lambda: noise.clock[0])
    with pytest.raises(mod.JitterError):
        mod.marginal(noise, r1=4, r2=36, samples=3, min_spread=0.3,
                     rmax=4096)


def test_marginal_calls_match_reference(monkeypatch):
    """The same fake op takes the same widened loop counts in both."""
    calls = []
    for mod in (jprof, profiling):
        op = _FakeOp(per_op=3e-5, constant=0.02)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: op.clock[0])
        calls.append((mod.marginal(op, r1=2, r2=10, samples=3), op.calls))
    assert calls[0] == calls[1]


@pytest.mark.parametrize("cums", [
    [0.010, 0.014, 0.013, None, 0.040],
    [0.0, 0.0, 0.0, 0.0, 0.0],
    [0.003, 0.001, 0.002, 0.009, 0.008]])
def test_phase_breakdown_matches_reference(monkeypatch, cums):
    names = ("a", "b", "c", "d", "e")
    out = []
    for mod in (jprof, profiling):
        def fake_marginal(run, mod=mod, **kw):
            v = cums[run]
            if v is None:
                raise mod.JitterError("noise")
            return v
        monkeypatch.setattr(mod, "marginal", fake_marginal)
        out.append(mod.profile_phases(lambda i: i, names, r1=2, r2=6))
    j, t = out
    assert t.names == j.names and t.cumulative == j.cumulative
    assert t.seconds == j.seconds and t.total == j.total
    assert t.dominant == j.dominant and t.fractions() == j.fractions()
    assert t.detail(4e9) == j.detail(4e9)
    assert t.table(4e9) == j.table(4e9) and t.table() == j.table()
    if cums[0] == 0.010:
        assert t.seconds["c"] == 0.0 and t.seconds["d"] == 0.0
        assert t.detail(bytes_per_op=4e9)["a"] == pytest.approx(400.0)


def test_profile_phases_on_the_sort():
    """The phase ladder of the port's sample sort through ``stop_after``
    (``sort_phases_n``): every prefix runs and the breakdown covers every
    phase."""
    rng = np.random.default_rng(3)
    src = rng.standard_normal(64 * P).astype(np.float32)

    def make_run(i):
        def run(r):
            v = dt.distributed_vector.from_array(src)
            dt_sort.sort_phases_n(v, dt_sort.SORT_PHASES[i], r)
            float(dt.reduce(v))
        return run

    bd = profiling.profile_phases(make_run, dt_sort.SORT_PHASES, r1=1, r2=2,
                                  samples=1, min_spread=0.0)
    assert bd.names == dt_sort.SORT_PHASES
    assert set(bd.seconds) == set(dt_sort.SORT_PHASES)
    assert "total" in bd.table()


def test_trace_on_cpu_writes_chrome_trace(tmp_path):
    a = dt.distributed_vector(256)
    dt.fill(a, 1.0)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("dr.dot"):
            float(dt.dot(a, a))
    assert prof is not None
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0], encoding="utf-8") as fh:
        doc = json.load(fh)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "dr.dot" in names
    assert not [e for e in doc["traceEvents"]
                if e.get("cat") in profiling.DEVICE_CATS]


def test_trace_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs none")
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.trace(str(tmp_path / "x"),
                             [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            raise AssertionError("the block must not run")
    assert not (tmp_path / "x").exists()


def test_trace_body_error_propagates(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with profiling.trace(str(tmp_path), [ProfilerActivity.CPU]):
            raise ValueError("inside")
    # the trace of the failed block is still written
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1
