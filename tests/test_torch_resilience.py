"""dr_tpu_torch.utils.resilience and utils.faults against their JAX
oracles (``tests/test_resilience.py``): the classified taxonomy, the
deterministic backoff, retry and deadlines, the fault-spec grammar, the
injection sites raising classified errors, and a trace divergence under
an injected per-process fault.  Where both packages can run the same
thing (the classifier, the schedules, the spec parser, a halo exchange
retried after a transient), the test runs both on the same seeded inputs
and compares.

JAX tests with no port counterpart, as ROADMAP.md decides for the
no-fallback rule:

* ``test_route_first_touch_decisions``: the port has no first-touch
  router (it would switch to the CPU).  Its replacement is
  ``tests/test_torch_imports.py::test_init_without_devices_needs_cuda``
  (``init()`` without a card raises) and, here,
  ``test_injected_sites_raise_classified`` (an injected ``runtime.init``
  fault raises ``TransientBackendError``) and
  ``test_first_touch_failure_is_classified``.
* ``test_degradation_story_assembly`` and
  ``test_degradation_story_serve_markers``: ``degradation_story`` reads
  re-exec markers of the JAX bench and serving daemon, which the port
  does not have; it comes with ``serve/``, if at all.
* ``test_warn_fallback_routed_and_resettable``: the port has no
  ``utils/fallback.py`` (no fallbacks), so ``fallback.warn`` never fires.
"""

import io
import time

import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.utils import faults as jfaults
from dr_tpu.utils import resilience as jres
from dr_tpu_torch.parallel import runtime as trt
from dr_tpu_torch.utils import faults, resilience, spmd_guard
from dr_tpu_torch.utils.resilience import (CheckpointCorruptError,
                                           DeadlineExpired, DeviceLostError,
                                           DeviceOOM, ProgramError,
                                           RelayDownError, ResilienceError,
                                           TransientBackendError)

P = 8


@pytest.fixture(autouse=True)
def _port():
    dt.init(["cpu"] * P)
    yield
    faults.clear()
    dt.final()


def _halo_vec(pkg, n=64):
    hb = pkg.halo_bounds(1, 1, periodic=True)
    src = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    return pkg.distributed_vector.from_array(src, halo=hb)


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------

_TEXTS = [
    "RESOURCE_EXHAUSTED: oom", "Out of memory while...",
    "relay not listening", "ConnectionRefusedError: Connection refused",
    "UNAVAILABLE: socket", "device init exceeded 420s (wedged tunnel "
    "relay?)", "ValueError: bad shape",
    "RecursionError: maximum recursion depth exceeded",
    "UNAVAILABLE: RESOURCE_EXHAUSTED during claim",
    "UNAVAILABLE: transport reset while registering pinned host memory",
    "DEVICE_LOST: chip 3", "CUDA out of memory. Tried to allocate 2.00 GiB",
    "CUDA kernel segred failed to launch (cudaError 719: unspecified "
    "launch failure)", "CUDA error: an illegal memory access was "
    "encountered",
]


@pytest.mark.parametrize("text", _TEXTS)
def test_classify_matches_reference(text):
    """The token tables are the JAX package's: every text lands in the
    class of the same name in both packages."""
    assert resilience.classify(text).__name__ == \
        jres.classify(text).__name__
    assert resilience.classify(RuntimeError(text)).__name__ == \
        jres.classify(RuntimeError(text)).__name__


def test_classify_taxonomy():
    assert resilience.classify("RESOURCE_EXHAUSTED: oom") is DeviceOOM
    assert resilience.classify("relay not listening") is RelayDownError
    assert resilience.classify("UNAVAILABLE: socket") \
        is TransientBackendError
    assert resilience.classify(
        "RecursionError: maximum recursion depth exceeded") is ProgramError
    assert resilience.classify(DeviceOOM("x")) is DeviceOOM
    assert resilience.classify("DEVICE_LOST: x") is DeviceLostError
    # what the card raises: torch's OOM and the kernels' launch errors
    assert resilience.classify(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 1.00 GiB")) is DeviceOOM
    assert resilience.classify(
        "CUDA kernel x failed to launch (cudaError 2: out of memory)") \
        is DeviceOOM


def test_classified_wraps_and_passes_through():
    raw = ValueError("UNAVAILABLE: hiccup")
    ce = resilience.classified(raw, site="t")
    assert isinstance(ce, TransientBackendError)
    assert ce.site == "t" and ce.__cause__ is raw
    assert resilience.classified(ce) is ce
    assert issubclass(CheckpointCorruptError, ProgramError)
    assert all(issubclass(c, ResilienceError) for c in
               (TransientBackendError, RelayDownError, DeviceOOM,
                ProgramError, DeadlineExpired, DeviceLostError))
    assert {n for n in jres.__all__ if n[0].isupper()} - \
        set(resilience.__all__) == {"FirstTouch"}


# ---------------------------------------------------------------------------
# retry / backoff determinism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(seed=7), dict(seed=8),
                                dict(base=1.0, max_delay=5.0, seed=0),
                                dict(factor=3.0, jitter=0.5, seed=2)])
def test_backoff_schedule_matches_reference(kw):
    a = resilience.backoff_schedule(8, **kw)
    assert a == jres.backoff_schedule(8, **kw)
    assert a == resilience.backoff_schedule(8, **kw)


def test_backoff_schedule_envelope():
    assert resilience.backoff_schedule(6, seed=7) != \
        resilience.backoff_schedule(6, seed=8)
    base = resilience.backoff_schedule(8, base=1.0, factor=2.0,
                                       max_delay=5.0, jitter=0.25, seed=0)
    for i, d in enumerate(base):
        nominal = min(5.0, 2.0 ** i)
        assert 0.75 * nominal <= d <= 1.25 * nominal


def test_retry_recovers_from_transient_without_reexec():
    """One injected transient at ``halo.exchange``: retry() recovers in
    process, and the ghosts equal the JAX package's after its own
    retried exchange, bit for bit."""
    tv, jv = _halo_vec(dt), _halo_vec(dr_tpu)
    slept, jslept = [], []
    with faults.injected("halo.exchange", "transient", times=1) as sp:
        resilience.retry(lambda: dt.halo(tv).exchange(), attempts=3,
                         sleep=slept.append)
        assert sp.fired == 1
    with jfaults.injected("halo.exchange", "transient", times=1):
        jres.retry(lambda: dr_tpu.halo(jv).exchange(), attempts=3,
                   sleep=jslept.append)
    assert slept == jslept == resilience.backoff_schedule(2)[:1]
    rows = np.stack([r[0].numpy() for r in tv._rows])
    np.testing.assert_array_equal(rows, np.asarray(jv._data))


def test_retry_does_not_hammer_nonretryable():
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("deterministic bug")

    with pytest.raises(ProgramError):
        resilience.retry(boom, attempts=5, sleep=lambda s: None)
    assert len(calls) == 1

    calls.clear()

    def oom():
        calls.append(1)
        raise RuntimeError("CUDA out of memory. Tried to allocate 16 GiB")

    with pytest.raises(DeviceOOM):
        resilience.retry(oom, attempts=5, sleep=lambda s: None)
    assert len(calls) == 1


def test_device_lost_is_not_retried():
    """Until the elastic slice brings the shrink, a lost device surfaces
    classified on the first attempt."""
    calls = []

    def lost():
        calls.append(1)
        raise RuntimeError("DEVICE_LOST: rank 3")

    with pytest.raises(DeviceLostError):
        resilience.retry(lost, attempts=4, sleep=lambda s: None)
    assert calls == [1]


def test_retry_rejects_nonpositive_attempts():
    with pytest.raises(ValueError, match="attempts"):
        resilience.retry(lambda: 1, attempts=0)


def test_retry_exhaustion_raises_classified():
    calls, seen = [], []

    def always_transient():
        calls.append(1)
        raise RuntimeError("UNAVAILABLE: still down")

    with pytest.raises(TransientBackendError):
        resilience.retry(always_transient, attempts=3,
                         sleep=lambda s: None,
                         on_retry=lambda i, e, d: seen.append((i, d)))
    assert len(calls) == 3
    assert [i for i, _ in seen] == [0, 1]
    assert [d for _, d in seen] == resilience.backoff_schedule(2)


def test_retry_preserves_cause_chain():
    root = ValueError("root cause")

    def boom():
        raise ProgramError("classified") from root

    with pytest.raises(ProgramError) as ei:
        resilience.retry(boom, attempts=3, sleep=lambda s: None)
    assert ei.value.__cause__ is root
    with pytest.raises(ProgramError) as ei2:
        resilience.retry(lambda: (_ for _ in ()).throw(KeyError("raw")),
                         attempts=1, sleep=lambda s: None)
    assert isinstance(ei2.value.__cause__, KeyError)


def test_retry_deadline_and_budget():
    """``deadline_s`` skips a retry that would land past it; an empty
    ``TokenBudget`` denies the retry at once."""
    calls = []

    def flaky():
        calls.append(1)
        raise RuntimeError("UNAVAILABLE: flaky")

    with pytest.raises(TransientBackendError):
        resilience.retry(flaky, attempts=5, base=10.0,
                         sleep=lambda s: None, deadline_s=1.0)
    assert calls == [1]
    calls.clear()
    budget = resilience.TokenBudget(1, ratio=0.5)
    with pytest.raises(TransientBackendError):
        resilience.retry(flaky, attempts=5, sleep=lambda s: None,
                         budget=budget)
    assert len(calls) == 2 and budget.spent == 1 and budget.denied == 1
    budget.note_success()
    assert budget.tokens() == 0.5
    snap = budget.snapshot()
    jb = jres.TokenBudget(1, ratio=0.5)
    jb.spend(), jb.spend(), jb.note_success()
    assert snap == jb.snapshot()


def test_probe_timer_matches_reference():
    t, j = resilience.ProbeTimer(0.1, 1.0, 4, seed=3), \
        jres.ProbeTimer(0.1, 1.0, 4, seed=3)
    assert t._delays == j._delays
    now = time.monotonic() + 100.0
    for _ in range(4):
        assert t.due(now)
        t.advance(now)
        assert not t.due(now)
        now += 10.0
    assert t.exhausted() and not t.due(now + 1e6)


# ---------------------------------------------------------------------------
# deadline watchdog + dispatch-trace escalation
# ---------------------------------------------------------------------------

def test_with_deadline_passthrough():
    assert resilience.with_deadline(lambda: 42, 5.0) == 42
    with pytest.raises(KeyError):
        resilience.with_deadline(lambda: {}["missing"], 5.0)


def test_deadline_expiry_dumps_dispatch_trace():
    buf = io.StringIO()
    with spmd_guard.guard() as g:
        dt.fill(dt.distributed_vector(64), 1.0)
        assert g.trace, "fill must dispatch"
        with pytest.raises(DeadlineExpired) as ei:
            resilience.with_deadline(lambda: time.sleep(1.0), 0.1,
                                     site="hung_build", file=buf)
    assert "hung_build" in str(ei.value) and ei.value.site == "hung_build"
    out = buf.getvalue()
    assert "recorded dispatches" in out and "[0]" in out
    buf2 = io.StringIO()
    assert resilience.dump_dispatch_trace(file=buf2) == 0
    assert "no active spmd_guard" in buf2.getvalue()


# ---------------------------------------------------------------------------
# fault registry: spec grammar, sites, counting
# ---------------------------------------------------------------------------

_SPECS = ["halo.exchange:transient*2;checkpoint.write:truncate@1,"
          "collectives.*:oom*inf@3", "kernel.build:program",
          " runtime.init : transient * 3 @ 2 ;", ""]


@pytest.mark.parametrize("spec", _SPECS)
def test_fault_spec_grammar_matches_reference(spec):
    assert faults.parse_spec(spec) == jfaults.parse_spec(spec)


def test_fault_spec_grammar():
    assert faults.parse_spec(_SPECS[0]) == [
        ("halo.exchange", "transient", 2, 0),
        ("checkpoint.write", "truncate", 1, 1),
        ("collectives.*", "oom", None, 3)]
    with pytest.raises(ValueError):
        faults.parse_spec("no-colon-entry")


def test_registry_matches_reference():
    assert faults.sites() == jfaults.sites()
    assert faults.EXCEPTION_KINDS == jfaults.EXCEPTION_KINDS
    assert faults.BEHAVIORAL_KINDS == jfaults.BEHAVIORAL_KINDS


def test_fault_count_env_arms_counting_without_spec(monkeypatch):
    monkeypatch.delenv("DR_GPU_FAULT_SPEC", raising=False)
    monkeypatch.setenv("DR_GPU_FAULT_COUNT", "1")
    assert faults.reload_env() == 0
    faults.fire("fallback.warn")
    assert faults.stats().get("fallback.warn") == 1
    monkeypatch.delenv("DR_GPU_FAULT_COUNT")
    faults.reload_env()
    assert not faults.stats()


def test_reload_env_installs_and_warns(monkeypatch):
    monkeypatch.setenv("DR_GPU_FAULT_SPEC",
                       "halo.exchange:transient;bogus.site:transient")
    with pytest.warns(UserWarning, match="matches no registered"):
        assert faults.reload_env() == 1
    assert any("halo.exchange" in p for p in faults.pending())
    # the JAX package's variable arms nothing here
    monkeypatch.setenv("DR_GPU_FAULT_SPEC", "")
    monkeypatch.setenv("DR_TPU_FAULT_SPEC", "halo.exchange:transient")
    assert faults.reload_env() == 0
    assert not faults.pending()


def test_unknown_site_and_kind_rejected():
    with pytest.raises(ValueError, match="matches no registered"):
        # drlint: ok[R3] negative test: an unregistered site must be rejected loudly at arm time
        faults.inject("not.a.site", "transient")
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.inject("halo.exchange", "lightning")
    with pytest.raises(ValueError, match="unsupported"):
        faults.inject("halo.exchange", "truncate")
    with pytest.raises(ValueError, match="unsupported"):
        faults.inject("fallback.warn", "program")


def test_glob_injection_fires_only_where_supported():
    """'*:oom' passes clean through a site without the oom kind
    (``runtime.init``) without being consumed, then faults the halo."""
    dv = _halo_vec(dt, 32)
    with faults.injected("*", "oom", times=1) as sp:
        dt.init(["cpu"] * P)
        assert sp.fired == 0
        with pytest.raises(DeviceOOM):
            dt.halo(dv).exchange()
        assert sp.fired == 1


def test_injection_counting_and_skip():
    dv = _halo_vec(dt, 32)
    h = dt.halo(dv)
    with faults.injected("halo.exchange", "transient", times=1,
                         after=1) as sp:
        h.exchange()
        assert sp.fired == 0
        with pytest.raises(TransientBackendError):
            h.exchange()
        assert sp.fired == 1
        h.exchange()
        assert sp.fired == 1
    assert faults.stats().get("halo.exchange", 0) >= 3


def test_injected_sites_raise_classified():
    with faults.injected("runtime.init", "transient"):
        with pytest.raises(TransientBackendError) as ei:
            dt.init(["cpu"] * P)
    assert ei.value.site == "runtime.init"
    with faults.injected("runtime.init", "program"):
        with pytest.raises(ProgramError):
            dt.init(["cpu"] * P)
    dt.init(["cpu"] * P)
    comm = dt.default_comm()
    data = comm.scatter(np.zeros((P, 4), np.float32))
    with faults.injected("collectives.shift", "oom"):
        with pytest.raises(DeviceOOM):
            comm.shift_forward(data, periodic=True)
    dv = _halo_vec(dt, 32)
    before = [r.clone() for r in dv._rows]
    with faults.injected("halo.reduce", "program"):
        with pytest.raises(ProgramError):
            dt.halo(dv).reduce_plus()
    # the fault fired before any row was touched
    assert all(torch.equal(a, b) for a, b in zip(before, dv._rows))
    with faults.injected("device.lost", "device_lost") as sp:
        with pytest.raises(DeviceLostError, match="DEVICE_LOST"):
            dt.fill(dv, 1.0)
    assert sp.fired == 1


def test_first_touch_failure_is_classified(monkeypatch):
    """A real failure of the first touch of a card raises classified
    under ``runtime.init``; a hang raises ``DeadlineExpired``.  Nothing
    switches to the CPU (torch.empty stands in for the card here)."""
    card = [torch.device("cuda", 0)]

    def lost(*a, **k):
        raise RuntimeError("CUDA error: device lost (hardware failure)")

    monkeypatch.setattr(torch, "empty", lost)
    with pytest.raises(DeviceLostError) as ei:
        trt._first_touch(card)
    assert ei.value.site == "runtime.init"
    monkeypatch.setattr(torch, "empty", lambda *a, **k: time.sleep(1.0))
    monkeypatch.setattr(trt, "INIT_DEADLINE_S", 0.1)
    with pytest.raises(DeadlineExpired) as ei:
        trt._first_touch(card)
    assert ei.value.site == "runtime.init"
    monkeypatch.undo()
    assert trt.runtime().devices == [torch.device("cpu")] * P


# ---------------------------------------------------------------------------
# spmd_guard divergence under an injected per-process fault
# ---------------------------------------------------------------------------

def test_divergence_under_injected_per_process_fault():
    def tail(n):
        out = dt.distributed_vector(n)
        dt.inclusive_scan(dt.distributed_vector.from_array(
            np.arange(n, dtype=np.float32)), out)

    n = 128
    with spmd_guard.guard() as ga:
        a = dt.distributed_vector(n)
        dt.iota(a, 0)
        dt.fill(a, 1.0)
        tail(n)
    with spmd_guard.guard() as gb:
        b = dt.distributed_vector(n)
        dt.iota(b, 0)
        with faults.injected("dispatch.cache", "transient", times=1):
            with pytest.raises(TransientBackendError):
                dt.fill(b, 1.0)
        tail(n)
    assert ga.digest() != gb.digest()
    i, mine, theirs = spmd_guard.first_divergence(ga.trace, gb.trace)
    assert mine != theirs and "fill" in mine
    assert spmd_guard.first_divergence(ga.trace, list(ga.trace)) is None
    # the faulted fill left b as iota made it
    np.testing.assert_array_equal(dt.to_numpy(b), np.arange(n))
