"""dr_tpu_torch.utils.sanitize against its JAX oracle
(``dr_tpu/utils/sanitize.py``, armed by the reference suite's conftest
under ``DR_TPU_SANITIZE=1``): the recompile budget over canonical keys,
``zero_recompile``, the canon-portability check (a process-local address
or a ``torch.device`` in a dispatch key), the finite checks on the same
arrays as the JAX package's, and ``watch_containers``' per-thread
nesting."""

import threading

import numpy as np
import pytest
import torch

import dr_tpu_torch as dt
from dr_tpu.utils import sanitize as jsan
from dr_tpu_torch.core.pinning import pinned_id
from dr_tpu_torch.utils import sanitize, spmd_guard
from dr_tpu_torch.utils.spmd_guard import TappedCache

P = 4


@pytest.fixture(autouse=True)
def _port():
    dt.init(["cpu"] * P)
    yield
    dt.final()


@pytest.fixture
def armed(monkeypatch):
    """Install the sanitizer's hooks for one test, then remove them."""
    monkeypatch.setenv("DR_GPU_SANITIZE", "1")
    monkeypatch.setattr(sanitize, "_installed", False)
    assert sanitize.install() and sanitize.installed()
    assert spmd_guard._compile_hook is sanitize._on_compile
    sanitize.reset_epoch()
    yield
    spmd_guard._compile_hook = None
    spmd_guard._canon_check_hook = None
    sanitize.reset_epoch()


def test_install_needs_its_own_variable(monkeypatch):
    monkeypatch.setattr(sanitize, "_installed", False)
    monkeypatch.delenv("DR_GPU_SANITIZE", raising=False)
    monkeypatch.setenv("DR_TPU_SANITIZE", "1")
    assert not sanitize.enabled() and not sanitize.install()
    assert spmd_guard._compile_hook is None


def test_recompile_storm_detected(armed, monkeypatch):
    """The same canonical key inserted more than the limit in one epoch
    (three runtimes of one geometry, each pin a new identity) fails
    ``check_recompiles``; the limit is ``DR_GPU_SANITIZE_RECOMPILE_LIMIT``."""
    for _ in range(3):
        dt.init(["cpu"] * P)
        dt.fill(dt.distributed_vector(40), 1.0)
    counts = sanitize.recompile_counts()
    zeros = [c for k, c in counts.items() if k.startswith("('zeros'")]
    assert zeros == [3]
    with pytest.raises(sanitize.SanitizeError, match="recompile storm"):
        sanitize.check_recompiles()
    sanitize.check_recompiles(limit=3)
    monkeypatch.setenv("DR_GPU_SANITIZE_RECOMPILE_LIMIT", "3")
    sanitize.check_recompiles()
    sanitize.reset_epoch()
    assert sanitize.recompile_counts() == {}


def test_zero_recompile_region():
    def work(n):
        v = dt.distributed_vector.from_array(np.arange(n, dtype=np.float32))
        out = dt.distributed_vector(n)
        dt.inclusive_scan(v, out)
        return dt.reduce(out)

    first = work(96)
    with sanitize.zero_recompile("second pass"):
        assert work(96) == first
    with pytest.raises(sanitize.SanitizeError, match="fresh layout"):
        with sanitize.zero_recompile("fresh layout"):
            work(97)


def test_canon_portability(armed):
    """A key whose canon holds a process-local address, or a torch
    device, fails at its insert (and at record time under a guard)."""
    c = TappedCache()

    class Rich:
        pass

    with pytest.raises(sanitize.SanitizeError, match="process-local"):
        c.tap(("t", Rich()))
    with pytest.raises(sanitize.SanitizeError, match="torch.device"):
        c.tap(("t", torch.device("cpu")))
    c.tap(("t", pinned_id(Rich())))  # pinned: canonicalizes to ptr
    with spmd_guard.guard():
        with pytest.raises(sanitize.SanitizeError, match="torch.device"):
            spmd_guard.record(("t", torch.device("cpu", 0)))
    # the whole main path keys portably
    v = dt.distributed_vector.from_array(
        np.linspace(0, 1, P * 256).astype(np.float32),
        halo=dt.halo_bounds(128, 128, periodic=True))
    with spmd_guard.guard():
        dt.halo(v).exchange()
        dt.stencil_iterate_matmul(v, [0.25, 0.5, 0.25], 8, k_block=8)
        dt.dot_n(v, v, 1)
        dt.inclusive_scan(v, dt.distributed_vector(P * 256))
    sanitize.check_recompiles()


_ARRAYS = [np.array([1.0, 2.0], np.float32),
           np.array([1.0, np.nan], np.float32),
           np.array([np.inf, 0.0], np.float64),
           np.array([1, 2, 3], np.int32),
           np.array([True, False]),
           np.zeros((0,), np.float32)]


@pytest.mark.parametrize("i", range(len(_ARRAYS)))
def test_finite_checks_match_reference(i):
    a = _ARRAYS[i]
    want = jsan.is_finite(a)
    assert sanitize.is_finite(torch.from_numpy(a)) == want
    assert sanitize.is_finite(a) == want
    if want:
        sanitize.check_finite(torch.from_numpy(a), "x")
    else:
        with pytest.raises(sanitize.SanitizeError, match="non-finite"):
            sanitize.check_finite(torch.from_numpy(a), "x")
    assert sanitize.is_finite(torch.from_numpy(a).to(torch.bfloat16)
                              if a.dtype.kind == "f" else
                              torch.from_numpy(a)) == want


def test_watch_containers_nests_per_thread():
    seen, inner = [], []
    assert sanitize._access_hook is None
    with sanitize.watch_containers(lambda k, c: seen.append((k, c))):
        assert sanitize._access_hook is not None
        sanitize._access_hook("r", "a")
        with sanitize.watch_containers(lambda k, c: inner.append((k, c)),
                                       born=lambda c: inner.append(c)):
            sanitize._access_hook("w", "b")
            sanitize._born_hook("c")
        sanitize._access_hook("r", "d")
        other = []
        t = threading.Thread(target=lambda: other.append(
            sanitize._access_hook("r", "e")))
        t.start()
        t.join()
    assert seen == [("r", "a"), ("r", "d")]
    assert inner == [("w", "b"), "c"]
    assert sanitize._access_hook is None and sanitize._born_hook is None
