"""The chaos sweep over the port's fault sites, against its JAX oracle
(``tests/test_chaos.py``): for every (site, kind) the port fires, one
injected fault ends the battery in a classified error raised at that
site, within its deadline: no hang, no unclassified traceback.  A
``transient`` injected once at a site and retried gives the same bits as
the clean run.  The battery is ``chip_smoke.py``'s phase 22 battery (4
CPU ranks here, small shapes), and its clean results match the JAX
package's on the same numpy-seeded inputs.

``kernel.build`` fires only where a CUDA kernel is built or launched:
on the CPU every wrapper takes its plain version by routing, fault or
not, which its two cases assert (the card's cases are chip_smoke phase
22 and ``tests/test_torch_gpu.py``).  The battery ends with the elastic
leg of ``tests/test_chaos.py``'s battery: a shrink of the last rank
(``mesh.shrink``) and the grow back (``device.recover``, ``mesh.grow``),
a team vector rescued bit for bit through both and a lost one raising.
The serving daemon's ``serve.*`` and ``arena.*`` sites are driven
against a live daemon (``tests/test_torch_serve.py``,
``tests/test_torch_serve_dataplane.py``), and the router's
``router.*`` sites against a live fleet
(``tests/test_torch_serve_router.py``, chip_smoke phase 26.3)."""

import importlib.util
import os

import jax
import numpy as np
import pytest

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.utils import elastic as jelastic
from dr_tpu.utils import faults as jfaults
from dr_tpu.utils import resilience as jresilience
from dr_tpu_torch.utils import elastic, faults, resilience

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip)

P = 4
SEED = 22
SIZES = dict(log2=12, sort_per=256, ra=(512, 2, 1, 128), gemv_log2=8)
SHAPE = dict(ranks=P, k_block=64, mm_halo=128)
DEADLINE = 120.0


@pytest.fixture(scope="module")
def inputs():
    return chip.chaos_inputs(SEED, ranks=P, **SIZES)


@pytest.fixture(scope="module")
def clean(inputs, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clean") / "c.npz")
    out = chip.chaos_battery(dt, inputs, path, "cpu", **SHAPE)
    dt.final()
    return out


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()
    elastic.reset()
    dt.final()


def _run(inputs, tmp_path):
    return chip.chaos_battery(dt, inputs, str(tmp_path / "c.npz"), "cpu",
                              **SHAPE)


def test_registry_and_pending_sites():
    """The registry is the JAX package's; the sites the port never fires
    are the two it has no code for."""
    assert faults.sites() == jfaults.sites()
    assert set(faults.PORT_PENDING) < set(faults.sites())
    assert faults.PORT_PENDING == {"runtime.probe": None,
                                   "fallback.warn": None}
    # the daemon's and the router's sites fire in the port, outside
    # this battery
    assert {s for s, _ in chip.serve_sites(faults)} == {
        "serve.accept", "serve.request", "serve.flush", "serve.drain",
        "serve.journal", "arena.map", "arena.release"}
    assert chip.router_sites(faults) == [
        ("router.route", "transient"), ("router.route", "program"),
        ("router.probe", "transient"), ("router.probe", "program")]
    assert not set(chip.serve_sites(faults)) & set(chip.port_sites(faults))
    assert not set(chip.router_sites(faults)) & set(chip.port_sites(faults))


def test_battery_reaches_every_site(inputs, clean, tmp_path):
    """Counting armed: the battery visits every site the port fires
    (``kernel.build`` on the card only), none it does not, and counting
    changes no bit."""
    faults.arm_counting()
    got = _run(inputs, tmp_path)
    visits = faults.stats()
    fired = {s for s, _ in chip.port_sites(faults)}
    assert {s for s in visits if visits[s]} == fired - {"kernel.build"}
    assert chip.same_bits(got, clean)


@pytest.mark.parametrize("site,kind", chip.port_sites(faults))
def test_chaos_every_site_and_kind(site, kind, inputs, clean, tmp_path):
    """One fault at (site, kind): a classified error raised at the site
    (a torn checkpoint refused as ``CheckpointCorruptError`` on read),
    within the deadline."""
    with faults.injected(site, kind, times=1) as sp:
        try:
            got = resilience.with_deadline(
                lambda: _run(inputs, tmp_path), DEADLINE,
                site=f"chaos:{site}:{kind}", dump=False)
        except resilience.DeadlineExpired:
            raise AssertionError(f"HANG: {site}:{kind}")
        except resilience.ResilienceError as e:
            assert e.site == ("checkpoint.read" if kind == "truncate"
                              else site)
            assert sp.fired == 1
            if kind == "truncate":
                assert isinstance(e, resilience.CheckpointCorruptError)
            return
    # only kernel.build passes clean on the CPU: the plain route
    assert site == "kernel.build" and sp.fired == 0
    assert chip.same_bits(got, clean)


@pytest.mark.parametrize("site", list(dict.fromkeys(
    s for s, k in chip.port_sites(faults)
    if k == "transient" and s != "kernel.build")))
def test_transient_retry_same_bits(site, inputs, clean, tmp_path):
    """A transient once at ``site``, and ``retry``: the same bits as the
    clean battery (the port's float sums run in a fixed order)."""
    slept = []
    with faults.injected(site, "transient", times=1) as sp:
        got = resilience.retry(lambda: _run(inputs, tmp_path), attempts=2,
                               sleep=slept.append)
    assert sp.fired == 1 and len(slept) == 1
    assert chip.same_bits(got, clean)


def test_battery_matches_reference(inputs, clean, tmp_path):
    """The clean battery's results against the JAX package's same ops on
    the same inputs: data movement and the sort bit for bit, the scan,
    dot and gemv within f32 tolerances."""
    dr_tpu.init(jax.devices()[:P])
    src = inputs["src"]
    n = src.size
    v = dr_tpu.distributed_vector.from_array(
        src, halo=dr_tpu.halo_bounds(1, 1, periodic=True))
    h = dr_tpu.halo(v)
    h.exchange()
    h.reduce_plus()
    np.testing.assert_array_equal(clean["halo"].numpy(),
                                  np.asarray(v._data))
    comm = dr_tpu.default_comm()
    np.testing.assert_array_equal(
        clean["shift"].numpy(),
        np.asarray(comm.shift_forward(v._data, periodic=True)))
    np.testing.assert_array_equal(
        clean["a2a"].numpy(),
        np.asarray(comm.alltoall(comm.scatter(inputs["a2a"]))))
    sv = dr_tpu.distributed_vector.from_array(inputs["sort"])
    dr_tpu.sort(sv)
    np.testing.assert_array_equal(clean["sort"].numpy(),
                                  dr_tpu.to_numpy(sv))
    sc = dr_tpu.distributed_vector(n)
    dr_tpu.inclusive_scan(dr_tpu.distributed_vector.from_array(src), sc)
    np.testing.assert_allclose(clean["scan"].numpy(), dr_tpu.to_numpy(sc),
                               rtol=1e-5, atol=1e-4)
    x = dr_tpu.distributed_vector.from_array(inputs["x"])
    y = dr_tpu.distributed_vector.from_array(inputs["y"])
    np.testing.assert_allclose(float(clean["dot"][0]),
                               float(dr_tpu.dot_n(x, y, 1)), rtol=1e-5)
    m, rows, cols, vals = inputs["coo"]
    ref = np.zeros(m, np.float64)
    np.add.at(ref, rows, vals.astype(np.float64) * inputs["b"][cols])
    np.testing.assert_allclose(clean["gemv"].numpy(), ref, rtol=1e-4,
                               atol=1e-5)
    rdv = dr_tpu.distributed_vector.from_array(src)
    dr_tpu.redistribute(rdv, [n] + [0] * (P - 1))
    dr_tpu.redistribute(rdv, None)
    for k in ("redistribute", "checkpoint"):
        np.testing.assert_array_equal(clean[k].numpy(), dr_tpu.to_numpy(rdv))
    assert np.isfinite(clean["attention"].numpy()).all()
    assert np.isfinite(clean["stencil"].numpy()).all()
    # the elastic leg: the JAX package's shrink and grow of the last rank
    esrc = src[:4 * P]
    team = dr_tpu.distributed_vector.from_array(
        esrc, distribution=[esrc.size] + [0] * (P - 1))
    jelastic.rescue_session(jresilience.DeviceLostError("loss", rank=P - 1))
    np.testing.assert_array_equal(clean["shrink"].numpy(),
                                  dr_tpu.to_numpy(team))
    jelastic.grow_session()
    np.testing.assert_array_equal(clean["grow"].numpy(),
                                  dr_tpu.to_numpy(team))
    np.testing.assert_array_equal(clean["grow"].numpy(), esrc)
    jelastic.reset()
    dr_tpu.final()


def test_phase22_rehearsal(tmp_path):
    """chip_smoke's phase 22.1 function on the CPU at the test's shapes:
    every case ends as the sweep above says."""
    out = chip.chaos_phase(dt, SEED, str(tmp_path), device="cpu",
                           **SHAPE, **SIZES)
    assert out["kernel.build:program"] == "plain route"
    assert out["checkpoint.write:truncate"] == "CheckpointCorruptError"
    assert sum(v == "same bits" for v in out.values()) == 15
