"""The port's C++ bridge across processes (``thp::distributed``,
``session(const distributed&)``), on the CPU.

- ``bridge_mp_demo`` in 2 and 3 processes, one CPU rank each over gloo:
  every process exits 0 and prints ``PASSED``;
- ``bridge_parity --mp`` in 2 processes from one checkpoint (written by
  the JAX package from a seeded numpy array): each process's results
  equal the port's single-controller ``bridge_parity 2`` bit for bit,
  and match the JAX bridge's ``bridge_parity 2`` under the split of
  ``tests/test_torch_native_bridge.py`` (bit for bit where the
  arithmetic is the same, its tolerances where the order of additions
  may differ);
- a session outside the one-rank-a-process rule throws, naming it:
  ``ncpu_devices = 2``, and a ``process_id`` outside
  ``[0, num_processes)``;
- ``to_host`` returns each element type's values exactly (float64,
  int32, float32);
- ``chip_smoke.py``'s phase 32 runs on CPU processes.
"""

import shutil
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.utils import checkpoint as jck
from dr_tpu_torch import native
from test_torch_native_bridge import BITS, CLOSE, SCALARS

REPO = Path(__file__).resolve().parent.parent
JAX_BRIDGE = REPO / "native" / "bridge"
N = 4096
WINDOW = 256

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ not available")

PROBE_CPP = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include "thp_bridge.hpp"
// probe session NCPU NPROC PID: build a distributed session, print what
// it threw; probe to_host PATH...: each loaded vector's to_host() bits
int main(int argc, char** argv) {
  if (std::strcmp(argv[1], "session") == 0) {
    thp::distributed d;
    d.coordinator = "localhost:1";
    d.ncpu_devices = std::atoi(argv[2]);
    d.num_processes = std::atoi(argv[3]);
    d.process_id = std::atoi(argv[4]);
    try {
      thp::session s(d);
    } catch (const std::exception& e) {
      std::printf("threw: %s\n", e.what());
      return 3;
    }
    return 0;
  }
  thp::session s(2);
  for (int i = 2; i < argc; ++i) {
    for (double x : s.load_vector(argv[i]).to_host()) {
      unsigned long long bits;
      std::memcpy(&bits, &x, sizeof bits);
      std::printf("%016llx ", bits);
    }
    std::printf("\n");
  }
  return 0;
}
"""


def _port():
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _group(argvs, timeout=300):
    """Run one program a process, all at once; returns (exit code,
    stdout + stderr) of each."""
    procs = [subprocess.Popen([str(a) for a in argv], env=native.env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
        return [(p.returncode, o) for p, o in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Every program of this file, built once (in parallel): the port's
    multi-process demo and parity driver, the parity driver against
    ``native/bridge`` and the probe."""
    tmp = tmp_path_factory.mktemp("bridge_mp")
    (tmp / "probe.cpp").write_text(PROBE_CPP)
    jobs = {
        "demo": (native.HERE / "bridge_mp_demo.cpp", {}),
        "parity": (native.HERE / "bridge_parity.cpp", {}),
        "parity_jax": (native.HERE / "bridge_parity.cpp",
                       dict(bridge_dir=JAX_BRIDGE, out_dir=tmp / "jax")),
        "probe": (tmp / "probe.cpp", dict(out_dir=tmp / "probe")),
    }
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(native.build, src, **kw)
                for k, (src, kw) in jobs.items()}
        exes = {k: f.result() for k, f in futs.items()}
    exes["tmp"] = tmp
    return exes


@pytest.fixture(scope="module")
def parity(built):
    """``bridge_parity --mp`` in two processes, the port's and the JAX
    bridge's ``bridge_parity 2``, all at once from one checkpoint;
    returns {run: {name: values}} and the input."""
    tmp = built["tmp"]
    x = np.random.default_rng(20261019).standard_normal(N).astype(
        np.float32)
    dr_tpu.init(jax.devices()[:2])
    ckpt = tmp / "x.npz"
    jck.save(str(ckpt), dr_tpu.distributed_vector.from_array(x))
    common = [ckpt, None, "--window", WINDOW, "--seed", "5"]
    port = _port()
    runs = {f"mp{pid}": [built["parity"], 1] + common
            + ["--mp", pid, 2, port] for pid in (0, 1)}
    runs["single"] = [built["parity"], 2] + common
    runs["jax"] = [built["parity_jax"], 2] + common
    for k, argv in runs.items():
        (tmp / f"out_{k}").mkdir()
        argv[3] = tmp / f"out_{k}"
    got = {}
    for (k, argv), (rc, out) in zip(runs.items(), _group(runs.values())):
        assert rc == 0, f"{k}: {out[-4000:]}"
        assert "bridge_parity done" in out and "nprocs 2" in out, out
        got[k] = {p.stem: np.fromfile(p)
                  for p in (tmp / f"out_{k}").glob("*.f64")}
    return got, x


@pytest.mark.parametrize("nproc", [2, 3])
def test_demo_in_cpu_processes(built, nproc):
    port = _port()
    res = _group([[built["demo"], pid, nproc, port, "cpu"]
                  for pid in range(nproc)])
    for pid, (rc, out) in enumerate(res):
        assert rc == 0, out[-3000:]
        assert f"bridge_mp_demo pid={pid}/{nproc} nprocs={nproc}" in out
        assert f"bridge_mp_demo pid={pid}/{nproc}: PASSED" in out
        assert "launches {" in out  # the counts line (all 0 here)


def test_demo_refuses_another_device_word(built):
    out = subprocess.run([str(built["demo"]), "0", "2", "1", "tpu"],
                         env=native.env(), capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 2 and "not cpu or cuda" in out.stderr


def test_parity_covers_every_result(parity):
    got, x = parity
    for run in got.values():
        assert set(run) == set(BITS) | set(CLOSE) | set(SCALARS)
    np.testing.assert_array_equal(got["mp0"]["input"], x.astype(np.float64))


@pytest.mark.parametrize("pid", [0, 1])
@pytest.mark.parametrize("name", sorted(set(BITS) | set(CLOSE)
                                        | set(SCALARS)))
def test_mp_parity_equals_one_controller(parity, name, pid):
    mine, one = parity[0][f"mp{pid}"][name], parity[0]["single"][name]
    assert mine.shape == one.shape
    np.testing.assert_array_equal(mine.view(np.int64), one.view(np.int64))


@pytest.mark.parametrize("name", sorted(set(BITS) | set(CLOSE)
                                        | set(SCALARS)))
def test_mp_parity_matches_the_jax_bridge(parity, name):
    got, x = parity
    port, ref = got["mp0"][name], got["jax"][name]
    assert port.shape == ref.shape
    if name in BITS:
        np.testing.assert_array_equal(port.view(np.int64),
                                      ref.view(np.int64))
    elif name in CLOSE:
        assert np.all(np.isfinite(port))
        np.testing.assert_allclose(port, ref, **CLOSE[name])
    else:  # scalars: 1e-5 of the sum of |terms|
        x64 = x.astype(np.float64)
        y64 = x64 * 0.5 - 1.25 if name == "dot" else x64
        assert abs(port[0] - ref[0]) <= 1e-5 * float(np.abs(x64)
                                                     @ np.abs(y64))


@pytest.mark.parametrize("ncpu,nproc,pid,rule", [
    (2, 2, 0, "ncpu_devices = 2: the port runs one rank a process"),
    (-1, 2, 0, "ncpu_devices = -1: the port runs one rank a process"),
    (1, 2, 2, "process_id = 2 of num_processes = 2: one rank a process"),
    (1, 0, 0, "process_id = 0 of num_processes = 0: one rank a process"),
])
def test_session_outside_the_rule_throws(built, ncpu, nproc, pid, rule):
    """Nothing joins: the session throws before the interpreter starts
    (no coordinator is contacted) and names the rule."""
    out = subprocess.run([str(built["probe"]), "session", str(ncpu),
                          str(nproc), str(pid)], env=native.env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 3, out.stdout + out.stderr
    assert f"threw: thp_bridge: distributed.{rule}" in out.stdout


def test_to_host_converts_each_element_type_exactly(built, tmp_path):
    """float64 values no float32 holds, int32 values beyond 2^24 and
    float32 normals come back through ``to_host`` with their exact
    values (one conversion pass from each array's own buffer)."""
    dt.init(["cpu"] * 2)
    vals = {"f64": 16777216.5 + np.arange(37) * 1e-3,
            "i32": (np.arange(41, dtype=np.int64) * 98765431
                    - 2 ** 31 + 7).astype(np.int32),
            "f32": np.random.default_rng(3).standard_normal(53).astype(
                np.float32)}
    paths = []
    for tag, v in vals.items():
        dt.checkpoint.save(str(tmp_path / tag),
                           dt.distributed_vector.from_array(v))
        paths.append(tmp_path / f"{tag}.npz")
    dt.final()
    out = subprocess.run([str(built["probe"]), "to_host"] + [str(p)
                                                             for p in paths],
                         env=native.env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    for line, v in zip(lines, vals.values()):
        got = np.array([int(h, 16) for h in line.split()], np.uint64)
        want = v.astype(np.float64).view(np.uint64)
        np.testing.assert_array_equal(got, want)


def test_phase32_rehearsal(built):
    """chip_smoke.py's phase 32 on two CPU processes at 2^12: the demo
    passes in both with their ranks' launch counts, and every digest of
    each ``bridge_parity --mp`` process equals the direct sequence's on
    one controller."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from dr_tpu_torch.ops import kernels
    out = chip_smoke.bridge_mp_phase(dt, kernels, 20261016, "cpu",
                                     device="cpu", log2=12, window=256)
    assert len(out["digests"]) == len(BITS) + len(CLOSE) + len(SCALARS)
    assert set(out["calls"]) >= {"dot", "sort_window", "reduce_i32"}
    assert {"p0_ms", "p1_ms", "direct_ms"} <= set(out["calls"]["dot"])
    assert out["p0_start_ms"] > 0 and out["p1_start_ms"] > 0
    assert chip_smoke.rank_share({"chunked_dot": 4, "bitonic_sort": 3}, 2) \
        == {"chunked_dot": 2, "bitonic_sort": 3}
    with pytest.raises(AssertionError, match="not once a rank"):
        chip_smoke.rank_share({"segred": 3}, 2)
