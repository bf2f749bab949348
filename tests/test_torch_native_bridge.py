"""The port's C++ bridge (``dr_tpu_torch/native``) on the CPU.

- ``bridge_demo`` built against the port drives 4 CPU ranks and passes;
- ``bridge_parity`` built twice, against the port's bridge and against
  ``native/bridge`` (read only, compiled into a temporary directory),
  reads one checkpoint that ``dr_tpu.utils.checkpoint`` wrote from a
  seeded numpy array, runs its fixed sequence on 4 ranks, and the two
  builds agree: bit for bit where the computation is the same
  arithmetic, within the limits the other ``test_torch_*`` files use
  where the summation order or a fused multiply-add may differ;
- ``argsort`` and ``load_vector`` report the real element dtype;
- ``session(0)`` without a card throws with ``init``'s refusal;
- the port's iota holds exact values in float64 and integer rows (the
  demo's f64 check found it computing them in float32).

The input holds random normals: no -0.0, which the JAX package's
readback drops on uneven layouts (ROADMAP.md section 3).
"""

import shutil
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

REPO = Path(__file__).resolve().parent.parent
JAX_BRIDGE = REPO / "native" / "bridge"
RANKS = 4
N = 4096
WINDOW = 256

requires_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                                  reason="g++ not available")

#: results the two bridges compute with the same arithmetic: bit for bit
BITS = ("input", "sort", "sort_desc", "sort_windows", "is_sorted",
        "is_sorted_windows", "sort_by_key_keys", "sort_by_key_values",
        "sort_by_key_window_keys", "sort_by_key_window_values", "argsort",
        "transpose", "submdspan", "i32", "reduce_i32")
#: results whose summation order or fused multiply-adds may differ, with
#: the limits of test_torch_reduce_scan.py (SCAN_TOL), test_torch_stencil.py
#: (STEP_TOL), test_torch_sparse.py, test_torch_matrix.py (GEMM_TOL) and
#: test_torch_surface.py (the expression ops)
CLOSE = {
    "transform": dict(rtol=2e-6, atol=1e-6),
    "transform2": dict(rtol=2e-6, atol=1e-6),
    "for_each": dict(rtol=2e-6, atol=1e-6),
    "inclusive_scan": dict(rtol=1e-4, atol=1e-3),
    "exclusive_scan": dict(rtol=1e-4, atol=1e-3),
    "inclusive_scan_window": dict(rtol=1e-4, atol=1e-3),
    "exclusive_scan_window": dict(rtol=1e-4, atol=1e-3),
    "stencil_iterate": dict(rtol=1e-5, atol=1e-5),
    "gemv": dict(rtol=1e-4, atol=1e-5),
    "gemm": dict(rtol=1e-5, atol=1e-5),
}
#: scalars held to 1e-5 of the sum of |terms| (test_torch_reduce_scan.py)
SCALARS = ("dot", "transform_reduce")

LABELS_CPP = r"""
#include <cstdio>
#include "thp_bridge.hpp"
int main(int argc, char** argv) {
  thp::session s(2);
  for (int i = 1; i < argc; ++i) {
    thp::vector v = s.load_vector(argv[i]);
    thp::vector p = s.argsort(v);
    std::printf("%d %d %zu\n", (int)v.element_dtype(),
                (int)p.element_dtype(), v.size());
  }
  return 0;
}
"""


def _run(args, **kw):
    return subprocess.run([str(a) for a in args], env=native.env(),
                          capture_output=True, text=True, timeout=600, **kw)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Every program of this file, built once (in parallel): the port's
    demo and parity driver, the parity driver against ``native/bridge``
    and the label probe."""
    tmp = tmp_path_factory.mktemp("bridge")
    (tmp / "labels.cpp").write_text(LABELS_CPP)
    jobs = {
        "demo": (native.HERE / "bridge_demo.cpp", {}),
        "parity": (native.HERE / "bridge_parity.cpp", {}),
        "parity_jax": (native.HERE / "bridge_parity.cpp",
                       dict(bridge_dir=JAX_BRIDGE, out_dir=tmp / "jax")),
        "labels": (tmp / "labels.cpp", dict(out_dir=tmp / "labels")),
    }
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(native.build, src, **kw)
                for k, (src, kw) in jobs.items()}
        exes = {k: f.result() for k, f in futs.items()}
    exes["tmp"] = tmp
    return exes


@pytest.fixture(scope="module")
def parity(built):
    """Both parity builds on one checkpoint (written by the JAX package
    on 4 ranks from a seeded numpy array); returns {name: (port, jax)}
    and the input."""
    tmp = built["tmp"]
    x = np.random.default_rng(20261018).standard_normal(N).astype(
        np.float32)
    dr_tpu.init(jax.devices()[:RANKS])
    ckpt = tmp / "x.npz"
    jck.save(str(ckpt), dr_tpu.distributed_vector.from_array(x))
    outs = {k: tmp / f"out_{k}" for k in ("parity", "parity_jax")}
    procs = {}
    for k, out in outs.items():
        out.mkdir()
        procs[k] = subprocess.Popen(
            [str(built[k]), str(RANKS), str(ckpt), str(out), "--window",
             str(WINDOW), "--seed", "5"], env=native.env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for k, p in procs.items():
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, f"{k}: {so[-2000:]}{se[-4000:]}"
        assert "bridge_parity done" in so and f"nprocs {RANKS}" in so
    names = sorted(p.stem for p in outs["parity"].glob("*.f64"))
    got = {nm: tuple(np.fromfile(outs[k] / f"{nm}.f64") for k in outs)
           for nm in names}
    assert names == sorted(p.stem for p in outs["parity_jax"].glob("*.f64"))
    return got, x


@requires_gxx
def test_demo_on_four_cpu_ranks(built):
    out = _run([built["demo"], RANKS])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert f"nprocs={RANKS}" in out.stdout
    assert "bridge demo PASSED" in out.stdout
    assert "launches {" in out.stdout  # the counts line (all 0 here)


@requires_gxx
def test_parity_covers_every_result(parity):
    got, x = parity
    assert set(got) == set(BITS) | set(CLOSE) | set(SCALARS)
    np.testing.assert_array_equal(got["input"][0], x.astype(np.float64))


@requires_gxx
@pytest.mark.parametrize("name", BITS)
def test_parity_bit_for_bit(parity, name):
    port, ref = parity[0][name]
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port.view(np.int64), ref.view(np.int64))


@requires_gxx
@pytest.mark.parametrize("name", sorted(CLOSE))
def test_parity_within_tolerance(parity, name):
    port, ref = parity[0][name]
    assert port.shape == ref.shape and np.all(np.isfinite(port))
    np.testing.assert_allclose(port, ref, **CLOSE[name])


@requires_gxx
@pytest.mark.parametrize("name", SCALARS)
def test_parity_scalars(parity, name):
    got, x = parity
    (port,), (ref,) = got[name]
    x64 = x.astype(np.float64)
    y64 = x64 * 0.5 - 1.25 if name == "dot" else x64
    assert abs(port - ref) <= 1e-5 * float(np.abs(x64) @ np.abs(y64))


@requires_gxx
def test_labels_of_loaded_checkpoints_and_argsort(built, tmp_path):
    """An f64 file (written by the port) and an i32 file (written by the
    JAX package) load with their own labels; argsort's permutation is
    i32 (the JAX bridge labels all three f32)."""
    dt.init(["cpu"] * 2)
    f64 = np.linspace(-3.0, 5.0, 50) + 1e-9
    dt.checkpoint.save(str(tmp_path / "f64"),
                       dt.distributed_vector.from_array(f64))
    dr_tpu.init(jax.devices()[:2])
    i32 = np.arange(70, dtype=np.int32)[::-1].copy()
    jck.save(str(tmp_path / "i32"), dr_tpu.distributed_vector.from_array(i32))
    out = _run([built["labels"], tmp_path / "f64.npz", tmp_path / "i32.npz"])
    assert out.returncode == 0, out.stdout + out.stderr
    # thp::dtype: f32 = 0, f64 = 1, i32 = 2
    assert out.stdout.split("\n")[:2] == ["1 2 50", "2 2 70"]


@requires_gxx
def test_session_zero_without_cuda_throws_init_refusal(built):
    """session(0) is the card: without CUDA it throws, what() carries
    the exception init() raised, and nothing runs on the CPU.  CUDA is
    hidden from the child, so this holds on a machine with a card too."""
    env = native.env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([str(built["demo"]), "0"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2, out.stdout + out.stderr
    assert ("bridge demo FAILED: thp_bridge: dr_tpu_torch.init(): "
            "RuntimeError: dr_tpu_torch.init(): no CUDA device is visible"
            in out.stdout)
    assert "nprocs" not in out.stdout and "PASSED" not in out.stdout


@requires_gxx
def test_build_failure_raises_with_compiler_output(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text('#include "thp_bridge.hpp"\nint main() { thp::nope(); }\n')
    with pytest.raises(RuntimeError, match="(?s)bridge build failed.*error.*nope"):
        native.build(bad, out_dir=tmp_path)
    assert not list(tmp_path.glob("bad-*"))


def test_env_puts_the_repo_and_sys_path_first():
    env = native.env({"PYTHONPATH": "/elsewhere"})
    parts = env["PYTHONPATH"].split(":")
    assert parts[0] == str(REPO) and parts[-1] == "/elsewhere"
    # sys.path in its order, each entry once (pytest may repeat one)
    want = [p for p in dict.fromkeys(sys.path) if p and p != str(REPO)]
    assert parts[1:-1] == want


def test_python_flags_embed_this_interpreter():
    import sysconfig
    cflags, lflags = native.python_flags()
    assert cflags == ["-I" + sysconfig.get_paths()["include"]]
    if sysconfig.get_config_var("Py_ENABLE_SHARED"):
        libdir = sysconfig.get_config_var("LIBDIR")
        assert f"-Wl,-rpath,{libdir}" in lflags
    else:
        assert "-Wl,--export-dynamic" in lflags


@pytest.mark.parametrize("dtype,start", [
    (np.float64, 16777216.5), (np.float64, -3), (np.int32, 3.0 - 2 ** 26),
    (np.int32, 7), (np.float32, 0.5)])
@pytest.mark.parametrize("P", [1, 4])
def test_iota_exact_in_float64_and_integer_rows(P, dtype, start):
    """float64 rows and integer rows with a float start hold start + i
    exactly; float32 rows keep the JAX package's float32 arithmetic."""
    dt.init(["cpu"] * P)
    n = 1 << 12 if dtype != np.int32 else 1 << 25
    v = dt.distributed_vector(n, dtype=dtype)
    dt.iota(v[3:], start)
    got = dt.to_numpy(v)
    if dtype == np.float32:
        dr_tpu.init(jax.devices()[:P])
        j = dr_tpu.distributed_vector(n, dtype=dtype)
        dr_tpu.iota(j[3:], start)
        np.testing.assert_array_equal(got, dr_tpu.to_numpy(j))
        return
    want = np.zeros(n, np.float64)
    want[3:] = np.arange(n - 3, dtype=np.float64) + start
    np.testing.assert_array_equal(got, want.astype(dtype))
    assert got.dtype == dtype


@requires_gxx
def test_phase27_rehearsal(built):
    """chip_smoke.py's phase 27 on 4 CPU ranks at 2^12: the demo passes
    with the direct calls' launch counts, and every digest of the
    parity driver equals the direct sequence's (its mt19937_64 draws
    and its int64 digest agree with the C++ ones)."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from dr_tpu_torch.ops import kernels
    out = chip_smoke.bridge_phase(dt, kernels, 20261016, "cpu",
                                  device="cpu", ranks=RANKS, log2=12,
                                  window=256, reps=2)
    assert len(out["digests"]) == len(BITS) + len(CLOSE) + len(SCALARS)
    assert set(out["calls"]) >= {"dot", "sort_window", "reduce_i32"}
    draws = chip_smoke.mt19937_64(5489, 10000)
    assert int(draws[0]) == 14514284786278117030  # std::mt19937_64()'s first
    assert int(draws[-1]) == 9981545732273789042  # and its 10000th draw
