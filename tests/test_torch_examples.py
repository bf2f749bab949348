"""The JAX package's ``examples/`` scripts on the port
(``dr_tpu_torch.examples``), on the CPU.

For each of the 15 examples, at the small arguments of
``tests/test_examples.py``: the port's ``main(argv + ["--cpu", "8"])``
returns 0 (its own oracle passed), the JAX script's ``main`` runs with
the same arguments under ``sys.argv`` on the conftest's 8-device mesh
and returns 0 or None, and the two print the same lines: equal words and
integers, floats within the tolerance stated in ``FLOAT_TOL``.  A rank's
device is named by each backend (``device=cpu`` against
``device=TFRT_CPU_0`` in ``print_range``), so the word after
``device=`` is left out.  The JAX script is never given ``--cpu``: it
would set XLA flags after JAX's initialisation.

CG also solves one Laplacian with both packages' ``cg``: the port's
``x`` within 1e-4 of the JAX package's and within 1e-3 of the dense
solve, the iteration counts within one.  Last, ``chip_smoke.py``'s
phase 33 runs here on CPU ranks (1 and 4), small.
"""

import contextlib
import importlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu_torch import examples

REPO = Path(__file__).resolve().parent.parent

#: small arguments, as tests/test_examples.py:97-107 gives them
SMALL = {
    "conjugate_gradient": ["-n", "256"],
    "dot_product": ["-n", "4096"],
    "gemv_example": ["-m", "512", "-n", "512"],
    "heat_2d": ["-m", "64", "-n", "64"],
    "inclusive_scan_example": ["-n", "4096"],
    "matrix_example": [],
    "ring_attention_example": ["--seq", "128"],
    "sort_example": ["-n", "4096"],
    "spmm_example": ["-m", "512", "-k", "4", "--nv", "3"],
    "stencil_1d": ["-n", "4096", "-s", "5"],
    "top_k": ["-n", "4099", "-k", "5"],
    "transpose": ["-m", "48", "-n", "32"],
    "vector_add": ["-n", "4096"],
    "views_example": [],
    "windows_example": ["-n", "4096"],
}
CASES = sorted(SMALL.items()) + [("sort_example", ["-n", "4097",
                                                    "--descending"])]

#: (rtol, atol) of the floats the two packages print: the sums of
#: dot_product (4 decimals) differ in the order of f32 additions; the
#: error magnitudes CG and ring attention print are each package's own
#: rounding noise, held to the examples' oracle bounds (CG's resid 1e-3,
#: max_err 1e-2; ring attention 1e-3); every other float is a value the
#: two compute alike, printed to 3-8 digits
FLOAT_TOL = {"dot_product": (1e-5, 2e-4),
             "conjugate_gradient": (0.0, 1e-2),
             "ring_attention_example": (0.0, 1e-3)}
DEFAULT_TOL = (1e-6, 1e-6)
#: numbers that may differ beyond that: CG's iteration count, within one
LOOSE = {"conjugate_gradient": {"iters": (0, 1)}}


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    return rc, re.sub(r"device=\S+", "device=", buf.getvalue())


@pytest.fixture
def port_ranks():
    yield
    dt.final()


@pytest.mark.parametrize("name,argv", CASES,
                         ids=[f"{n}{'-'.join([''] + a)}" for n, a in CASES])
def test_example_matches_the_jax_script(name, argv, monkeypatch,
                                        port_ranks):
    port = importlib.import_module(f"dr_tpu_torch.examples.{name}")
    rc, got = _printed(lambda: port.main(argv + ["--cpu", "8"]))
    assert rc == 0, got
    assert dt.nprocs() == 8
    ref = _jax_script(name)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    jrc, want = _printed(ref.main)
    assert jrc in (0, None), want
    assert got.strip() and got.count("\n") == want.count("\n"), (got, want)
    rtol, atol = FLOAT_TOL.get(name, DEFAULT_TOL)
    why = _chip_smoke().tokens_differ(got, want, rtol, atol,
                                      LOOSE.get(name))
    assert why is None, f"{why}\nport:\n{got}\njax:\n{want}"


def test_every_example_is_a_module():
    assert sorted(SMALL) == sorted(examples.NAMES)
    assert sorted(p.stem for p in (REPO / "examples").glob("*.py")) == \
        sorted(examples.NAMES)
    for name in examples.NAMES:
        mod = importlib.import_module(f"dr_tpu_torch.examples.{name}")
        assert callable(mod.main), name


def test_device_arguments(port_ranks):
    """No device argument is the card (raising without one); ``--cpu``
    and ``--ranks`` exclude each other."""
    import argparse
    import torch
    ap = examples.device_args(argparse.ArgumentParser())
    assert ap.parse_args(["--cpu", "3"]).cpu == 3
    assert ap.parse_args(["--ranks", "4"]).ranks == 4
    with pytest.raises(SystemExit):
        ap.parse_args(["--cpu", "2", "--ranks", "2"])
    rt = examples.init(ap.parse_args(["--cpu", "3"]))
    assert [d.type for d in rt.devices] == ["cpu"] * 3
    if not torch.cuda.is_available():
        from dr_tpu_torch.examples import dot_product
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dot_product.main(["-n", "64"])
        with pytest.raises(Exception, match="CUDA"):
            dot_product.main(["-n", "64", "--ranks", "2"])


def test_expect_raises_under_every_flag():
    examples.expect(True, "never")
    with pytest.raises(AssertionError, match="the oracle"):
        examples.expect(False, "the oracle")


def test_conjugate_gradient_against_the_jax_cg_and_a_dense_solve(
        port_ranks):
    from dr_tpu_torch.examples.conjugate_gradient import build_laplacian, cg
    ref = _jax_script("conjugate_gradient")
    n = 256
    ii, jj, vv = build_laplacian(n)
    for got, want in zip(build_laplacian(n), ref.build_laplacian(n)):
        np.testing.assert_array_equal(got, want)
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    dt.init(["cpu"] * 8)
    x, resid, its = cg(dt.sparse_matrix.from_coo((n, n), ii, jj, vv), b,
                       iters=100)
    jx, jresid, jits = ref.cg(dr_tpu.sparse_matrix.from_coo((n, n), ii, jj,
                                                            vv), b,
                              iters=100)
    assert resid < 1e-3 and its < 60 and abs(its - jits) <= 1
    Ad = np.zeros((n, n), dtype=np.float64)
    Ad[ii, jj] = vv
    dense = np.linalg.solve(Ad, b.astype(np.float64))
    got = dt.to_numpy(x)
    np.testing.assert_allclose(got, dr_tpu.to_numpy(jx), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, dense, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("a,b,slack,why", [
    ("n=4 dot=1.5 PASS", "n=4 dot=1.5000001 PASS", None, None),
    ("n=4 dot=1.5 PASS", "n=5 dot=1.5 PASS", None, "n 4 against 5"),
    ("iters=20 x", "iters=21 x", {"iters": (0, 1)}, None),
    ("iters=20 x", "iters=22 x", {"iters": (0, 1)}, "iters 20 against 22"),
    ("total=51939980", "total=51939984", {"total": (1e-3, 0)}, None),
    ("total=51939980", "total=51939984", None, "total 51939980 against"),
    ("check=PASS", "check=FAIL", None, "'PASS' against 'FAIL'"),
    ("err = 4.2e-07", "err = 9.9e-04", None, "err"),
    ("a\nb", "a", None, "2 lines against 1"),
])
def test_result_tokens_comparison(a, b, slack, why):
    got = _chip_smoke().tokens_differ(a, b, 1e-6, 1e-6, slack)
    assert (got is None) if why is None else (why in got), got


def test_phase33_rehearsal(port_ranks):
    """chip_smoke.py's phase 33 on 1 and 4 CPU ranks at the small
    arguments: every example returns 0 with its kernels' versions and
    with the plain ones, the two print the same results, and nothing
    launches on the CPU."""
    from dr_tpu_torch.ops import kernels
    cs = _chip_smoke()
    out = cs.examples_phase(dt, kernels, "cpu", device="cpu", argv=SMALL)
    runs = {k: v for k, v in out.items() if k[:2] == "33"}
    assert len(runs) == 2 * len(examples.NAMES)
    assert "65536" in runs["33.2 sort_example"]["args"]
    assert all(v["launches"] == {} for v in runs.values())
