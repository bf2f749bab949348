"""The frozen yardstick: the roofline arithmetic, the trace reading and
the import guard."""

import json

import pytest

from drbench import harness, peaks
from drbench.trace import TraceView, global_kernels, kernel_base

W5 = (0.05, 0.25, 0.4, 0.25, 0.05)
N = 1 << 30


def test_k1_bound_at_2p30():
    ms, by = peaks.k1_bound_ms(N, W5, 256)
    assert by == "operations"
    assert ms == pytest.approx(3 * 2 * 1025 * N / 989e12 * 1e3)
    assert round(ms, 3) == 6.677


def test_k2_and_plain_bounds_at_2p30():
    ms, by = peaks.k2_bound_ms(N, W5, 64)
    assert by == "operations" and round(ms, 3) == 9.231
    ms, by = peaks.plain_step_bound_ms(N)
    assert by == "bytes" and round(ms, 4) == 2.5642


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_idle_share_of_a_synthetic_trace(tmp_path):
    k = "void (anonymous namespace)::stencil_matmul_kernel<4>(float const*)"
    events = [
        _ev("user_annotation", "drbench.stencil_iterate_matmul", 0, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 2, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 8, 2, correlation=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 150, 2, correlation=3),
        _ev("cpu_op", "aten::zeros", 30, 10),
        _ev("kernel", k, 10, 20, correlation=1),
        _ev("kernel", k, 25, 10, correlation=2),   # overlaps the first
        _ev("gpu_memcpy", "Memcpy DtoD", 50, 10, correlation=3),
        _ev("gpu_memset", "Memset", 100, 10),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    view = TraceView.load(path, global_kernels(
        {"stencil_matmul": "__global__ void stencil_matmul_kernel(int x)"}))
    # busy: [10, 35] + [50, 60] + [100, 110] = 45 of a 100 us window
    assert view.window_us == 100 and view.busy_us == 45
    assert view.idle_share() == pytest.approx(0.55)
    assert view.kernel_us("stencil_matmul") == (30.0, 2)
    assert view.cat_us(("gpu_memcpy", "gpu_memset")) == 20
    assert view.top_ops(1)[0][0] == "K1 stencil_matmul_kernel"
    gaps = view.longest_gaps(10)
    assert [g for _, g in gaps] == [40.0, 15.0]
    assert "aten::zeros" in gaps[1][0]
    span, = view.spans("drbench.stencil_iterate_matmul")
    assert view.device_us_under(span) == 25.0


def test_kernel_base_names():
    assert kernel_base("void (anonymous namespace)::scan_tiles<float>"
                       "(float const*, int)") == "scan_tiles"
    assert kernel_base("dot_partials_f32x4") == "dot_partials_f32x4"


def test_import_guard_compares_whole_names():
    assert harness.forbidden_modules(["dr_tpu_torch", "dr_tpu_torch.ops",
                                      "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(["dr_tpu", "dr_tpu.algorithms"]) == [
        "dr_tpu"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib"]
