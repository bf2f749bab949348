"""The four CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``; each test decides in a fixture whether a card is
present and skips without one (run on the card with
``python -m pytest -m gpu tests/test_torch_*.py``)."""

import numpy as np
import pytest
import torch

from dr_tpu_torch.ops import (kernels, reduce_pallas, scan_pallas,
                              stencil_matmul, stencil_pallas)

pytestmark = pytest.mark.gpu

W5 = (0.05, 0.25, 0.4, 0.25, 0.05)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain K1 in full f32
    gen = torch.Generator(device="cuda").manual_seed(7)
    return torch.device("cuda", 0), gen


def _launched(name, fn):
    before = kernels.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    return out


@pytest.mark.parametrize("seg,halo,k", [(1 << 16, 512, 256), (4096, 128, 8),
                                        (8192, 256, 100)])
def test_k1_kernel_matches_plain(cuda, seg, halo, k):
    dev, gen = cuda
    row = torch.randn((1, 2 * halo + seg), generator=gen, device=dev)
    got = _launched("stencil_matmul", lambda: stencil_matmul.
                    matmul_stencil_row(row, seg, halo, W5, k))
    ref = stencil_matmul.plain_apply(row, seg, halo, W5, k)
    # direct f32 FMA band vs f32 matmul: weighted averages of O(1) data
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seg,halo,T,w", [(1 << 16, 1024, 64, W5),
                                          (3072, 1024, 5, (0.1, 0.2, 0.7))])
def test_k2_kernel_matches_plain(cuda, seg, halo, T, w):
    dev, gen = cuda
    row = torch.randn((1, 2 * halo + seg), generator=gen, device=dev)
    got = _launched("stencil_blocked", lambda: stencil_pallas.
                    blocked_stencil_row(row, seg, halo, w, T))
    ref = stencil_pallas.plain_blocked(row, seg, halo, w, T)
    # same separately rounded products and sums: bit-identical
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_k3_kernel_matches_plain(cuda, dtype):
    dev, gen = cuda
    n = (1 << 20) + 12
    x = torch.rand(n, generator=gen, device=dev).to(dtype)
    y = torch.rand(n, generator=gen, device=dev).to(dtype)
    salt = torch.tensor(0.5, device=dev)
    got = _launched("chunked_dot",
                    lambda: reduce_pallas.chunked_dot(x, y, salt=salt))
    ref = reduce_pallas.plain_dot(x, y, salt)
    # positive f32 sums of ~1e6 terms in two orders: 1e-5 relative
    assert abs(float(got) - float(ref)) <= 1e-5 * float(ref)
    again = reduce_pallas.chunked_dot(x, y, salt=salt)
    assert torch.equal(got, again)  # fixed order: same bits every run


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_kernel_matches_plain(cuda, dtype):
    dev, gen = cuda
    n = (1 << 20) + 128 * 3
    x = torch.randn(n, generator=gen, device=dev).to(dtype)
    carry = torch.tensor(-2.0, device=dev)
    got = _launched("chunked_cumsum",
                    lambda: scan_pallas.chunked_cumsum(x, carry=carry))
    ref = scan_pallas.plain_cumsum(x, carry)
    assert got.dtype == dtype
    scale = float(ref.float().abs().max())
    # f32: prefixes summed in two orders, 1e-5 of the largest prefix;
    # bf16: two bf16 ulps (2^-6) of it, each side rounding its output
    tol = 1e-5 * scale if dtype == torch.float32 else 2 ** -6 * scale
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("n,halo", [(1_000_003, 0), (3 * 16384 + 5, 2)])
def test_scan_and_dot_n_launch_the_kernels_at_any_length(cuda, n, halo):
    """Lengths off the JAX kernel's 16384-element chunks, ragged ranks
    and ghost-bearing rows still launch K4 and K3, once per rank."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    dt.init(dt.get_duplicated_devices(3, ["cuda:0"]))
    try:
        src = torch.randn(n, generator=gen, device=dev)
        kw = {"halo": dt.halo_bounds(halo, halo)} if halo else {}
        a = dt.distributed_vector.from_array(src, **kw)
        out = dt.distributed_vector(n, **kw)
        k4 = kernels.launches["chunked_cumsum"]
        dt.inclusive_scan(a, out)
        torch.cuda.synchronize()
        assert kernels.launches["chunked_cumsum"] == k4 + 3
        ref = torch.cumsum(src.double(), 0)
        # f32 prefixes in two orders: 1e-5 of the largest prefix
        err = float((out.to_array().double() - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max())
        k3 = kernels.launches["chunked_dot"]
        d = dt.dot_n(a, a, 2)
        torch.cuda.synchronize()
        assert kernels.launches["chunked_dot"] == k3 + 2 * 3
        exact = float((src.double() ** 2).sum())
        # positive f32 sums of ~1e6 terms in two orders: 1e-5 relative
        assert abs(float(d) - exact) <= 1e-5 * exact
    finally:
        dt.final()


def test_kernels_refuse_what_they_do_not_take(cuda):
    dev, _ = cuda
    row = torch.zeros((1, 2 * 1024 + 2048), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        stencil_pallas.blocked_stencil_row(row, 2048, 1024, W5, 4)
    x = torch.zeros(1024, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        scan_pallas.chunked_cumsum(x)
    with pytest.raises(ValueError):
        reduce_pallas.chunked_dot(x, x)
    assert np.isfinite(float(reduce_pallas.chunked_dot(
        x.float(), x.float())))
