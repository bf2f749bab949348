"""The eight CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``; each test decides in a fixture whether a card is
present and skips without one (run on the card with
``python -m pytest -m gpu tests/test_torch_*.py``)."""

import operator

import numpy as np
import pytest
import torch

from dr_tpu_torch.ops import (flash_attention, kernels, reduce_pallas,
                              scan_pallas, segred_pallas, sort_pallas,
                              stencil2d_pallas, stencil_matmul, stencil_pallas,
                              stencil_step)

pytestmark = pytest.mark.gpu

W5 = (0.05, 0.25, 0.4, 0.25, 0.05)
HEAT = ((0.0, 0.25, 0.0), (0.25, 0.0, 0.25), (0.0, 0.25, 0.0))
FULL3 = ((0.05, 0.1, 0.05), (0.1, 0.4, 0.1), (0.05, 0.1, 0.05))


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


W3A = (0.1, 0.2, 0.7)
W17 = tuple(k / 153.0 for k in range(1, 18))  # r = 8, asymmetric
TILE1 = 16384  # cells in one of K1's tiles (256 block rows of 64)


@pytest.mark.parametrize("seg,halo,k,w", [
    (1 << 16, 512, 256, W5), (4096, 128, 8, W5), (8192, 256, 100, W5),
    (TILE1 + 256, 128, 1, W5),           # r = 2, k = 1; a partial tile
    (128, 512, 256, W5),                 # two block rows: under a tile
    (TILE1, 256, 256, W3A),              # r = 1, k = 256
    (4 * TILE1 + 4096, 128, 1, W3A),     # r = 1, k = 1; a partial tile
    (4224, 512, 512, W3A),               # r = 1 at max_ksteps(1)
    (1 << 16, 128, 100, W3A),            # r = 1, k = 100
    (2 * TILE1 + 8192, 128, 8, W17),     # r = 8, k = 8
    (3 * TILE1 + 128, 512, 64, W17)])    # r = 8 at max_ksteps(8)
def test_k1_kernel_matches_plain(cuda, seg, halo, k, w):
    dev, gen = cuda
    assert k <= stencil_matmul.max_ksteps((len(w) - 1) // 2)
    row = torch.randn((1, 2 * halo + seg), generator=gen, device=dev)
    got = _launched("stencil_matmul", lambda: stencil_matmul.
                    matmul_stencil_row(row, seg, halo, w, k))
    ref = stencil_matmul.plain_apply(row, seg, halo, w, k)
    # bf16x3 tensor-core products (the TPU kernel's HIGH emulation, rel.
    # error ~2^-16 a product) vs an f32 matmul: weighted averages of O(1)
    # data
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("w,k", [(W5, 256), (W3A, 100), (W17, 64)])
def test_k1_kernel_bits(cuda, w, k):
    """K1's bits depend on a cell's inputs alone: two launches agree, a
    sub-row cut at another 128-aligned offset (its ghosts from the same
    data) gives the cells it shares the same bits, ghosts come back
    stale."""
    dev, gen = cuda
    seg, halo = 3 * TILE1 + 640, 512
    row = torch.randn((1, 2 * halo + seg), generator=gen, device=dev)
    got = stencil_matmul.matmul_stencil_row(row, seg, halo, w, k)
    assert torch.equal(got, stencil_matmul.matmul_stencil_row(
        row, seg, halo, w, k))
    assert torch.equal(got[:, :halo], row[:, :halo])
    assert torch.equal(got[:, halo + seg:], row[:, halo + seg:])
    for cut, sub in ((128, TILE1), (4096 + 384, TILE1 + 8320),
                     (seg - 256, 256)):
        part = stencil_matmul.matmul_stencil_row(
            row[:, cut:cut + 2 * halo + sub], sub, halo, w, k)
        assert torch.equal(part[:, halo:halo + sub],
                           got[:, halo + cut:halo + cut + sub])


@pytest.mark.parametrize("seg,halo,T,w", [
    (1 << 16, 1024, 64, W5), (3072, 1024, 5, W3A),
    (20480, 1024, 1, W5),      # T = 1; seg not a multiple of the centre
    (20480, 1024, 17, W3A),    # r = 1, T = 17
    (1024, 1024, 64, W17),     # r = 8: one partial tile
    (4096, 1024, 128, W17),    # T * r = halo
    (1024, 1024, 1024, W3A),   # T * r = halo at r = 1
    (4096, 3072, 300, W17)])   # T * r > 2048: the shared-memory route
def test_k2_kernel_matches_plain(cuda, seg, halo, T, w):
    dev, gen = cuda
    row = torch.randn((1, 2 * halo + seg), generator=gen, device=dev)
    got = _launched("stencil_blocked", lambda: stencil_pallas.
                    blocked_stencil_row(row, seg, halo, w, T))
    ref = stencil_pallas.plain_blocked(row, seg, halo, w, T)
    # same separately rounded products and sums: bit-identical
    assert torch.equal(got, ref)
    # and the same bits on a second call, and on another stream
    assert torch.equal(got, stencil_pallas.blocked_stencil_row(
        row, seg, halo, w, T))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = stencil_pallas.blocked_stencil_row(row, seg, halo, w, T)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(got, again)


def test_k2_kernel_misaligned_row(cuda):
    """A row 4 bytes past a 16-byte boundary takes the kernel's
    shared-memory route, with the same bits."""
    dev, gen = cuda
    seg, halo = 8192, 1024
    base = torch.randn((1, 2 * halo + seg + 1), generator=gen, device=dev)
    row = base[:, 1:]
    assert row.is_contiguous() and row.data_ptr() % 16 == 4
    got = _launched("stencil_blocked", lambda: stencil_pallas.
                    blocked_stencil_row(row, seg, halo, W5, 64))
    assert torch.equal(got, stencil_pallas.plain_blocked(row, seg, halo, W5,
                                                         64))


# ------------------------------------------------ the plain step's kernel

W9 = tuple(k / 45.0 for k in range(1, 10))  # r = 4, asymmetric


def _step_vectors(dt, gen, n, halo, periodic, dtype=torch.float32):
    """Two vectors with random owned AND ghost cells on the card."""
    hb = dt.halo_bounds(halo, halo, periodic=periodic)
    vs = [dt.distributed_vector(n, dtype, halo=hb) for _ in range(2)]
    for v in vs:
        for row in v.rows:
            row.copy_(torch.randn(row.shape, generator=gen,
                                  device=row.device, dtype=dtype))
    return vs


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("ranks", [1, 4])
@pytest.mark.parametrize("w,halo", [(W3A, 1), (W3A, 3), (W5, 2), (W5, 8),
                                    (W9, 4), (W9, 8), (W17, 8)])
def test_stencil_step_kernel_equals_the_torch_step(cuda, ranks, periodic, w,
                                                   halo):
    """The kernel route of the plain step gives the torch-op step's rows
    bit for bit, halo equal to the radius and wider, on 1 and 4 ranks of
    one card, n a multiple of neither 4 nor the ranks; one launch a rank;
    the in rows and the old out rows, ghosts included, unchanged."""
    import dr_tpu_torch as dt
    from dr_tpu_torch.algorithms import stencil
    dev, gen = cuda
    dt.init(dt.get_duplicated_devices(ranks, [dev]))
    try:
        a, b = _step_vectors(dt, gen, (1 << 20) + 4093, halo, periodic)
        ins = [r.clone() for r in a.rows]
        outs = [r.clone() for r in b.rows]
        op, wt = stencil._weights_op(w)
        r = (len(w) - 1) // 2
        got = _launched_n("stencil_step", ranks, lambda: stencil._step_rows(
            a.layout, a.runtime.devices, a.rows, b.rows, op, r, r,
            periodic))
        want = stencil._torch_step(a.layout, a.runtime.devices, a.rows,
                                   b.rows, op, r, r, periodic)
        assert all(torch.equal(g, e) for g, e in zip(got, want))
        assert all(torch.equal(x, y) for x, y in zip(a.rows, ins))
        assert all(torch.equal(x, y) for x, y in zip(b.rows, outs))
    finally:
        dt.final()


def _launched_n(name, count, fn):
    before = kernels.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + count
    return out


@pytest.mark.parametrize("shift_in,shift_out", [(1, 0), (2, 0), (0, 3),
                                                (1, 1)])
def test_stencil_step_kernel_rows_off_16_bytes(cuda, shift_in, shift_out):
    """Rows 4-12 bytes past a 16-byte boundary take the kernel's scalar
    route, with the plain version's bits (the plain version on the
    card), given ghosts included; ragged [a, b) ends."""
    dev, gen = cuda
    hprev, valid, w = 8, (1 << 18) + 77, W17
    width = hprev + valid + 8
    base = torch.randn((2, width + 4), generator=gen, device=dev)
    row = base[:1, shift_in:shift_in + width]
    out = base[1:, shift_out:shift_out + width]
    gp = torch.randn((1, hprev), generator=gen, device=dev)
    gn = torch.randn((1, 8), generator=gen, device=dev)
    for a, b in ((0, valid), (5, valid - 9)):
        got = _launched("stencil_step", lambda: stencil_step.step_row(
            row, out, w, hprev, valid, a, b, gp, gn))
        assert torch.equal(got, stencil_step.plain_step_row(
            row, out, w, hprev, valid, a, b, gp, gn))


@pytest.mark.parametrize("kind", ["callable", "float64"])
def test_stencil_steps_off_the_kernel_count_the_torch_route(cuda, kind):
    """A callable op and a float64 row take the torch-op step: no
    launch, and the armed ``stencil.step.torch`` count moves once a
    step; a float32 weight step leaves it at 0."""
    import dr_tpu_torch as dt
    from dr_tpu_torch import obs
    from dr_tpu_torch.algorithms import stencil
    dev, gen = cuda
    dt.init([dev])
    obs.arm(True)
    obs.reset()
    try:
        dtype = torch.float64 if kind == "float64" else torch.float32
        a, b = _step_vectors(dt, gen, (1 << 16) + 3, 2, True, dtype)
        op = stencil._weights_op(W5)[0]
        if kind == "callable":
            def op(*s, _w=op):
                return _w(*s)
        want = stencil._torch_step(a.layout, a.runtime.devices, a.rows,
                                   b.rows, op, 2, 2, True)
        _launched_n("stencil_step", 0, lambda: dt.stencil_transform(
            a, b, op if kind == "callable" else W5))
        assert obs.metrics.counter("stencil.step.torch").value == 1
        assert all(torch.equal(g, e) for g, e in zip(b.rows, want))
        f, g = _step_vectors(dt, gen, (1 << 16) + 3, 2, True)
        _launched_n("stencil_step", 1, lambda: dt.stencil_transform(f, g,
                                                                    W5))
        assert obs.metrics.counter("stencil.step.torch").value == 1
    finally:
        obs.arm(False)
        obs.reset()
        dt.final()


def test_stencil_iterate_on_card_has_the_cpu_ranks_bits(cuda):
    """Five periodic W5 steps of ``stencil_iterate`` on 4 ranks of the
    card (the kernel, 20 launches) and on 4 CPU ranks (the torch ops)
    give the same bits."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    n = (1 << 18) + 6
    src = torch.randn(n, generator=gen, device=dev)
    got = []
    for devs in (dt.get_duplicated_devices(4, [dev]), ["cpu"] * 4):
        dt.init(devs)
        try:
            hb = dt.halo_bounds(2, 2, periodic=True)
            a = dt.distributed_vector.from_array(src.to(devs[0]), halo=hb)
            b = dt.distributed_vector(n, torch.float32, halo=hb)
            before = kernels.launches["stencil_step"]
            dt.stencil_iterate(a, b, W5, 5)
            torch.cuda.synchronize()
            assert kernels.launches["stencil_step"] - before == (
                20 if devs[0] != "cpu" else 0)
            got.append(a.to_array().cpu())
        finally:
            dt.final()
    assert torch.equal(got[0], got[1])


def test_plan_fused_stencil_takes_the_kernel_with_the_eager_bits(cuda):
    """``stencil_transform`` recorded in a deferred region (the plan's
    fused exchange + step, flushed, then replayed) launches the kernel
    once a rank and gives the eager call's bits."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    dt.init(dt.get_duplicated_devices(4, [dev]))
    try:
        src = torch.randn((1 << 16) + 5, generator=gen, device=dev)
        hb = dt.halo_bounds(2, 2, periodic=True)
        ea, da = (dt.distributed_vector.from_array(src, halo=hb)
                  for _ in range(2))
        eb, db = (dt.distributed_vector(len(src), torch.float32, halo=hb)
                  for _ in range(2))
        plan = dt.plan.Plan()
        for _ in range(3):
            kernels.reset_counts()
            dt.stencil_transform(ea, eb, W5)
            dt.for_each(ea, _pl_shift, 0.25)
            want_counts = dict(kernels.launches)
            assert want_counts["stencil_step"] == 4
            kernels.reset_counts()
            with plan.record():
                dt.stencil_transform(da, db, W5)
                dt.for_each(da, _pl_shift, 0.25)
            torch.cuda.synchronize()
            assert dict(kernels.launches) == want_counts
            assert _rows_equal(da, ea) and _rows_equal(db, eb)
    finally:
        dt.plan._plan_cache.clear()
        dt.final()


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


@pytest.mark.parametrize("ranks", [1, 4])
def test_dot_takes_k3_at_2_25_and_matches_plain(cuda, ranks):
    """``dot`` of two plain f32 containers launches K3 once a rank at
    the serving phase's size, within a tight tolerance of the plain
    version, the same bits every run; a bf16 ``dot`` stays off K3."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    n = 1 << 25
    dt.init(dt.get_duplicated_devices(ranks, ["cuda:0"]))
    try:
        x = torch.randn(n, generator=gen, device=dev)
        y = torch.randn(n, generator=gen, device=dev)
        a = dt.distributed_vector.from_array(x)
        b = dt.distributed_vector.from_array(y)
        k3 = kernels.launches["chunked_dot"]
        got = dt.dot(a, b)
        torch.cuda.synchronize()
        assert kernels.launches["chunked_dot"] == k3 + ranks
        ref = float(reduce_pallas.plain_dot(x, y))
        mag = float((x.double() * y.double()).abs().sum())
        # f32 sums of 2^25 products in two orders: 1e-6 of sum |x*y|
        assert abs(float(got) - ref) <= 1e-6 * mag
        assert abs(float(got) - float((x.double() * y.double()).sum())) \
            <= 1e-6 * mag
        again = dt.dot(a, b)
        assert np.float32(got).view(np.int32) == \
            np.float32(again).view(np.int32)
        h = dt.distributed_vector.from_array(x.to(torch.bfloat16))
        k3 = kernels.launches["chunked_dot"]
        dt.dot(h, h)
        torch.cuda.synchronize()
        assert kernels.launches["chunked_dot"] == k3
    finally:
        dt.final()


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _k4_check(got, x, ref, carry):
    """K4 against plain_cumsum under chip_smoke.py's rules: f32 within
    1e-5 of the largest prefix (prefixes summed in two orders) and every
    output adding exactly its own element up to 8 ulps of that prefix
    (``step_err``: a dropped or doubled element shows at its own size);
    bf16 and f16 within two ulps of their type at the largest prefix,
    each side rounding its f32 prefix once."""
    scale = float(ref.float().abs().max())
    if x.dtype != torch.float32:
        ulp = 2 ** -7 if x.dtype == torch.bfloat16 else 2 ** -10
        assert float((got.float() - ref.float()).abs().max()) <= \
            2 * ulp * max(scale, 1.0)
        return
    assert float((got - ref).abs().max()) <= 1e-5 * max(scale, 1.0)
    start = torch.tensor([0.0 if carry is None else float(carry)],
                         dtype=torch.float64, device=got.device)
    steps = torch.diff(got.double(), prepend=start) - x.double()
    ulp = 2.0 ** (np.frexp(max(scale, 1.0))[1] - 24)
    assert float(steps.abs().max()) <= 8 * ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [1, 15, "tile-1", "tile", "tile+1",
                               (1 << 20) + 3, (1 << 20) + 128 * 3,
                               1 << 28])   # 16384+ tiles: look-back under load
@pytest.mark.parametrize("off", [0, 1, 2, 3])  # elements past 16 bytes
@pytest.mark.parametrize("carry", [-2.0, None])
def test_k4_kernel_matches_plain(cuda, dtype, n, off, carry):
    dev, gen = cuda
    if isinstance(n, str):   # about one tile of the kernel
        size = torch.empty((), dtype=dtype).element_size()
        n = scan_pallas._TILE_BYTES // size + int(n[4:] or 0)
    base = torch.randn(n + 3, generator=gen, device=dev).to(dtype)
    x = base[off:off + n]
    assert x.data_ptr() % 16 == off * x.element_size() % 16
    c = None if carry is None else torch.tensor(carry, device=dev)
    got = _launched("chunked_cumsum",
                    lambda: scan_pallas.chunked_cumsum(x, carry=c))
    ref = scan_pallas.plain_cumsum(x, c)
    assert got.dtype == dtype and got.shape == x.shape
    _k4_check(got, x, ref, carry)
    # a fixed-order look-back: the same bits on every call
    again = scan_pallas.chunked_cumsum(x, carry=c)
    assert torch.equal(_bits(got), _bits(again))


def test_k4_same_bits_on_two_streams(cuda):
    """Two calls in flight at once, on two streams, each with its own
    status words, give the bits of a call alone."""
    dev, gen = cuda
    x = torch.randn((1 << 26) + 5, generator=gen, device=dev)[1:]
    carry = torch.tensor(0.75, device=dev)
    want = scan_pallas.chunked_cumsum(x, carry=carry)
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for s in streams:
        s.wait_stream(main)
        with torch.cuda.stream(s):
            outs.append(scan_pallas.chunked_cumsum(x, carry=carry))
    for s in streams:
        main.wait_stream(s)
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(_bits(got), _bits(want))
    _k4_check(want, x, scan_pallas.plain_cumsum(x, carry), 0.75)


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


def _k5_tol(w, T, x):
    """Twice the bound on an f32 result's distance from the exact one
    after T steps of nonnegative weights summing to 1: each step rounds
    its nnz products and nnz-1 sums, each by <= 2^-24 of max|x|."""
    nnz = int(np.count_nonzero(np.asarray(w)))
    return 2 * T * (2 * nnz - 1) * 2.0 ** -24 * float(x.abs().max())


@pytest.mark.parametrize("m,n,T,w,band,pad", [
    (1000, 128, 1, HEAT, None, 1),       # m off the kernel's tiles
    (517, 384, 5, FULL3, None, 5),       # all nine taps
    (300, 16384, 16, HEAT, 100, 16),     # the main path's width and T
    (1234, 384, 16, FULL3, 617, 16),     # an explicit band
    (131, 128, 70, HEAT, None, 70),      # T past MAX_T: two launches
    (1000, 16384, 16, HEAT, None, 16),   # 666 tiles: each block walks 5+
    (229, 640, 17, HEAT, None, 17),      # T off 4: 20-column margins
    (333, 1152, 64, FULL3, None, 64),    # MAX_T in one launch
    (450, 896, 16, FULL3, None, 24),     # pad > T, as a remainder pass
    (113, 256, 7, HEAT, None, 16),       # pad > T, m below one tile
])
def test_k5_kernel_matches_plain(cuda, m, n, T, w, band, pad):
    dev, gen = cuda
    xp = torch.randn((m + 2 * pad, n), generator=gen, device=dev)
    before = kernels.launches["stencil2d_blocked"]
    got = stencil2d_pallas.blocked_stencil2d_padded(xp, m, w, T, pad,
                                                    band=band)
    torch.cuda.synchronize()
    assert kernels.launches["stencil2d_blocked"] == \
        before + -(-T // stencil2d_pallas.MAX_T)
    ref = stencil2d_pallas.plain_blocked2d(xp, m, w, T, pad)
    # FMA-contracted sums vs separately rounded ones
    assert float((got - ref).abs().max()) <= _k5_tol(w, T, xp)
    # pad rows pass through; edge rows and columns stay frozen
    assert torch.equal(got[:pad + 1], xp[:pad + 1])
    assert torch.equal(got[pad + m - 1:], xp[pad + m - 1:])
    assert torch.equal(got[:, [0, n - 1]], xp[:, [0, n - 1]])


def test_k5_path_launches_once_per_pass(cuda):
    """stencil2d_iterate_blocked and stencil2d_n on a card matrix: one K5
    launch per pass, remainder pass included."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    dt.init(["cuda:0"])
    try:
        src = torch.randn((333, 256), generator=gen, device=dev)
        w = dt.heat_step_weights(0.25)
        M = dt.dense_matrix.from_array(src)
        k5 = kernels.launches["stencil2d_blocked"]
        dt.stencil2d_iterate_blocked(M, w, 21, time_block=8)
        dt.stencil2d_n(M, w, 2, time_block=8)
        torch.cuda.synchronize()
        assert kernels.launches["stencil2d_blocked"] == k5 + 3 + 2
        xp = torch.nn.functional.pad(src, (0, 0, 8, 8))
        ref = stencil2d_pallas.plain_blocked2d(xp, 333, w, 8, 8)
        for t in (8, 5, 8, 8):
            ref = stencil2d_pallas.plain_blocked2d(ref, 333, w, t, 8)
        got = M.to_array()
        assert float((got - ref[8:8 + 333]).abs().max()) <= \
            _k5_tol(w, 37, src)
    finally:
        dt.final()


def test_kernels_refuse_what_they_do_not_take(cuda):
    dev, _ = cuda
    row = torch.zeros((1, 2 * 1024 + 2048), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        stencil_pallas.blocked_stencil_row(row, 2048, 1024, W5, 4)
    grid = torch.zeros((64 + 8, 128), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        stencil2d_pallas.blocked_stencil2d_padded(grid, 64, HEAT, 4, 4)
    with pytest.raises(ValueError):
        stencil2d_pallas.blocked_stencil2d_padded(grid.bfloat16(), 64, HEAT,
                                                  4, 4)
    x = torch.zeros(1024, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        scan_pallas.chunked_cumsum(x)
    with pytest.raises(ValueError):
        reduce_pallas.chunked_dot(x, x)
    assert np.isfinite(float(reduce_pallas.chunked_dot(
        x.float(), x.float())))


def _same_bits(got, want):
    """Bit-equal, a NaN matching a NaN at the same position."""
    if got.is_floating_point():
        gn, wn = torch.isnan(got), torch.isnan(want)
        assert torch.equal(gn, wn)
        got, want = got.masked_fill(gn, 0), want.masked_fill(wn, 0)
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    assert torch.equal(got.view(ints[got.element_size()]),
                       want.view(ints[want.element_size()]))


@pytest.mark.parametrize("M", [256, 1 << 15])
@pytest.mark.parametrize("short", [0, 37])
@pytest.mark.parametrize("kv", [False, True])
def test_k6_kernel_matches_plain(cuda, M, short, kv):
    """Bit for bit against torch.sort of the same keys; KV at 2^15 runs
    on the two-block cluster."""
    dev, gen = cuda
    n = M - short
    keys = torch.randint(-3, 3, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    keys[::5] = torch.iinfo(torch.int32).max
    if not kv:
        got = _launched("bitonic_sort", lambda: sort_pallas.sort_keys(keys))
        assert torch.equal(got, sort_pallas.plain_sort_keys(keys))
        return
    gid = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    gk, gg = _launched("bitonic_sort",
                       lambda: sort_pallas.sort_kv(keys, gid))
    rk, rg = sort_pallas.plain_sort_kv(keys, gid)
    assert torch.equal(gk, rk) and torch.equal(gg, rg)


@pytest.mark.parametrize("b", [1, 8, 133])
@pytest.mark.parametrize("M", [256, 4096, 16384, 1 << 15])
@pytest.mark.parametrize("short", [0, 37])
@pytest.mark.parametrize("kv", [False, True])
def test_k6_batched_kernel_matches_plain(cuda, b, M, short, kv):
    """One launch sorts every row of a (b, n) batch bit for bit as the
    plain version does, 133 rows being more than the card's SMs; keys
    with duplicates and at the pad, pad-like (INT32_MAX, INT32_MAX)
    pairs; KV at 2^15 runs the two-block cluster."""
    dev, gen = cuda
    n = M - short
    imax = torch.iinfo(torch.int32).max
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, n), generator=gen,
                         device=dev, dtype=torch.int32)
    keys[:, ::3] = torch.randint(-3, 3, keys[:, ::3].shape, generator=gen,
                                 device=dev, dtype=torch.int32)
    keys[:, 1::11] = imax
    if not kv:
        got = _launched("bitonic_sort", lambda: sort_pallas.sort_keys(keys))
        assert got.shape == (b, n)
        assert torch.equal(got, sort_pallas.plain_sort_keys(keys))
        return
    gid = torch.argsort(torch.rand((b, n), generator=gen, device=dev),
                        dim=1).to(torch.int32)
    keys[:, -3:] = imax
    gid[:, -3:] = imax
    gk, gg = _launched("bitonic_sort",
                       lambda: sort_pallas.sort_kv(keys, gid))
    rk, rg = sort_pallas.plain_sort_kv(keys, gid)
    assert gk.shape == gg.shape == (b, n)
    assert torch.equal(gk, rk) and torch.equal(gg, rg)


def _k7_column(kind, base, gen, dev):
    """A column of ``kind`` over ``base`` elements: f32 and bf16 with
    NaN, +-0.0 and infinities planted; int8 of the full range; bool."""
    if kind in ("float32", "bfloat16"):
        f = torch.randn(base, generator=gen, device=dev)
        special = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                                float("-inf")], device=dev)
        pos = torch.randint(0, base, (max(base // 8, 1),), generator=gen,
                            device=dev)
        f[pos] = special[torch.randint(0, 5, pos.shape, generator=gen,
                                       device=dev)]
        return f if kind == "float32" else f.bfloat16()
    if kind == "int8":
        return torch.randint(-128, 128, (base,), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)
    return torch.rand(base, generator=gen, device=dev) < 0.7


@pytest.mark.parametrize("n", [1, 15, 17, (1 << 20) + 3])
@pytest.mark.parametrize("nseg", [None, 1, 127, 1024, 1025, 1 << 15])
def test_k7_unaligned_starts_and_ragged_tails(cuda, n, nseg):
    """Columns that start 0 to 3 elements (f32, bf16) or 0 to 15 (int8,
    bool) past a 16-byte boundary, ids at the same and at another
    offset, ragged tails; one launch a call (counted once), against the
    plain version bit for bit, NaN and +-0.0 included."""
    dev, gen = cuda
    base = n + 16
    cols = {k: _k7_column(k, base, gen, dev)
            for k in ("float32", "bfloat16", "int8", "bool")}
    ids = None if nseg is None else torch.randint(
        -2, nseg + 2, (base,), generator=gen, device=dev, dtype=torch.int32)
    for off in range(16):
        calls = []
        if off < 4:
            f, h = cols["float32"][off:off + n], cols["bfloat16"][off:off + n]
            calls.append(((f, "min"), (f, "max"), (h, "min"), (h, "max")))
        i8, tf = cols["int8"][off:off + n], cols["bool"][off:off + n]
        calls.append(((i8, "sum"), (i8, "max"), (tf, "sum"), (tf, "min")))
        for j, c in enumerate(calls):
            io = (off + j) % 4  # the ids aligned with the values, or not
            seg = None if ids is None else ids[io:io + n]
            got = _launched("segred", lambda: segred_pallas.segmented(
                seg, nseg or 1, c))
            for g, r in zip(got, segred_pallas.plain_segmented(
                    seg, nseg or 1, c)):
                _same_bits(g, r)


@pytest.mark.parametrize("nseg", [None, 16, 1 << 15])
def test_k7_back_to_back_and_on_two_streams(cuda, nseg):
    """The workspace's ticket and key table are left zero by every call:
    calls back to back on one stream, and calls queued on two streams
    without waiting for each other, each equal their plain version
    (nseg None, 16 and 2^15 take the one-segment, the two-stage and the
    global-atomic routes)."""
    dev, gen = cuda
    n = (1 << 20) + 5
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                      device=dev, dtype=torch.int32)
    f = torch.randn(n, generator=gen, device=dev)
    ids = None if nseg is None else torch.randint(
        0, nseg, (n,), generator=gen, device=dev, dtype=torch.int32)
    want = [segred_pallas.plain_segmented(ids, nseg or 1, c)
            for c in (((x, "sum"),), ((f, "min"), (x, "max")))]
    got = [segred_pallas.segmented(ids, nseg or 1, c)
           for c in (((x, "sum"),), ((f, "min"), (x, "max")))] * 1
    got += [segred_pallas.segmented(ids, nseg or 1, c)
            for c in (((x, "sum"),), ((f, "min"), (x, "max")))]
    other = torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    main = torch.cuda.current_stream(dev)
    on_two = []
    for _ in range(3):
        on_two.append(segred_pallas.segmented(ids, nseg or 1, ((x, "sum"),)))
        with torch.cuda.stream(other):
            on_two.append(segred_pallas.segmented(
                ids, nseg or 1, ((f, "min"), (x, "max"))))
    main.wait_stream(other)
    torch.cuda.synchronize()
    for g, w in zip(got, want * 2):
        for a, b in zip(g, w):
            _same_bits(a, b)
    for i, g in enumerate(on_two):
        for a, b in zip(g, want[i % 2]):
            _same_bits(a, b)


@pytest.mark.parametrize("nseg", [1, 129, 1 << 15])
def test_k7_kernel_signed_zeros_nan_and_ids(cuda, nseg):
    """Every eligible column against the plain version, bit for bit:
    +-0.0 and NaN in f32 and bf16, int32 wraparound, out-of-range ids
    and empty segments."""
    dev, gen = cuda
    n = 5000
    ids = torch.randint(-2, nseg + 2, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    f = torch.randn(n, generator=gen, device=dev)
    f[::3] = 0.0
    f[1::3] = -0.0
    f[::97] = float("nan")
    i = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                      device=dev, dtype=torch.int32)
    for cols in (((i, "sum"), (i, "prod"), (i, "min"), (i, "max")),
                 ((f, "min"), (f, "max"), (f.bfloat16(), "min"),
                  (f.bfloat16(), "max"))):
        got = _launched("segred",
                        lambda: segred_pallas.segmented(ids, nseg, cols))
        for g, r in zip(got, segred_pallas.plain_segmented(ids, nseg, cols)):
            _same_bits(g, r)
    lo = segred_pallas.segmented(None, 1, ((f[1:3], "min"),))[0]
    assert torch.signbit(lo).item()  # min(-0.0, randn or +-0) is -0.0


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.uint8,
                                   torch.bool])
@pytest.mark.parametrize("nseg", [1, 129])
def test_k7_kernel_narrow_columns(cuda, dtype, nseg):
    """8- and 16-bit integer and bool columns, read in their own width,
    against the plain version bit for bit: sums and products wrap modulo
    the column's width (bool: "any" and "all"), min/max exact; and a
    ``reduce`` of such a container takes K7 on every rank and equals the
    CPU's result."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    n = 5000
    ids = torch.randint(-2, nseg + 2, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    if dtype == torch.bool:
        v = torch.rand(n, generator=gen, device=dev) < 0.9
    else:
        info = torch.iinfo(dtype)
        v = torch.randint(info.min, info.max + 1, (n,), generator=gen,
                          device=dev, dtype=torch.int32).to(dtype)
    cols = ((v, "sum"), (v, "prod"), (v, "min"), (v, "max"))
    got = _launched("segred", lambda: segred_pallas.segmented(ids, nseg, cols))
    for g, r in zip(got, segred_pallas.plain_segmented(ids, nseg, cols)):
        assert g.dtype == dtype and torch.equal(g, r)
    odd = v if dtype == torch.bool else v | 1
    for where in ("cuda:0", "cpu"):
        dt.init(dt.get_duplicated_devices(3, [where]))
        try:
            c = dt.distributed_vector.from_array(odd.to(where))
            before = kernels.launches["segred"]
            res = [dt.reduce(c, op=op) for op in (None, operator.mul, min,
                                                  max)]
            if where == "cpu":
                assert res == on_card
            else:
                on_card = res
                assert kernels.launches["segred"] - before == 4 * 3
        finally:
            dt.final()


def test_sort_path_launch_counts(cuda):
    """On 4 ranks of one card: one K6 launch per sort (the four ranks'
    blocks are one batch) while a rank's block is within the cap, none
    above it; one K7 launch per rank and eligible reduce; results
    against torch.sort."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    dt.init(dt.get_duplicated_devices(4, ["cuda:0"]))
    try:
        for n, k6 in ((4 * 5000, 1), (4 * 40000, 0)):
            src = torch.randn(n, generator=gen, device=dev)
            v = dt.distributed_vector.from_array(src)
            before = dict(kernels.launches)
            dt.sort(v)
            pay = dt.distributed_vector(n, np.int32)
            dt.iota(pay, 0)
            dt.sort_by_key(dt.distributed_vector.from_array(src), pay)
            lo, hi = dt.reduce(v, op=min), dt.reduce(v, op=max)
            isum = dt.reduce(pay)
            torch.cuda.synchronize()
            assert kernels.launches["bitonic_sort"] - \
                before["bitonic_sort"] == 2 * k6
            assert kernels.launches["segred"] - before["segred"] == 3 * 4
            ref = torch.sort(src).values
            assert torch.equal(v.to_array(), ref)
            assert torch.equal(pay.to_array().long(),
                               torch.sort(src, stable=True).indices)
            assert (lo, hi) == (float(ref[0]), float(ref[-1]))
            # the int32 sum wraps modulo 2^32
            assert isum == (n * (n - 1) // 2 + 2 ** 31) % 2 ** 32 - 2 ** 31
    finally:
        dt.final()


def test_sort_kernels_refuse_what_they_do_not_take(cuda):
    """float64 keys: the K6 wrapper raises on a CUDA tensor (8-byte keys
    are interpret-only in the JAX package), and the sort takes
    torch.sort for them; K7 refuses 8-byte columns and float sums."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    x = torch.randn(1000, generator=gen, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        sort_pallas.sort_keys(x)
    with pytest.raises(ValueError):
        sort_pallas.sort_keys(x.view(torch.int64))
    with pytest.raises(ValueError):
        segred_pallas.segmented(None, 1, ((x, "min"),))
    with pytest.raises(ValueError):
        segred_pallas.segmented(None, 1, ((x.float(), "sum"),))
    dt.init(["cuda:0"])
    try:
        v = dt.distributed_vector.from_array(x)
        k6 = kernels.launches["bitonic_sort"]
        dt.sort(v)
        torch.cuda.synchronize()
        assert kernels.launches["bitonic_sort"] == k6
        assert torch.equal(v.to_array(), torch.sort(x).values)
    finally:
        dt.final()


@pytest.mark.parametrize("per", [3000, 40000])
def test_sort_never_waits_for_the_host(cuda, per):
    """Under ``set_sync_debug_mode("error")`` a sort, a descending sort,
    a window sort and key-value sorts (4 ranks, one of them empty; K6
    blocks and torch.sort blocks) make no synchronizing call: the send
    matrices, counts and splitters stay on the card."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    dt.init(dt.get_duplicated_devices(4, ["cuda:0"]))
    try:
        sizes = [2 * per, 0, per, per]
        n = sum(sizes)
        src = torch.randn(n, generator=gen, device=dev)
        v = dt.distributed_vector.from_array(src, distribution=sizes)
        k = dt.distributed_vector.from_array(src.round())
        pay = dt.distributed_vector(n, np.int32)
        dt.iota(pay, 0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dt.sort(v)
            dt.sort(v, descending=True)
            dt.sort(v[5:n - 7])
            dt.sort_by_key(k, pay)
            dt.sort_by_key(k[3:n - 2], pay[1:n - 4], descending=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ref = torch.sort(src).values.flip(0)
        ref[5:n - 7] = torch.sort(ref[5:n - 7]).values
        assert torch.equal(v.to_array(), ref)
    finally:
        dt.final()


# --------------------------------------------------------------- K9

def _k9_operands(gen, dev, BH, group, s, skv, d):
    q = torch.randn((BH, s, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((BH // group, skv, d), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    state = (torch.full((BH, s, 1), float("-inf"), device=dev),
             torch.zeros((BH, s, 1), device=dev),
             torch.zeros((BH, s, d), device=dev))
    return q, k, v, state


def _k9_close(got, want):
    """m: the same max of d-term logits summed in two orders (1e-6; the
    difference grows with d, so d / 256 times that above d = 256); l: f32
    sums of p in two orders (1e-5 relative, as much wider above d = 256);
    acc / l: a bf16 rounding of p may flip between the orders (rtol =
    atol = 2e-3)."""
    (gm, gl, ga), (wm, wl, wa) = got, want
    wide = max(1.0, ga.shape[-1] / 256)
    assert torch.equal(torch.isneginf(gm), torch.isneginf(wm))
    fin = torch.isfinite(wm)
    torch.testing.assert_close(gm[fin], wm[fin], rtol=1e-6 * wide,
                               atol=1e-6 * wide)
    torch.testing.assert_close(gl, wl, rtol=1e-5 * wide, atol=0)
    torch.testing.assert_close(ga / torch.where(gl > 0, gl, 1.0),
                               wa / torch.where(wl > 0, wl, 1.0),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s,d", [(256, 128), (384, 128), (200, 128),
                                 (256, 256), (128, 640), (256, 768)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("offs", ["zero", "past", "future", "diagonal"])
def test_k9_kernel_matches_plain(cuda, s, d, causal, group, offs):
    """One update from zero state at offsets (0, 0), (2s, s) (a past
    block), (s, 2s) (wholly future under the causal mask) or (s + 37, s)
    (the causal diagonal inside a tile), then a second, chained update
    against another block at offset 0.  s = 200 is not a multiple of the
    128-row q tile; group 4 is Llama-3-8B's."""
    dev, gen = cuda
    skv = -(-s // 128) * 128   # the K/V block's length: a multiple of 128
    q, k, v, state = _k9_operands(gen, dev, 4, group, s, skv, d)
    q_off, k_off = {"zero": (0, 0), "past": (2 * s, s),
                    "future": (s, 2 * s), "diagonal": (s + 37, s)}[offs]
    got = _launched("flash_update", lambda: flash_attention.flash_update(
        q, k, v, *state, q_off, k_off, causal=causal))
    want = flash_attention.plain_flash_update(q, k, v, *state, q_off, k_off,
                                              causal=causal)
    _k9_close(got, want)
    if causal and offs == "future":
        assert torch.isneginf(got[0]).all()
        assert not got[1].any() and not got[2].any()
    k2, v2 = (x.flip(1).contiguous() for x in (k, v))
    got = flash_attention.flash_update(q, k2, v2, *got, q_off, 0,
                                       causal=causal)
    want = flash_attention.plain_flash_update(q, k2, v2, *want, q_off, 0,
                                              causal=causal)
    _k9_close(got, want)


def test_k9_refuses_what_it_does_not_take(cuda):
    dev, gen = cuda
    q, k, v, state = _k9_operands(gen, dev, 2, 1, 128, 128, 128)
    with pytest.raises(ValueError):   # f32 q/k/v
        flash_attention.flash_update(q.float(), k.float(), v.float(), *state,
                                     0, 0, causal=True)
    with pytest.raises(ValueError):   # skv % 128
        flash_attention.flash_update(q, k[:, :64].contiguous(),
                                     v[:, :64].contiguous(), *state, 0, 0,
                                     causal=True)
    q64, k64, v64, st64 = _k9_operands(gen, dev, 2, 1, 128, 128, 64)
    with pytest.raises(ValueError):   # d % 128
        flash_attention.flash_update(q64, k64, v64, *st64, 0, 0, causal=True)
    with pytest.raises(ValueError):   # not contiguous
        flash_attention.flash_update(q.transpose(1, 2).contiguous()
                                     .transpose(1, 2), k, v, *state, 0, 0,
                                     causal=True)


@pytest.mark.parametrize("causal", [False, True])
def test_k9_takes_more_than_65535_heads(cuda, causal):
    """65536 q heads (group 4, s = skv = 128, d = 128) in one launch: the
    persistent grid walks (q tile, head), so no grid dimension caps the
    heads.  Every head's state equals, bit for bit, the same heads
    launched 16384 at a time, and matches the plain version: m and l
    under :func:`_k9_close`'s limits, acc / l under its 2e-3 where every
    row attends all 128 keys (non-causal).  Causal, acc / l is held to
    float64 attention under the reference's flash bound instead
    (tests/test_ring_attention.py): at 2^16 heads, rows that attend a
    few keys show single bf16 flips of p above 2e-3 (the mma.sync design
    does on the same inputs too: tools/k9_probe.py)."""
    dev, gen = cuda
    BH, group, s, d = 65536, 4, 128, 128
    q, k, v, state = _k9_operands(gen, dev, BH, group, s, s, d)
    got = _launched("flash_update", lambda: flash_attention.flash_update(
        q, k, v, *state, 0, 0, causal=causal))
    n, nk = 16384, 16384 // group
    parts = [flash_attention.flash_update(
        q[i:i + n], k[i // group:i // group + nk],
        v[i // group:i // group + nk], *(x[i:i + n] for x in state), 0, 0,
        causal=causal) for i in range(0, BH, n)]
    for j in range(3):
        assert torch.equal(got[j], torch.cat([p[j] for p in parts]))
    del parts
    want = flash_attention.plain_flash_update(q, k, v, *state, 0, 0,
                                              causal=causal)
    if not causal:
        _k9_close(got, want)
        return
    fin = torch.isfinite(want[0])
    torch.testing.assert_close(got[0][fin], want[0][fin], rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    del want
    out = got[2] / got[1]
    mask = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    for i in range(0, BH, 4096):
        qb = q[i:i + 4096].double()
        kb, vb = (x[i // group:(i + 4096) // group].double()
                  .repeat_interleave(group, 0) for x in (k, v))
        logits = (qb @ kb.transpose(1, 2) / d ** 0.5).masked_fill(
            ~mask, float("-inf"))
        torch.testing.assert_close(out[i:i + 4096].double(),
                                   torch.softmax(logits, -1) @ vb,
                                   rtol=5e-2, atol=5e-3)


def _ring_inputs(gen, S, h, hkv, d, dev):
    q = torch.randn((1, S, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((1, S, hkv, d), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_on_card_matches_cpu_ranks(cuda, causal):
    """4 ranks of one card (K9, P*P launches; iters*P*P for the chained
    form) against the port on 4 CPU ranks (the plain version): bf16
    outputs within the flash tolerance plus one bf16 ulp (2^-7)."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    P, s, h, hkv, d = 4, 256, 4, 2, 128
    q, k, v = _ring_inputs(gen, P * s, h, hkv, d, dev)
    out = {}
    for where in ("cpu", "cuda:0"):
        dt.init(dt.get_duplicated_devices(P, [where]))
        try:
            before = kernels.launches["flash_update"]
            out[where] = dt.ring_attention(*(x.to(where) for x in (q, k, v)),
                                           causal=causal)
            if where != "cpu":
                torch.cuda.synchronize()
                assert kernels.launches["flash_update"] - before == P * P
                before = kernels.launches["flash_update"]
                qq, kk, vv = (x[:, :, :hkv].contiguous() for x in (q, q, v))
                dt.ring_attention_n(qq, kk, vv, 3, causal=causal)
                torch.cuda.synchronize()
                assert kernels.launches["flash_update"] - before == 3 * P * P
        finally:
            dt.final()
    got, want = out["cuda:0"].float().cpu(), out["cpu"].float()
    assert out["cuda:0"].device.type == "cuda"
    torch.testing.assert_close(got, want, rtol=2e-3 + 2.0 ** -7, atol=2e-3)


def test_wide_heads_take_k9_on_the_ring(cuda):
    """A head dim past the 128 columns staged at a time (d = 768) takes
    the flash ring on the card (P*P K9 launches), within the flash
    tolerance of the port on CPU ranks."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    P, s, h, d = 2, 128, 2, 768
    q, k, v = _ring_inputs(gen, P * s, h, h, d, dev)
    out = {}
    for where in ("cpu", "cuda:0"):
        dt.init(dt.get_duplicated_devices(P, [where]))
        try:
            before = kernels.launches["flash_update"]
            out[where] = dt.ring_attention(*(x.to(where) for x in (q, k, v)),
                                           causal=True)
            if where != "cpu":
                torch.cuda.synchronize()
                assert kernels.launches["flash_update"] - before == P * P
        finally:
            dt.final()
    torch.testing.assert_close(out["cuda:0"].float().cpu(),
                               out["cpu"].float(), rtol=2e-3 + 2.0 ** -7,
                               atol=2e-3)


def test_ring_attention_with_more_than_65535_heads(cuda):
    """B * h = 2048 * 32 = 65536 q heads on one card rank take the flash
    ring (one K9 launch), and rows of the first and last batch elements
    match float64 attention within the reference's flash bound
    (tests/test_ring_attention.py)."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    B, S, h, hkv, d = 2048, 128, 32, 8, 128
    q = torch.randn((B, S, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((B, S, hkv, d), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    dt.init(["cuda:0"])
    try:
        before = kernels.launches["flash_update"]
        out = dt.ring_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert kernels.launches["flash_update"] - before == 1
    finally:
        dt.final()
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    mask = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    for b in (0, B - 1):
        qb = q[b].double().transpose(0, 1)                 # (h, S, d)
        kb, vb = (x[b].double().transpose(0, 1)
                  .repeat_interleave(h // hkv, 0) for x in (k, v))
        logits = (qb @ kb.transpose(1, 2) / d ** 0.5).masked_fill(
            ~mask, float("-inf"))
        want = torch.softmax(logits, -1) @ vb
        torch.testing.assert_close(out[b].double().transpose(0, 1), want,
                                   rtol=5e-2, atol=5e-3)


def test_ring_attention_never_waits_for_the_host(cuda):
    """Under ``set_sync_debug_mode("error")`` the flash ring (both
    schedules, GQA) and the f32 blockwise ring make no synchronizing
    call: offsets are host integers, the state stays on the card."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    dt.init(dt.get_duplicated_devices(4, ["cuda:0"]))
    try:
        q, k, v = _ring_inputs(gen, 4 * 128, 4, 2, 128, dev)
        qf, kf, vf = (x.float() for x in (q, k, v))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            a = dt.ring_attention(q, k, v, causal=True, schedule="serial")
            b = dt.ring_attention(q, k, v, causal=True, schedule="pipelined")
            dt.ring_attention(qf, kf, vf, causal=True, q_chunk=64)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(a, b)
    finally:
        dt.final()


# ------------------------------------------------------------------ K8

def _k8_ids(kind, n, bins, gen, dev):
    if kind == "random":
        return torch.randint(0, bins, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    if kind == "one bin":
        return torch.full((n,), bins // 2, dtype=torch.int32, device=dev)
    # out of range on both sides: those elements count nowhere
    return torch.randint(-3, bins + 3, (n,), generator=gen, device=dev,
                         dtype=torch.int32)


@pytest.mark.parametrize("bins", [1, 1024, 1 << 15])
@pytest.mark.parametrize("kind", ["random", "one bin", "out of range"])
@pytest.mark.parametrize("n", [0, 1000, 1 << 20])
def test_k8_kernel_matches_plain(cuda, bins, kind, n):
    """K8 (K7's kernel with one int32 sum column, counted as ``hist``)
    against ``scatter_add_``, bit for bit."""
    from dr_tpu_torch.ops import hist_pallas
    dev, gen = cuda
    ids = _k8_ids(kind, n, bins, gen, dev)
    cnt = torch.randint(0, 2, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    seg = kernels.launches["segred"]
    got = _launched("hist", lambda: hist_pallas.bincount(ids, cnt, bins))
    assert kernels.launches["segred"] == seg
    assert torch.equal(got, hist_pallas.plain_bincount(ids, cnt, bins))


def test_relational_kernel_routes_on_card(cuda):
    """At the bench's kernel geometry a groupby launches K7 once per
    rank and its sort K6 once (the ranks share the card, so their blocks
    are one batch), and a histogram K8 once per rank; int64 keys (an
    8-byte key column) and a float sum take the torch route; every
    result equals the same op on CPU ranks."""
    import dr_tpu_torch as dt
    rng = np.random.default_rng(3)
    P = 4
    keys = rng.integers(0, 512, P * 8192).astype(np.int32)
    vals = rng.integers(0, 99, P * 8192).astype(np.int32)
    hv = rng.standard_normal(P * 8192).astype(np.float32)

    def run(devs):
        dt.init(devs)
        gk = dt.distributed_vector.from_array(keys)
        ok = dt.distributed_vector(1024, np.int32)
        ov = dt.distributed_vector(1024, np.int32)
        before = dict(kernels.launches)
        ng = dt.groupby_aggregate(gk, dt.distributed_vector.from_array(vals),
                                  ok, ov, agg="sum")
        hb = dt.distributed_vector(256, np.int32)
        dt.histogram(dt.distributed_vector.from_array(hv), hb, -4.0, 4.0)
        counts = {k: kernels.launches[k] - before[k] for k in before}
        lk = dt.distributed_vector.from_array(keys.astype(np.int64))
        o64 = dt.distributed_vector(1024, np.int64)
        of = dt.distributed_vector(1024, np.float32)
        before = dict(kernels.launches)
        ng64 = dt.groupby_aggregate(lk, dt.distributed_vector.from_array(hv),
                                    o64, of, agg="sum")
        torch.cuda.synchronize()
        assert kernels.launches["segred"] == before["segred"]
        return (ng, dt.to_numpy(ok), dt.to_numpy(ov), dt.to_numpy(hb),
                ng64, dt.to_numpy(o64), dt.to_numpy(of)), counts

    got, counts = run(dt.get_duplicated_devices(P, ["cuda:0"]))
    assert counts["segred"] == P and counts["hist"] == P \
        and counts["bitonic_sort"] == 1, counts
    want, _ = run(["cpu"] * P)
    for g, w in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[6], want[6], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the sparse path

def _sparse_inputs(case, m):
    """COO triples of a case at 2^16-scale: config 5's random pattern
    (ELL), a banded matrix (BCSR), or one dense row (csr)."""
    rng = np.random.default_rng(11)
    if case == "banded":
        ii = np.repeat(np.arange(m), 33)
        jj = ii + np.tile(np.arange(-16, 17), m)
        keep = (jj >= 0) & (jj < m)
        rows, cols = ii[keep], jj[keep]
    elif case == "skewed":
        rows = np.concatenate([np.zeros(m, np.int64),
                               np.repeat(np.arange(m), 4)])
        cols = np.concatenate([np.arange(m), rng.integers(0, m, 4 * m)])
    else:
        rows = np.repeat(np.arange(m), 32)
        cols = rng.integers(0, m, 32 * m)
    return rows, cols, rng.standard_normal(len(rows)).astype(np.float32)


def _sparse_oracle(rows, cols, vals, b, m):
    """Float64 scipy product and the row-wise tolerance
    1e-5 * (|A|·|b|)_i + 1e-6 (f32 sums in some order)."""
    import scipy.sparse as sps
    S = sps.csr_matrix((vals.astype(np.float64), (rows, cols)), shape=(m, m))
    b64 = b.astype(np.float64)
    return S @ b64, 1e-5 * (abs(S) @ np.abs(b64)) + 1e-6


@pytest.mark.parametrize("case,fmt", [("random", "ell"), ("random", "csr"),
                                      ("random", "ring"), ("banded", "bcsr"),
                                      ("skewed", "csr"), ("grid", "ell"),
                                      ("grid_banded", "bcsr")])
def test_sparse_formats_on_card(cuda, case, fmt):
    """Every layout at m = 2^16 on 4 ranks of the card against float64
    scipy; the same bits on a second call and on another stream; the
    ring's schedules the same bits; the layouts built on the card equal
    the CPU build bit for bit."""
    import importlib
    import os
    import dr_tpu_torch as dt
    tg = importlib.import_module("dr_tpu_torch.algorithms.gemv")
    m, P = 1 << 16, 4
    base = case.replace("grid_", "").replace("grid", "random")
    rows, cols, vals = _sparse_inputs(base, m)
    b = np.random.default_rng(12).standard_normal(m).astype(np.float32)
    ref, tol = _sparse_oracle(rows, cols, vals, b, m)

    def build(devs):
        dt.init(devs)
        part = dt.block_cyclic(grid=(2, 2)) if "grid" in case else None
        return dt.sparse_matrix.from_coo((m, m), rows, cols, vals,
                                         partition=part)

    A_cpu = build(["cpu"] * P)
    tg.viable_formats(A_cpu)
    A = build(dt.get_duplicated_devices(P, ["cuda:0"]))
    assert tg.viable_formats(A) == tg.viable_formats(A_cpu)
    assert A.format == A_cpu.format
    for name in ("_vals", "_rows", "_cols", "_ell_vals", "_ell_cols",
                 "_bcsr_vals", "_bcsr_cols", "_ring_vals", "_ring_cols"):
        if getattr(A_cpu, name) is not None:
            for x, y in zip(getattr(A, name), getattr(A_cpu, name)):
                assert torch.equal(x.cpu(), y), name
    assert tg._resolve(A, fmt) == fmt
    bd = torch.from_numpy(b).to("cuda:0")

    def run():
        c = dt.distributed_vector(m)
        tg._gemv_as(c, A, bd, fmt)
        return c.to_array()

    got = run()
    assert (np.abs(got.cpu().numpy() - ref) <= tol).all()
    assert torch.equal(run(), got)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = run()
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(again, got)
    if fmt == "ring":
        saved = os.environ.get("DR_GPU_RING_SCHEDULE")
        try:
            os.environ["DR_GPU_RING_SCHEDULE"] = "serial"
            assert torch.equal(run(), got)
        finally:
            if saved is None:
                os.environ.pop("DR_GPU_RING_SCHEDULE", None)
            else:
                os.environ["DR_GPU_RING_SCHEDULE"] = saved
    if fmt in ("ell", "bcsr"):
        B = np.random.default_rng(13).standard_normal((m, 3)).astype(
            np.float32)
        Y = dt.spmm(A, torch.from_numpy(B).to("cuda:0"))
        assert torch.equal(dt.spmm(A, torch.from_numpy(B).to("cuda:0")), Y)
        for j in range(3):
            rj, tj = _sparse_oracle(rows, cols, vals, B[:, j], m)
            assert (np.abs(Y[:, j].cpu().numpy() - rj) <= tj).all()


def test_mismatched_window_scan_launches_k4(cuda):
    """A scan between windows at other offsets (the realign) still takes
    K4 on an f32 add-scan, once a rank that owns window cells."""
    import dr_tpu_torch as dt
    dt.init(dt.get_duplicated_devices(4, ["cuda:0"]))
    n = 1 << 20
    src = np.random.default_rng(14).standard_normal(n).astype(np.float32)
    x = dt.distributed_vector.from_array(src)
    out = dt.distributed_vector(n)
    before = kernels.launches["chunked_cumsum"]
    dt.inclusive_scan(x[0:n - 4], out[4:n])
    torch.cuda.synchronize()
    assert kernels.launches["chunked_cumsum"] == before + 4
    want = np.cumsum(src[:n - 4].astype(np.float64))
    got = dt.to_numpy(out)[4:]
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ------------------------------------------- re-layout, halo, checkpoint

def test_unstructured_halo_reduce_on_card(cuda):
    """Four ranks of the card: exchange equals numpy's gather, and
    ``reduce("plus")`` with duplicate indices equals ``np.add.at`` bit for
    bit (rounds in entry order, no atomics), the same bits twice; the
    other four ops against their numpy forms."""
    import dr_tpu_torch as dt
    dev, _ = cuda
    dt.init(dt.get_duplicated_devices(4, [dev]))
    rng = np.random.default_rng(20)
    n = 1 << 16
    src = rng.standard_normal(n).astype(np.float32)
    gmap = {r: rng.integers(0, n, 1 << 12) for r in range(4)}
    gmap[1][:64] = gmap[1][64:128]  # duplicates inside one rank
    flat = np.concatenate([gmap[r] for r in range(4)])
    contrib = {r: rng.standard_normal(len(ix)).astype(np.float32)
               for r, ix in gmap.items()}
    ghosts = np.concatenate([contrib[r] for r in range(4)])
    ufunc = {"plus": np.add, "multiplies": np.multiply, "max": np.maximum,
             "min": np.minimum}
    for op in ("plus", "plus", "multiplies", "max", "min", "second"):
        v = dt.distributed_vector.from_array(src)
        uh = dt.unstructured_halo(v, gmap)
        uh.exchange()
        for r in range(4):
            got = uh.ghost_values(r)
            assert got.device.type == "cuda"
            assert np.array_equal(got.cpu().numpy(), src[gmap[r]])
            uh.set_ghost_values(r, contrib[r])
        uh.reduce(op)
        want = src.copy()
        if op == "second":
            want[flat] = ghosts
        else:
            ufunc[op].at(want, flat, ghosts)
        assert np.array_equal(dt.to_numpy(v).view(np.int32),
                              want.view(np.int32)), op
    dt.final()


def test_redistribute_routes_agree_on_card(cuda):
    """The collective route's rows equal the host-staged route's, bit for
    bit, after every hop, on four ranks of the card."""
    import dr_tpu_torch as dt
    from dr_tpu_torch.parallel import redistribute as rdx
    dev, _ = cuda
    rt = dt.init(dt.get_duplicated_devices(4, [dev]))
    n = (1 << 16) + 5
    src = np.random.default_rng(21).standard_normal(n).astype(np.float32)
    va = dt.distributed_vector.from_array(src)
    vb = dt.distributed_vector.from_array(src)
    for d in ([n, 0, 0, 0], [100, n - 300, 0, 200], None,
              [0, 0, n, 0], [n // 2, 0, 7, n - n // 2 - 7]):
        rdx._collective(va, d, rt)
        rdx._host_staged(vb, d, rt)
        for a, b in zip(va.rows, vb.rows):
            assert a.device.type == "cuda"
            assert torch.equal(a, b), d
        assert np.array_equal(dt.to_numpy(va), src)
    dt.final()


def test_bf16_checkpoint_roundtrip_on_card(cuda, tmp_path):
    import dr_tpu_torch as dt
    dev, gen = cuda
    dt.init(dt.get_duplicated_devices(4, [dev]))
    t = torch.randn(1 << 16, generator=gen, device=dev).to(torch.bfloat16)
    v = dt.distributed_vector.from_array(t)
    dt.checkpoint.save(str(tmp_path / "bf"), v)
    back = dt.checkpoint.load(str(tmp_path / "bf"))
    assert back.dtype == torch.bfloat16
    assert all(r.device.type == "cuda" for r in back.rows)
    assert torch.equal(back.to_array().view(torch.int16),
                       t.view(torch.int16))
    dt.final()


def _relational_once(dt, data, ranks_dev):
    """groupby, join, histogram and top_k of one seeded table; returns
    every output's bits."""
    k, v = (dt.distributed_vector.from_array(a) for a in data)
    n = len(k)
    ok, ov = dt.distributed_vector(n), dt.distributed_vector(n)
    jk, jl, jr = (dt.distributed_vector(8 * n) for _ in range(3))
    hb = dt.distributed_vector(16, np.int32)
    tv, ti = dt.distributed_vector(8), dt.distributed_vector(8, np.int32)
    ng = dt.groupby_aggregate(k, v, ok, ov, agg="sum")
    m = dt.join(k, v, k, v, jk, jl, jr)
    dt.histogram(v, hb, -3.0, 3.0)
    dt.top_k(v, tv, ti)
    outs = [ok, ov, jk, jl, jr, hb, tv, ti]
    assert all(r.device == ranks_dev for o in outs for r in o.rows)
    return (ng, m), [o.to_array().view(torch.int32) for o in outs]


@pytest.mark.parametrize("ranks", [1, 4])
def test_relational_traced_equals_untraced_on_card(cuda, ranks):
    """The spans change no result: the relational outputs on the card are
    equal bit for bit with tracing off and armed, and the trace holds
    the four spans."""
    import dr_tpu_torch as dt
    dev, gen = cuda
    dt.init(dt.get_duplicated_devices(ranks, [dev]))
    n = 1 << 14
    data = (torch.randint(0, n, (n,), generator=gen,
                          device=dev).float(),
            torch.randn(n, generator=gen, device=dev))
    off = _relational_once(dt, data, dev)
    dt.obs.arm(True)
    dt.obs.reset()
    try:
        on = _relational_once(dt, data, dev)
        names = {e["name"] for e in dt.obs.events()}
    finally:
        dt.obs.arm(False)
        dt.obs.reset()
    assert on[0] == off[0]
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))
    assert {"relational.join", "relational.groupby", "relational.histogram",
            "relational.top_k", "relational.phase"} <= names
    dt.final()


def test_profiling_trace_records_k3_on_card(cuda, tmp_path):
    """``profiling.trace`` on the card records device activity: the K3
    kernel of ``dot_n`` (``dot.cu``'s ``dot_partials*``), once a round."""
    import json
    import dr_tpu_torch as dt
    dev, gen = cuda
    dt.init([dev])
    x = dt.distributed_vector.from_array(
        torch.rand(1 << 20, generator=gen, device=dev))
    float(dt.dot_n(x, x, 1))  # warm
    before = kernels.launches["chunked_dot"]
    with dt.profiling.trace(str(tmp_path)):
        float(dt.dot_n(x, x, 3))
    assert kernels.launches["chunked_dot"] - before == 3
    (path,) = tmp_path.glob("*.pt.trace.json")
    with open(path, encoding="utf-8") as fh:
        evs = json.load(fh)["traceEvents"]
    k3 = [e for e in evs if e.get("cat") == "kernel"
          and "dot_partials" in e.get("name", "")]
    assert len(k3) == 3
    dt.final()


# ------------------------------------------- resilience and guards

@pytest.mark.parametrize("kind", ["transient", "program"])
def test_kernel_build_fault_raises_on_card(cuda, kind):
    """An injected ``kernel.build`` fault raises its classified error out
    of a CUDA-tensor wrapper: the launch counter does not move and the
    plain version does not run in its place; unfaulted, the same call
    gives the kernel's bits."""
    from dr_tpu_torch.utils import faults, resilience
    dev, gen = cuda
    x = torch.randn(1 << 20, generator=gen, device=dev)
    clean = scan_pallas.chunked_cumsum(x)
    ran = []
    plain = scan_pallas.plain_cumsum
    scan_pallas.plain_cumsum = lambda *a, **k: ran.append(1)
    before = dict(kernels.launches)
    try:
        with faults.injected("kernel.build", kind) as sp:
            with pytest.raises(resilience.ResilienceError) as ei:
                scan_pallas.chunked_cumsum(x)
    finally:
        scan_pallas.plain_cumsum = plain
    assert sp.fired == 1 and ei.value.site == "kernel.build"
    assert isinstance(ei.value, {"transient": resilience.
                                 TransientBackendError,
                                 "program": resilience.ProgramError}[kind])
    assert kernels.launches == before and not ran
    assert torch.equal(scan_pallas.chunked_cumsum(x), clean)


def test_halo_transient_retried_same_bits_on_card(cuda):
    """A transient at ``halo.exchange`` on 4 ranks of the card, retried:
    the ghosts have the bits of the run without the fault."""
    import dr_tpu_torch as dt
    from dr_tpu_torch.utils import faults, resilience
    dev, gen = cuda
    dt.init(dt.get_duplicated_devices(4, [dev]))
    src = torch.randn(1 << 20, generator=gen, device=dev)
    hb = dt.halo_bounds(1024, 1024, periodic=True)
    clean = dt.distributed_vector.from_array(src, halo=hb)
    clean.halo().exchange()
    v = dt.distributed_vector.from_array(src, halo=hb)
    with faults.injected("halo.exchange", "transient") as sp:
        resilience.retry(lambda: v.halo().exchange(), attempts=2,
                         sleep=lambda s: None)
    assert sp.fired == 1
    assert all(torch.equal(a, b) for a, b in zip(v.rows, clean.rows))
    dt.final()


def test_real_oom_classifies_as_device_oom(cuda):
    """An allocation above the card's memory (so above what is free,
    whatever the caching allocator holds) comes back from ``classified``
    as ``DeviceOOM`` (never retried by ``retry``)."""
    from dr_tpu_torch.utils import resilience
    dev, _ = cuda
    _free, total = torch.cuda.mem_get_info(dev)
    calls = []

    def alloc():
        calls.append(1)
        return torch.empty(total + (1 << 30), dtype=torch.uint8, device=dev)

    with pytest.raises(resilience.DeviceOOM):
        resilience.retry(alloc, attempts=3, sleep=lambda s: None)
    assert calls == [1]
    torch.cuda.empty_cache()


# ---------------------------------------------------------- deferred plans

def _pl_scale(x, c):
    return x * c


def _pl_shift(x, c):
    return x + c


@pytest.fixture
def dtc(cuda):
    """``dr_tpu_torch`` on 4 ranks of the card (every row on cuda:0, so
    a flushed run is captured into a CUDA graph)."""
    import dr_tpu_torch as dt
    dt.init(dt.get_duplicated_devices(4, ["cuda:0"]))
    yield dt
    dt.plan._plan_cache.clear()
    dt.final()


def _small(dt, a, b, s=0.5):
    dt.for_each(a, _pl_scale, 1.5)
    dt.halo(a).exchange()
    dt.transform(a, b, _pl_shift, s)
    return dt.reduce(b)


def _pair_vectors(dt, gen, n, halo=1, count=2):
    src = torch.randn(n, generator=gen, device="cuda")
    hb = dt.halo_bounds(halo, halo, periodic=True)
    return [dt.distributed_vector.from_array(src, halo=hb)
            for _ in range(count)]


def _rows_equal(u, v):
    return all(torch.equal(x, y) for x, y in zip(u.rows, v.rows))


def test_plan_graph_replay_matches_eager_across_calls_and_streams(dtc, cuda):
    dt, (_, gen) = dtc, cuda
    ea, da = _pair_vectors(dt, gen, 1 << 16)
    eb, db = _pair_vectors(dt, gen, 1 << 16)
    plan = dt.plan.Plan()
    side = torch.cuda.Stream()
    for k in range(5):
        want = float(_small(dt, ea, eb))
        if k == 4:  # the last replay on a side stream
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                with plan.record():
                    got = _small(dt, da, db)
                val = float(got)
            torch.cuda.current_stream().wait_stream(side)
        else:
            with plan.record():
                got = _small(dt, da, db)
            val = float(got)
        torch.cuda.synchronize()
        assert val == want, k
        assert _rows_equal(da, ea) and _rows_equal(db, eb), k
    st = plan.stats()
    assert st["eager_runs"] == 1 and st["graph_captures"] == 1
    assert st["graph_replays"] == 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plan_new_scalars_give_the_eager_bits(dtc, dtype):
    dt = dtc
    v = dt.distributed_vector(1 << 16, dtype)
    w = dt.distributed_vector(1 << 16, dtype)
    plan = dt.plan.Plan()
    for fv, cv in ((1.1, 3.3), (1.1, 3.3), (1.1, 3.3), (2.2, 0.7),
                   (2.2, 0.7)):
        with plan.record():
            dt.fill(v, fv)
            dt.for_each(v, _pl_scale, cv)
        dt.fill(w, fv)
        dt.for_each(w, _pl_scale, cv)
        assert _rows_equal(v, w), (fv, cv)
    st = plan.stats()
    # new values run in order once, then capture: never a stale replay
    assert st["graph_replays"] == 3 and st["graph_captures"] == 2


def _k1_k4_region(dt, x, a, res):
    dt.iota(x, 0)
    dt.for_each(x, _pl_scale, 2.0 ** -12)
    dt.inclusive_scan(x, res)
    dt.transform(x, a, _pl_shift, -0.5)
    dt.halo(a).exchange()
    dt.stencil_iterate_matmul(a, W5, 64, k_block=64)
    return dt.dot(a, a)


def test_plan_region_with_k1_and_k4_gives_the_eager_bits(cuda):
    import dr_tpu_torch as dt
    dt.init(["cuda:0"])
    try:
        hb = dt.halo_bounds(512, 512, periodic=True)
        x, a, res = (dt.distributed_vector(1 << 16, torch.float32, halo=hb)
                     for _ in range(3))
        kernels.reset_counts()
        want = _k1_k4_region(dt, x, a, res)
        rows = [[r.clone() for r in v.rows] for v in (x, a, res)]
        want_counts = dict(kernels.launches)
        assert want_counts["stencil_matmul"] == 1
        assert want_counts["chunked_cumsum"] == 1
        plan = dt.plan.Plan()
        for _ in range(2):
            kernels.reset_counts()
            with plan.record():
                got = _k1_k4_region(dt, x, a, res)
            assert float(got) == want
            assert dict(kernels.launches) == want_counts
            for v, w in zip((x, a, res), rows):
                assert all(torch.equal(g, e) for g, e in zip(v.rows, w))
        st = plan.stats()
        # the run over x alone replays; K1 and K4 replace the rows of a
        # and res, so the runs over a run in order at every flush
        assert st["opaque_ops"] == 4 and st["fused_runs"] == 6
        assert st["graph_replays"] == 1 and st["graph_captures"] == 1
    finally:
        dt.plan._plan_cache.clear()
        dt.final()


def test_plan_graph_never_replays_into_another_container(dtc, cuda):
    """A graph bakes in its rows' addresses: a flush over another
    container of the same layout captures anew and leaves the first
    container as it was."""
    dt, (_, gen) = dtc, cuda
    a1, a2, e1, e2 = _pair_vectors(dt, gen, 1 << 16, count=4)
    b1, b2, f1, f2 = _pair_vectors(dt, gen, 1 << 16, count=4)
    plan = dt.plan.Plan()
    for _ in range(2):
        with plan.record():
            _small(dt, a1, b1)
        _small(dt, e1, f1)
    keep = [[r.clone() for r in v.rows] for v in (a1, b1)]
    with plan.record():
        s = _small(dt, a2, b2)
    want = float(_small(dt, e2, f2))
    torch.cuda.synchronize()
    for v, w in zip((a1, b1), keep):
        assert all(torch.equal(g, e) for g, e in zip(v.rows, w))
    assert _rows_equal(a1, e1) and _rows_equal(b1, f1)
    assert _rows_equal(a2, e2) and _rows_equal(b2, f2)
    assert float(s) == want
    st = plan.stats()
    # a2/b2's first flush runs in order: its rows are not the graph's
    assert st["graph_captures"] == 1 and st["graph_replays"] == 1
    assert st["eager_runs"] == 2


def _k7_k8_region(dt, v, h, t, i):
    dt.histogram(v, h, -3.0, 3.0)
    dt.top_k(v, t, i)
    return dt.reduce(v, op=min)


def test_plan_graph_replays_k7_k8_and_counts_their_launches(dtc, cuda):
    """A run with a histogram (K8), a top_k and a min reduce (K7) is
    captured and replayed with the eager bits, and each replay adds the
    launches its capture recorded."""
    dt, (_, gen) = dtc, cuda
    v = dt.distributed_vector.from_array(
        torch.randn(1 << 16, generator=gen, device="cuda"))
    outs = [(dt.distributed_vector(64, torch.int32),
             dt.distributed_vector(8, torch.float32),
             dt.distributed_vector(8, torch.int32)) for _ in range(2)]
    kernels.reset_counts()
    want = float(_k7_k8_region(dt, v, *outs[0]))
    want_counts = dict(kernels.launches)
    assert want_counts["hist"] == 4 and want_counts["segred"] == 4
    plan = dt.plan.Plan()
    for _ in range(3):
        kernels.reset_counts()
        with plan.record():
            got = _k7_k8_region(dt, v, *outs[1])
        assert float(got) == want
        assert dict(kernels.launches) == want_counts
        for x, y in zip(*outs):
            assert _rows_equal(x, y)
    st = plan.stats()
    assert st["graph_captures"] == 1 and st["graph_replays"] == 2


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def test_elastic_shrink_and_grow_on_card(dtc, cuda, tmp_path):
    """A shrink of rank 3 and the grow back on CUDA ranks: a team vector
    rescued and a checkpointed one restored bit for bit, both on the
    card through both moves; the uncheckpointed one lost and staying
    lost."""
    from dr_tpu_torch.utils import elastic, resilience
    dt, (_, gen) = dtc, cuda
    n = 1 << 16
    team_src = torch.randn(n, generator=gen, device="cuda")
    ck_src = torch.randn(n, generator=gen, device="cuda")
    team = dt.distributed_vector.from_array(team_src,
                                            distribution=[n, 0, 0, 0])
    ck = dt.distributed_vector.from_array(ck_src)
    dt.checkpoint.save(str(tmp_path / "ck.npz"), ck)
    gone = dt.distributed_vector.from_array(ck_src)
    try:
        rep = elastic.rescue_session(resilience.DeviceLostError("loss",
                                                                rank=3))
        assert (rep.rescued, rep.restored, rep.lost) == (1, 1, 1)
        for v, want in ((team, team_src), (ck, ck_src)):
            assert [r.device.type for r in v.rows] == ["cuda"] * 3
            assert _bits_equal(v.to_array(), want)
        with pytest.raises(resilience.DeviceLostError):
            dt.to_numpy(gone)
        grow = elastic.grow_session()
        assert (grow.moved, grow.kept) == (2, 0) and dt.nprocs() == 4
        for v, want in ((team, team_src), (ck, ck_src)):
            assert [r.device.type for r in v.rows] == ["cuda"] * 4
            assert _bits_equal(v.to_array(), want)
        assert elastic.is_lost(gone)
    finally:
        elastic.reset()


def test_elastic_shrink_releases_the_graph_pool(dtc, cuda):
    """A graph a deferred run captured on the 4-rank runtime goes with
    the shrink, and its private memory pool with it."""
    import gc
    import weakref
    from dr_tpu_torch.core.pinning import pinned_id
    from dr_tpu_torch.utils import elastic
    dt = dtc
    pid = pinned_id(dt.runtime())
    w = dt.distributed_vector(1 << 20)
    for _ in range(2):
        with dt.deferred():
            dt.for_each(w, _pl_scale, 2.0)
    ents = [e for k, e in dt.plan._plan_cache.items()
            if k[1] == pid and e.graph is not None]
    assert ents
    refs = [weakref.ref(e.graph) for e in ents]
    pools = {tuple(e.graph.pool()) for e in ents}
    del ents, w
    try:
        elastic.rescue_session(lost_ranks=[3])
        gc.collect()
        torch.cuda.empty_cache()
        assert all(r() is None for r in refs)
        segs = torch.cuda.memory_snapshot()
        assert not [s for s in segs
                    if tuple(s.get("segment_pool_id", ())) in pools]
    finally:
        elastic.reset()


# ------------------------------------------------------- the serving daemon

@pytest.fixture
def served(cuda, tmp_path):
    """A port daemon on 4 ranks of the card, in process, and a client."""
    import dr_tpu_torch as dt
    from dr_tpu_torch import serve
    dt.init(dt.get_duplicated_devices(4, ["cuda:0"]))
    srv = serve.Server(str(tmp_path / "g.sock"), batch_window=0.0).start()
    c = serve.Client(srv.path, timeout=120.0)
    try:
        yield dt, srv, c
    finally:
        c.close()
        srv.stop()
        serve.reset()
        dt.plan._plan_cache.clear()
        dt.final()


def test_serve_claims_cuda_ranks_by_default(cuda, tmp_path):
    import dr_tpu_torch as dt
    from dr_tpu_torch import serve
    dt.final()
    srv = serve.Server(str(tmp_path / "d.sock")).start()
    try:
        assert all(d.type == "cuda" for d in dt.devices())
        assert dt.nprocs() == torch.cuda.device_count()
        with serve.Client(srv.path, timeout=120.0) as c:
            assert c.route() == {"requested": "device",
                                 "current": "device"}
            x = np.arange(1 << 12, dtype=np.float32)
            np.testing.assert_array_equal(c.scale(x, a=2.0), x * 2.0)
    finally:
        srv.stop()
        serve.reset()
        dt.final()


def test_serve_dot_and_scan_launch_k3_k4_with_the_direct_bits(served):
    """A served dot and scan over residents launch K3 and K4 (as many as
    the direct calls on the same containers), and reply with the direct
    calls' bits."""
    from dr_tpu_torch import serve
    dt, srv, c = served
    rng = np.random.default_rng(5)
    x = rng.standard_normal(1 << 20).astype(np.float32)
    y = rng.standard_normal(1 << 20).astype(np.float32)
    c.put("x", x)
    c.put("y", y)
    cx = srv._resident.get("default", "x").cont
    cy = srv._resident.get("default", "y").cont
    kernels.reset_counts()
    want_dot = float(dt.dot(cx, cy))
    out = dt.distributed_vector(len(cx), np.float32)
    dt.inclusive_scan(cx, out)
    want_scan = dt.to_numpy(out)
    direct = dict(kernels.launches)
    assert direct["chunked_dot"] == 4 and direct["chunked_cumsum"] > 0
    kernels.reset_counts()
    got_dot = c.dot(serve.Ref("x"), serve.Ref("y"))
    got_scan = c.scan(serve.Ref("x"))
    served_counts = dict(kernels.launches)
    assert got_dot == want_dot
    np.testing.assert_array_equal(got_scan.view(np.int32),
                                  want_scan.view(np.int32))
    for k in ("chunked_dot", "chunked_cumsum"):
        assert served_counts[k] == direct[k], (k, served_counts, direct)


def test_serve_resident_group_replays_its_graph(served):
    """The same fused group over residents, sent three times: the second
    flush captures its run, the third replays it, every reply with the
    first one's bits."""
    from dr_tpu_torch import serve
    dt, srv, c = served
    rng = np.random.default_rng(6)
    x = rng.standard_normal(1 << 18).astype(np.float32)
    c.put("x", x)
    got = []
    for _ in range(3):
        got.append((c.reduce(serve.Ref("x")),
                    c.dot(serve.Ref("x"), serve.Ref("x"))))
    assert got[0] == got[1] == got[2]
    st = c.stats()["plan"]
    assert st["graph_captures"] >= 1 and st["graph_replays"] >= 1, st


def test_router_in_process_replicas_share_ranks_with_captures(cuda,
                                                             tmp_path):
    """Two in-process replicas of one runtime on the card, a tenant on
    each sending the same resident group again and again from its own
    thread: each replica's plan captures and replays its graph while the
    other serves, every reply has the direct calls' bits, and the
    launches are as many as the direct calls imply (none lost to, or
    counted under, the other replica's capture).  A fleet on the CPU
    route is refused next to this runtime."""
    import threading
    import dr_tpu_torch as dt
    from dr_tpu_torch import serve
    from dr_tpu_torch.utils import resilience
    dt.init(dt.get_duplicated_devices(4, ["cuda:0"]))
    fleet = serve.Router(str(tmp_path / "g"), replicas=2,
                         batch_window=0.0).start()
    rcs = {}
    try:
        ring = serve.HashRing(fleet.paths())
        names = [f"t{i}" for i in range(64)]
        tenants = [next(n for n in names if ring.lookup(n) == p)
                   for p in fleet.paths()]
        # two layouts: one plan key (and one graph) a replica
        rng = np.random.default_rng(8)
        xs = {t: rng.standard_normal(n).astype(np.float32)
              for t, n in zip(tenants, (1 << 18, 3 << 17))}
        servers = {s.path: s for s in fleet._servers}
        want, per = {}, {}
        for t, x in xs.items():
            rcs[t] = serve.RouterClient(fleet.paths(), tenant=t,
                                        timeout=120.0)
            rcs[t].put("x", x)
            cx = servers[rcs[t].route()]._resident.get(t, "x").cont
            kernels.reset_counts()
            want[t] = (float(dt.reduce(cx)), float(dt.dot(cx, cx)))
            torch.cuda.synchronize()
            per[t] = dict(kernels.launches)
        rounds = 12
        got, errs = {t: [] for t in xs}, []

        def client(t):
            ref = serve.Ref("x")
            try:
                for _ in range(rounds):
                    got[t].append((rcs[t].reduce(ref), rcs[t].dot(ref, ref)))
            except Exception as e:  # reported by the assertion below
                errs.append(repr(e))

        kernels.reset_counts()
        threads = [threading.Thread(target=client, args=(t,)) for t in xs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300.0)
        torch.cuda.synchronize()
        launched = dict(kernels.launches)
        assert not errs, errs[:3]
        for t in xs:
            assert got[t] == [want[t]] * rounds, t
        for k, n in launched.items():
            assert n == rounds * sum(per[t][k] for t in xs), (k, launched)
        assert launched["chunked_dot"] > 0
        for s in fleet._servers:
            st = s.stats()["plan"]
            assert st["graph_captures"] >= 1 and st["graph_replays"] >= 1, st
        with pytest.raises(resilience.ProgramError) as ei:
            serve.Router(str(tmp_path / "c"), replicas=2, cpu=True).start()
        assert ei.value.site == "router.route"
    finally:
        for rc in rcs.values():
            rc.close()
        fleet.stop()
        serve.reset()
        dt.plan._plan_cache.clear()
        dt.final()


def test_bridge_demo_on_the_card_launches_k3_k4_k6_k7(cuda):
    """The C++ bridge on ``thp::session(0)``: ``bridge_demo`` takes the
    visible CUDA devices, passes, and its process launches K3, K4, K6
    and K7 (its sorts are 2^14 keys a rank, its reduce an int32 sum)."""
    import json
    import subprocess
    from dr_tpu_torch import native
    exe = native.build(native.HERE / "bridge_demo.cpp")
    out = subprocess.run([str(exe), "0"], env=native.env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert f"nprocs={torch.cuda.device_count()}" in out.stdout
    assert "bridge demo PASSED" in out.stdout
    line = [x for x in out.stdout.splitlines() if x.startswith("launches ")]
    counts = json.loads(line[0][len("launches "):])
    for k in ("chunked_dot", "chunked_cumsum", "bitonic_sort", "segred"):
        assert counts[k] > 0, (k, counts)


def test_bridge_mp_demo_two_processes_on_one_card(cuda):
    """The C++ bridge across processes: two ``bridge_mp_demo`` processes,
    each owning one rank on cuda:0 over gloo
    (``thp::session(const distributed&)``), pass, and each launches its
    rank's share of the same calls made directly on two ranks of the
    card: K3 from ``dot``, K6 from the sorts, K7 from the int32
    ``reduce`` (``bridge_mp_phase`` raises otherwise)."""
    import importlib.util
    import dr_tpu_torch as dt
    from pathlib import Path
    script = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", script)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    try:
        got = cs.bridge_mp_phase(dt, kernels, 5, "test", device="cuda:0",
                                 parity=False)
    finally:
        dt.final()
    single = got["demo_launches"]
    for k in ("chunked_dot", "bitonic_sort", "segred"):
        assert single[k] > 0, single


def test_float_to_integer_writes_same_bits_on_cpu_and_cuda_ranks(cuda):
    """A float written into an integer container converts as XLA's
    convert does on both kinds of rank: the CPU's and the card's
    conversions give the same bits (copy, transform and iota)."""
    import dr_tpu_torch as dt
    vals = np.array([-1.5, -0.2, 255.5, 256.0, 1e10, np.nan, -1e10, 3.7,
                     -3.7, 2.0 ** 31, -(2.0 ** 31) - 512], np.float32)
    try:
        for into in ("uint8", "int8", "int32", "int16"):
            got = {}
            for dev in ("cpu", "cuda:0"):
                dt.init([dev] * 2)
                src = dt.distributed_vector.from_array(vals)
                b = dt.distributed_vector(len(vals), dtype=into)
                dt.copy(src, b)
                c = dt.distributed_vector(len(vals), dtype=into)
                dt.transform(src, c, lambda x: x * 3)
                d = dt.distributed_vector(len(vals), dtype=into)
                dt.iota(d, -1e4 + 0.5)
                got[dev] = [dt.to_numpy(v) for v in (b, c, d)]
            for cpu, card in zip(got["cpu"], got["cuda:0"]):
                assert np.array_equal(cpu, card), (into, cpu, card)
    finally:
        dt.final()


def test_two_processes_on_one_card_over_gloo(cuda, tmp_path):
    """Two processes, each owning one rank on cuda:0 (gloo between
    them), run the multi-process main path at a small size: every
    result of each has the bits of one controller on two ranks of the
    card, and the serving daemon and the router refuse (one process
    serves)."""
    import test_torch_multiprocess as mp
    got = mp._spawn(2, str(tmp_path / "res"), device="cuda:0",
                    deadline_s=300.0)
    single = mp._single_controller(2, str(tmp_path), device="cuda:0")
    for pid, res in enumerate(got):
        for key, want in single.items():
            assert mp.same_bits(res[key], want), (pid, key, res[key], want)
        assert len(res["refused"]) == 2, res["refused"]


def test_two_processes_on_one_card_launch_k5_k6_k7_k9(cuda, tmp_path):
    """Two processes, each owning one rank on cuda:0 (gloo between
    them), run ``chip_smoke.py``'s phase 29 at its CPU-rehearsal sizes:
    the K6-geometry sort and sort_by_key, K7's min and max, a one-tile
    K5 pass and the flash ring, among the rest of the slice.  Every
    digest of each process equals one controller's on two ranks of the
    card, and each process launches K5, K6, K7 and K9 as often as its
    rank's share (``mp29_phase`` raises otherwise)."""
    import importlib.util
    import dr_tpu_torch as dt
    from pathlib import Path
    script = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", script)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    try:
        got = cs.mp29_phase(dt, kernels, 5, "test", device="cuda:0",
                            small=True, out_dir=str(tmp_path))
    finally:
        dt.final()
    single = got["single_launches"]
    assert all(single[k] > 0 for k in cs.MP29_KERNELS), single
    assert got["p0_launches"]["stencil2d_blocked"] == \
        single["stencil2d_blocked"]
    assert got["p1_launches"]["stencil2d_blocked"] == 0


def test_two_processes_on_one_card_deferred_region(cuda, tmp_path):
    """Two processes, each owning one rank on cuda:0 (gloo between
    them), run ``chip_smoke.py``'s phase 31 at its CPU-rehearsal sizes:
    the deferred region with K1, K2 and K4 opaque, K3 and K8 fused and
    ``dot_n`` (K3) after the flush, the joins under the tuning DB and
    the killed-worker leg.  Every digest of each process equals one
    controller's on two ranks of the card, each launches its rank's
    share of K1-K4 and K8, their ``Plan.stats()`` agree, and the
    survivor's K3 / K4 digests equal one controller's
    (``mp31_phase`` raises otherwise)."""
    import importlib.util
    import dr_tpu_torch as dt
    from pathlib import Path
    script = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", script)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    try:
        got = cs.mp31_phase(dt, kernels, 5, "test", device="cuda:0",
                            small=True, out_dir=str(tmp_path))
    finally:
        dt.final()
    single = got["single_launches"]
    for k in ("stencil_matmul", "stencil_blocked", "chunked_dot",
              "chunked_cumsum", "hist"):
        assert single[k] > 0 and got["p0_region_s"] > 0, single
    assert got["p0_stats"] == got["p1_stats"]
    assert got["kill_launches"]["chunked_dot"] > 0


def test_two_processes_on_one_card_launch_k6_k7_k8(cuda, tmp_path):
    """Two processes, each owning one rank on cuda:0 (gloo between
    them), run ``chip_smoke.py``'s phase 30 kernel geometry (8192 int32
    keys a rank: a groupby sum and a 256-bin histogram): every digest
    of each process equals one controller's on two ranks of the card,
    and each process launches K6 once (its rank's block), K7 once and
    K8 once (``mp30_phase`` raises otherwise)."""
    import importlib.util
    import dr_tpu_torch as dt
    from pathlib import Path
    script = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", script)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    try:
        got = cs.mp30_phase(dt, kernels, 5, "test", device="cuda:0",
                            small=True, parts=("geometry",),
                            out_dir=str(tmp_path))
    finally:
        dt.final()
    assert got["single_launches"] == {"bitonic_sort": 1, "segred": 2,
                                      "hist": 2}, got["single_launches"]
    for pid in (0, 1):
        assert got[f"p{pid}_launches"] == {"bitonic_sort": 1, "segred": 1,
                                           "hist": 1}, got
