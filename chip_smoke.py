#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dr_tpu_torch``) on one NVIDIA card.

Run from the repository root:  ``python3 chip_smoke.py``  (``--quick``
checks the kernels at small shapes only).  Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the four CUDA kernels from ``dr_tpu_torch/csrc`` (``nvcc``);
3. hold each kernel against its plain PyTorch version at the main-path
   shapes, on the card;
4. the main path at full size on one rank: a 2^30-element f32
   ``distributed_vector``, 512 steps of ``stencil_iterate_matmul``
   (k_block=256, halo 512) and of ``stencil_iterate_blocked``
   (time_block=64, halo 1024), ``dot_n``, ``inclusive_scan`` and
   ``inclusive_scan_n``; launch counts are read around this phase, and
   every result is compared with the same path run on the plain
   versions;
5. the same path on 4 logical ranks of the one card at n = 2^26 (ring
   exchanges and the scan's cross-rank carry), against a numpy oracle;
6. per-kernel times from CUDA events beside their bounds, the plain
   versions' and one library call's times, and the peak device memory.

Exits non-zero on any failure.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the kernel
table as one JSON object.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# dense float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

W5 = (0.05, 0.25, 0.4, 0.25, 0.05)  # the bench's 5-point stencil
K_BLOCK, MM_HALO = 256, 512
T_BLOCK, BLK_HALO = 64, 1024
STEPS = 512
DOT_ROUNDS = 8


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, flops):
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


@contextlib.contextmanager
def plain_versions(kernels):
    """Route the wrappers to their plain PyTorch versions on the card
    (the reference run of the main path; nothing in the port does this)."""
    saved = kernels.on_cuda
    kernels.on_cuda = lambda *t: False
    try:
        yield
    finally:
        kernels.on_cuda = saved


def check(name, err, tol):
    ok = bool(np.isfinite(err)) and err <= tol
    log(f"  {name}: max_abs_err={err!r} tol={tol!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


def max_err(a, b, chunk=1 << 26):
    """Largest |a - b| in float64, taken in chunks to bound memory."""
    a, b = a.reshape(-1), b.reshape(-1)
    return max(float((a[i:i + chunk].double() - b[i:i + chunk].double())
                     .abs().max()) for i in range(0, a.numel(), chunk))


def f32_ulp(v):
    """The spacing of f32 values at magnitude |v|."""
    return 2.0 ** (math.frexp(abs(v))[1] - 24)


def step_err(out, x, start, chunk=1 << 26):
    """Largest |(out[i] - out[i-1]) - x[i]| in float64, with out[-1] taken
    as ``start``: every prefix of an add-scan adds exactly its own
    element, so a dropped or doubled element at a block or rank boundary
    shows here at its own size."""
    import torch
    out, x = out.reshape(-1), x.reshape(-1)
    prev = torch.tensor([float(start)], dtype=torch.float64,
                        device=out.device)
    worst = 0.0
    for i in range(0, out.numel(), chunk):
        o = out[i:i + chunk].double()
        d = o - torch.cat([prev, o[:-1]])
        worst = max(worst, float((d - x[i:i + chunk].double()).abs().max()))
        prev = o[-1:]
    return worst


def f64_dot(x, y, salt, chunk=1 << 26):
    """sum(x * (y + salt)) in float64, in chunks."""
    return sum(float((x[i:i + chunk].double() * (y[i:i + chunk].double()
                                                 + salt)).sum())
               for i in range(0, x.numel(), chunk))


def kernel_checks(dt, n, gen, results):
    """Phase 3: every kernel against its plain version, same inputs."""
    import torch
    from dr_tpu_torch.ops import (reduce_pallas, scan_pallas,
                                  stencil_matmul, stencil_pallas)
    dev = torch.device("cuda", 0)

    # K1 at the main path's row: tolerance — the kernel sums 1025 taps
    # in f32 FMA order, the plain version goes through an f32 matmul;
    # both are weighted averages of O(1) data, so 1e-5 absolute covers
    # the two rounding orders
    row = torch.randn((1, n + 2 * MM_HALO), generator=gen, device=dev)
    got = stencil_matmul.matmul_stencil_row(row, n, MM_HALO, W5, K_BLOCK)
    ref = stencil_matmul.plain_apply(row, n, MM_HALO, W5, K_BLOCK)
    torch.cuda.synchronize()
    results["stencil_matmul"]["max_abs_err"] = e = max_err(got, ref)
    check("K1 stencil_matmul", e, 1e-5)
    del got, ref, row

    # K2: same separately rounded products and sums as the plain
    # version, so it should agree to the bit; 1e-6 leaves room only for
    # a differently rounded weight
    row = torch.randn((1, n + 2 * BLK_HALO), generator=gen, device=dev)
    got = stencil_pallas.blocked_stencil_row(row, n, BLK_HALO, W5, T_BLOCK)
    ref = stencil_pallas.plain_blocked(row, n, BLK_HALO, W5, T_BLOCK)
    torch.cuda.synchronize()
    results["stencil_blocked"]["max_abs_err"] = e = max_err(got, ref)
    check("K2 stencil_blocked", e, 1e-6)
    del got, ref, row

    # K3: positive data, so the sum has no cancellation.  Two f32
    # reductions of these terms in different orders differ by ~1 absolute
    # at 2^30 (earlier runs measured 0), far below one f32 ulp of the
    # result (32 at ~3.4e8): tolerance 4 ulps of the result against the
    # plain version.  Against a float64 sum the f32 tree's top levels add
    # a few tens more: tolerance 8 ulps.  A lost run of ~1000 elements
    # (~0.3 each) exceeds either.
    x = torch.rand(n, generator=gen, device=dev)
    y = torch.rand(n, generator=gen, device=dev)
    salt = torch.tensor(0.125, device=dev)
    got = reduce_pallas.chunked_dot(x, y, salt=salt)
    ref = reduce_pallas.plain_dot(x, y, salt)
    results["chunked_dot"]["max_abs_err"] = e = max_err(got, ref)
    check("K3 chunked_dot", e, 4 * f32_ulp(float(ref)))
    check("K3 chunked_dot vs float64", abs(float(got) - f64_dot(x, y, 0.125)),
          8 * f32_ulp(float(ref)))
    for dtp in (torch.bfloat16, torch.float16):
        xs, ys = x[:1 << 24].to(dtp), y[:1 << 24].to(dtp)
        g2 = reduce_pallas.chunked_dot(xs, ys, salt=salt)
        r2 = reduce_pallas.plain_dot(xs, ys, salt)
        check(f"K3 chunked_dot {dtp}", max_err(g2, r2),
              4 * f32_ulp(float(r2)))
    del x, y

    # K4: prefixes of N(0,1) data reach ~|3e4|; f32 prefix sums taken
    # in two orders drift by ~1e-6 of the running magnitude per level,
    # tolerance 1e-4 of the largest prefix
    x = torch.randn(n, generator=gen, device=dev)
    carry = torch.tensor(3.5, device=dev)
    got = scan_pallas.chunked_cumsum(x, carry=carry)
    ref = scan_pallas.plain_cumsum(x, carry)
    results["chunked_cumsum"]["max_abs_err"] = e = max_err(got, ref)
    top = float(ref.abs().max())
    check("K4 chunked_cumsum", e, 1e-4 * top)
    # each output adds exactly its element: the roundings of the offsets
    # and outputs at a block boundary sum to at most ~4 ulps of the
    # largest prefix; tolerance 8 ulps (~0.03 at 5.8e4), where a dropped
    # or doubled N(0,1) element is ~0.8
    check("K4 chunked_cumsum steps", step_err(got, x, 3.5),
          8 * f32_ulp(top))
    xb = x[:1 << 24].to(torch.bfloat16)
    g2 = scan_pallas.chunked_cumsum(xb, carry=carry)
    r2 = scan_pallas.plain_cumsum(xb, carry)
    # bf16 output rounds each f32 prefix to 8 significant bits: two f32
    # prefixes a hair apart may round to neighbouring bf16 values, so
    # allow two bf16 ulps (2^-6) of the largest prefix
    check("K4 chunked_cumsum bf16", max_err(g2, r2),
          2 ** -6 * float(r2.float().abs().max()))
    del x, got, ref


def main_path(dt, n, seed, times=None, keep_inputs=False):
    """The main path on the current runtime; returns the source vector
    and every result, moved to the host as it is made.  ``times`` (a
    dict) gets each step's host-clock seconds, each ended by a fence.
    ``keep_inputs`` also returns the dot operands (as "x" and "y")."""
    import torch
    times = {} if times is None else times
    dev = dt.devices()[0]
    gen = torch.Generator(device=dev).manual_seed(seed)

    @contextlib.contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        dt.fence()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0

    out = {}
    with step("data"):
        src = torch.randn(n, generator=gen, device=dev)
        a = dt.distributed_vector.from_array(
            src, halo=dt.halo_bounds(MM_HALO, MM_HALO, periodic=True))
    with step("stencil_iterate_matmul"):
        dt.stencil_iterate_matmul(a, W5, STEPS, k_block=K_BLOCK)
    with step("host copy"):
        out["matmul"] = a.to_array().cpu()
    del a
    with step("data"):
        b = dt.distributed_vector.from_array(
            src, halo=dt.halo_bounds(BLK_HALO, BLK_HALO, periodic=True))
    with step("stencil_iterate_blocked"):
        dt.stencil_iterate_blocked(b, W5, STEPS, time_block=T_BLOCK)
    with step("host copy"):
        out["blocked"] = b.to_array().cpu()
    del b
    with step("data"):
        x = dt.distributed_vector.from_array(
            torch.rand(n, generator=gen, device=dev))
        y = dt.distributed_vector.from_array(
            torch.rand(n, generator=gen, device=dev))
    with step("dot_n"):
        d = dt.dot_n(x, y, DOT_ROUNDS)
    out["dot_n"] = d.cpu()
    if keep_inputs:
        out["x"], out["y"] = x.to_array().cpu(), y.to_array().cpu()
    del x, y
    with step("data"):
        s = dt.distributed_vector.from_array(src)
        res = dt.distributed_vector(n)
    with step("inclusive_scan"):
        dt.inclusive_scan(s, res)
    with step("host copy"):
        out["scan"] = res.to_array().cpu()
    with step("exclusive_scan"):
        dt.exclusive_scan(s, res)
    with step("host copy"):
        out["exscan"] = res.to_array().cpu()
    del s
    with step("data"):
        small = dt.distributed_vector.from_array(src * 2.0 ** -16)
    with step("inclusive_scan_n"):
        dt.inclusive_scan_n(small, res, 2)
    with step("host copy"):
        out["scan_n"] = res.to_array().cpu()
    return src.cpu(), out


def compare_paths(got, ref, tag):
    """Kernel route vs plain route of the same main path."""
    check(f"{tag} stencil_iterate_matmul", max_err(got["matmul"],
                                                   ref["matmul"]), 1e-5)
    check(f"{tag} stencil_iterate_blocked", max_err(got["blocked"],
                                                    ref["blocked"]), 1e-5)
    d = float(ref["dot_n"])
    # K3 against its plain version, as in phase 3: 4 ulps of the result
    check(f"{tag} dot_n", abs(float(got["dot_n"]) - d), 4 * f32_ulp(d))
    for k in ("scan", "exscan", "scan_n"):
        scale = float(ref[k].abs().max())
        check(f"{tag} {k}", max_err(got[k], ref[k]), 1e-4 * scale)


def periodic_oracle(src64, steps):
    """``steps`` periodic 5-point steps of a float64 vector as one
    circular cross-correlation with the composed taps (by FFT):
    out[i] = sum_j c[j] x[i - R + j]."""
    from dr_tpu_torch.ops.stencil_matmul import composed_taps
    c = composed_taps(W5, steps)
    R = (len(c) - 1) // 2
    n = len(src64)
    kern = np.zeros(n)
    np.add.at(kern, np.arange(-R, R + 1) % n, c)
    return np.fft.irfft(np.fft.rfft(src64) * np.conj(np.fft.rfft(kern)), n)


def four_ranks(dt, n, seed, device="cuda:0"):
    """Phase 5: 4 logical ranks on one device against numpy."""
    import torch
    dt.init(dt.get_duplicated_devices(4, [device]))
    src, out = main_path(dt, n, seed, keep_inputs=True)
    s64 = src.double().cpu().numpy()
    for k, steps in (("matmul", STEPS), ("blocked", STEPS)):
        ref = periodic_oracle(s64, steps)
        check(f"4 ranks {k} vs numpy", float(np.abs(
            out[k].double().cpu().numpy() - ref).max()), 1e-4)
    cs = np.cumsum(s64)
    scale = float(np.abs(cs).max())
    # f32 prefixes drift from the exact ones by ~1e-6 of the running
    # magnitude: 1e-4 of the largest prefix; the steps (each prefix adds
    # its own element, across blocks and ranks) within 8 f32 ulps of it,
    # as for K4 alone
    check("4 ranks inclusive_scan vs numpy", float(np.abs(
        out["scan"].double().cpu().numpy() - cs).max()), 1e-4 * scale)
    check("4 ranks inclusive_scan steps", step_err(out["scan"], src, 0.0),
          8 * f32_ulp(scale))
    ecs = np.concatenate([[0.0], cs[:-1]])
    check("4 ranks exclusive_scan vs numpy", float(np.abs(
        out["exscan"].double().cpu().numpy() - ecs).max()), 1e-4 * scale)
    shifted = torch.cat([src.new_zeros(1), src[:-1]])
    check("4 ranks exclusive_scan steps",
          step_err(out["exscan"], shifted, 0.0), 8 * f32_ulp(scale))
    # inclusive_scan_n: two chained scans of src * 2^-16, against two
    # chained float64 cumsums; 1e-4 of the largest value, as above
    c2 = np.cumsum(np.cumsum(s64 * 2.0 ** -16))
    check("4 ranks inclusive_scan_n vs numpy", float(np.abs(
        out["scan_n"].double().cpu().numpy() - c2).max()),
        1e-4 * float(np.abs(c2).max()))
    # dot_n: the salted rounds in float64 (the salt, ~1e-31, vanishes
    # against y there too); four rank partials of f32 sums of positive
    # terms, each within ~1 of its exact value, and a 4-term f32 sum:
    # tolerance 4 ulps of the result
    x64 = out["x"].double().numpy()
    y64 = out["y"].double().numpy()
    d = 0.0
    for _ in range(DOT_ROUNDS):
        d = float(x64 @ (y64 + d * 1e-38))
    check("4 ranks dot_n vs numpy", abs(float(out["dot_n"]) - d),
          4 * f32_ulp(d))


def timings(n, gen, results):
    """Phase 6: kernel, plain and library times at the main-path shapes."""
    import torch
    import torch.nn.functional as F
    from dr_tpu_torch.ops import (reduce_pallas, scan_pallas,
                                  stencil_matmul, stencil_pallas)
    dev = torch.device("cuda", 0)
    f = 4  # bytes per f32

    row = torch.randn((1, n + 2 * MM_HALO), generator=gen, device=dev)
    taps = torch.from_numpy(stencil_matmul.composed_taps(
        W5, K_BLOCK).astype(np.float32)).to(dev).reshape(1, 1, -1)
    r = results["stencil_matmul"]
    r["ms"] = events_ms(lambda: stencil_matmul.matmul_stencil_row(
        row, n, MM_HALO, W5, K_BLOCK), 5)
    r["plain_ms"] = events_ms(lambda: stencil_matmul.plain_apply(
        row, n, MM_HALO, W5, K_BLOCK), 3)
    # one library call computing the same banded sum: conv1d (a
    # cross-correlation, so the taps as they are) over the row
    r["library_ms"] = events_ms(lambda: F.conv1d(row[None], taps), 3)
    ntaps = 2 * K_BLOCK * 2 + 1
    r["bound_ms"], r["bound_by"] = bound(2 * (n + 2 * MM_HALO) * f,
                                         2.0 * ntaps * n)
    del row

    row = torch.randn((1, n + 2 * BLK_HALO), generator=gen, device=dev)
    r = results["stencil_blocked"]
    r["ms"] = events_ms(lambda: stencil_pallas.blocked_stencil_row(
        row, n, BLK_HALO, W5, T_BLOCK), 5)
    r["plain_ms"] = events_ms(lambda: stencil_pallas.plain_blocked(
        row, n, BLK_HALO, W5, T_BLOCK), 2)
    # T steps equal one cross-correlation with the 4T+1 composed taps
    taps = torch.from_numpy(stencil_matmul.composed_taps(
        W5, T_BLOCK).astype(np.float32)).to(dev).reshape(1, 1, -1)
    r["library_ms"] = events_ms(lambda: F.conv1d(row[None], taps), 3)
    r["bound_ms"], r["bound_by"] = bound(
        2 * (n + 2 * BLK_HALO) * f, float(T_BLOCK) * n * (2 * len(W5) - 1))
    del row

    x = torch.rand(n, generator=gen, device=dev)
    y = torch.rand(n, generator=gen, device=dev)
    salt = torch.tensor(0.0, device=dev)
    r = results["chunked_dot"]
    r["ms"] = events_ms(lambda: reduce_pallas.chunked_dot(x, y, salt=salt),
                        10)
    r["plain_ms"] = events_ms(lambda: reduce_pallas.plain_dot(x, y, salt), 5)
    r["library_ms"] = events_ms(lambda: torch.dot(x, y), 10)
    r["bound_ms"], r["bound_by"] = bound(2 * n * f + f, 3.0 * n)
    del y

    r = results["chunked_cumsum"]
    carry = torch.tensor(0.0, device=dev)
    r["ms"] = events_ms(lambda: scan_pallas.chunked_cumsum(x, carry=carry),
                        10)
    r["plain_ms"] = events_ms(lambda: scan_pallas.plain_cumsum(x, carry), 5)
    r["library_ms"] = events_ms(lambda: torch.cumsum(x, 0), 10)
    r["bound_ms"], r["bound_by"] = bound(2 * n * f, 2.0 * n)
    del x


def main(argv):
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "dr_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout holding dr_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import dr_tpu_torch as dt
    from dr_tpu_torch.ops import kernels

    quick = "--quick" in argv
    seed = 20261016
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain K1 in full f32
    torch.backends.cudnn.allow_tf32 = False        # the conv1d yardstick

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kernels.last_build_seconds:.1f} s)")
    for p in sorted(kernels.BUILD.glob("*.ptxas.txt")):
        for line in p.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {p.stem.split('-')[0]}: {line.strip()}")

    replaces = {
        "stencil_matmul": ("dr_tpu_torch/csrc/stencil_matmul.cu",
                           "dr_tpu/ops/stencil_matmul.py:209"),
        "stencil_blocked": ("dr_tpu_torch/csrc/stencil_blocked.cu",
                            "dr_tpu/ops/stencil_pallas.py:89"),
        "chunked_dot": ("dr_tpu_torch/csrc/dot.cu",
                        "dr_tpu/ops/reduce_pallas.py:64"),
        "chunked_cumsum": ("dr_tpu_torch/csrc/scan.cu",
                           "dr_tpu/ops/scan_pallas.py:244"),
    }
    results = {k: {"name": k, "route": "cuda", "source": s,
                   "replaces": rp} for k, (s, rp) in replaces.items()}

    n = 1 << (20 if quick else 30)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    log(f"phase 3: kernels vs plain versions at n={n}")
    kernel_checks(dt, n, gen, results)
    torch.cuda.synchronize()
    if quick:
        log(json.dumps({"quick": True, "checked": list(results)}))
        return 0

    log(f"phase 4: main path, 1 rank on cuda:0, n={n}")
    dt.init(["cuda:0"])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    steps = {}
    src, got = main_path(dt, n, seed, steps)
    counts = dict(kernels.launches)
    log(f"  main path {time.perf_counter() - t0:.2f} s, launches {counts}")
    log("  main path seconds by step: " + json.dumps(steps))
    peak = torch.cuda.max_memory_allocated()
    for k, c in counts.items():
        results[k]["launches"] = c
        if c <= 0:
            raise AssertionError(f"kernel {k} never launched on the "
                                 "main path")
    with plain_versions(kernels):
        _, ref = main_path(dt, n, seed)
    compare_paths(got, ref, "main path")
    del src, got, ref
    torch.cuda.empty_cache()

    log("phase 5: main path, 4 ranks on cuda:0, n=2^26")
    four_ranks(dt, 1 << 26, seed)
    dt.final()
    torch.cuda.empty_cache()

    log("phase 6: timings")
    timings(n, gen, results)
    log(f"peak device memory (main path): {peak} bytes "
        f"({peak / 2 ** 30:.2f} GiB)")
    order = ("stencil_matmul", "stencil_blocked", "chunked_dot",
             "chunked_cumsum")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    table = {"kernels": [{k: results[n_][k] for k in keys}
                         for n_ in order]}
    log(f"card: {card}")
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
