#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dr_tpu_torch``) on one NVIDIA card.

Run from the repository root:  ``python3 chip_smoke.py``  (``--quick``
checks the kernels at small shapes only).  Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the eight CUDA sources from ``dr_tpu_torch/csrc`` (``nvcc``;
   K8 runs on K7's library);
3. hold each kernel against its plain PyTorch version at the main-path
   shapes, on the card (K2 bit for bit, also on one partial tile with
   17 taps and on its shared-memory route; K4 the same bits on a second
   call, and on inputs 4 (f32) and 6 (bf16) bytes past a 16-byte
   boundary; K5 also on
   partial last tiles with T = 17 and pad > T; K6 and K7 bit for bit:
   K6 at M in {256, 4096, 2^15}, keys-only and KV, one block a call,
   and batches of 8 and 133 blocks at M in {256, 4096, 16384, 2^15}; K7
   at nseg in {1, 127, 128,
   129, 2^15} over int32, f32, bf16, 8- and 16-bit integer and bool
   columns, at n = 2^30 in one segment, and on columns that start 0 to
   15 elements past a 16-byte boundary with ragged tails; K8 at
   n = 2^30 over 1024 and 2^15 bins);
4. the 1-D main path at full size on one rank: a 2^30-element f32
   ``distributed_vector``, 512 steps of ``stencil_iterate_matmul``
   (k_block=256, halo 512) and of ``stencil_iterate_blocked``
   (time_block=64, halo 1024), ``dot_n``, ``inclusive_scan`` and
   ``inclusive_scan_n``; launch counts are read around this phase, and
   every result is compared with the same path run on the plain
   versions;
5. the same path on 4 logical ranks of the one card at n = 2^26 (ring
   exchanges and the scan's cross-rank carry), against a numpy oracle;
6. the 2-D heat path on one rank: a 16384 x 16384 f32 ``dense_matrix``,
   ``stencil2d_iterate_blocked`` (520 steps, time_block=16: 33 K5
   passes) and ``stencil2d_n`` (32 passes); launch counts around this
   phase, results against the plain versions;
7. the 2-D path on 4 logical ranks (a 2x2 grid) at 8192 x 8192: the
   tiled ``stencil2d_iterate`` in block and block-cyclic layouts and the
   single-tile blocked path against a float64 recurrence, ``gemm``
   against a float64 product, and a ``distributed_mdarray`` transpose and
   ``submdspan``, bit-exact;
8. per-kernel times from CUDA events beside their bounds, the plain
   versions' and one library call's times, K2's floor without FMAs, and
   K2's and K5's ptxas registers and spills;
9. the sort path on one rank at 2^28 f32 keys: ``sort`` (ascending and
   descending), ``is_sorted``, ``sort_by_key`` with an int32 iota
   payload, ``argsort``, ``reduce`` min / max / int32 sum; launch counts
   around this phase (K7 once per reduce, K6 none: the blocks are above
   its cap), results against numpy sorting the same encoding;
10. the sort path on 4 logical ranks at 2^26 over a distribution with
    an empty rank: keys-only, a window, key-value, and the seconds of
    each phase of the sample sort;
11. the K6 path: 8 ranks x 16384 keys and 4 ranks x 2^15, ``sort``,
    ``sort_by_key`` and ``sort_n(8)``; K6 launches once per sort (the
    ranks share the card, so their blocks are one batch); and the peak
    device memory of the paths;
12. ring attention on one rank at Llama-3-8B's attention geometry and a
    32k-token context (B = 1, S = 32768, 32 q heads, 8 K/V heads, d =
    128, bf16), causal and not: one K9 launch per call, the output
    against the plain version on the card and against a float64 dense
    oracle on 64 query rows per head, ms per call, effective TFLOP/s and
    the peak device memory;
13. the same causal call on 4 ranks of the card (16 K9 launches, serial
    equal to pipelined bit for bit, the output against phase 12's), the
    f32 blockwise route at S = 4096 (h = 8, hkv = 2) with and without
    ``q_chunk`` against float64, and ``ring_attention_n`` at bench.py's
    shape (S = 8192, h = 8, causal): TFLOP/s from 2 and 18 iterations;
14. the relational path on one rank: bench.py's pipeline (f32 fact keys,
    fan-in 16, a permuted dimension table; join -> groupby sum -> top_k
    8, and a 16-bin histogram of the joined values) at n_fact = 2^26 over
    2^22 keys, a 1024-bin histogram of 2^30 f32 normals, and bench.py's
    kernel geometry (8192 int32 keys a rank: K7 and K8 once a rank, K6
    once);
    K7 launches 0 times on the 2^26 groupby (above its cap); every result
    against torch or numpy oracles that do not use the port's code;
15. the same on 4 ranks of the card at n_fact = 2^24: the partition
    join (the default above 2^18 rows) equal bit for bit to the forced
    broadcast join, an outer join with keys missing on both sides, and
    the kernel geometry;
16. the main-path entry: ``dr_tpu_torch.entry.entry()``'s step and
    masked sum on the card against the same step on the CPU, and
    ``dryrun(4)`` on 4 ranks of the card (every section of
    ``__graft_entry__.dryrun_multichip`` the port has), with K1, K3, K4,
    K6/K7 and K9 launched by it;
17. bench.py's halo-exchange p50 (a periodic ``halo_bounds(1024,
    1024)`` vector of 2^22 cells a rank, ``exchange_n(64)``, 4 calls x 5
    batches, CUDA events) on 1 and 4 ranks, the ghosts checked against
    their owners; and GB/s/chip of phase 4's steps and phase 8's kernels
    with bytes counted as bench.py counts them;
18. the sparse path on one rank: bench.py's config 5 pattern (32 random
    columns a row) at 2^22 rows and 2^27 nonzeros: the autoselected
    format (ELL), ``gemv`` against a float64 scipy product row by row
    and the same bits on a second call, ``gemv_n`` GFLOP/s beside the
    bytes bound (``nnz*8 + m*12`` bytes) and one cuSPARSE call, ``spmm``
    with 8 vectors, the banded case (2^18 rows, half-band 128) on BCSR,
    and the peak device memory;
19. the sparse path on 4 ranks at 2^20 rows against float64 scipy: row
    tiles (ELL), the ring layout (serial equal to pipelined bit for
    bit), a 2x2 block-cyclic grid with ``gemv`` and ``spmm``, the banded
    matrix on the grid (BCSR) and a matrix with one dense row (csr);
20. re-layout and state on 4 ranks of the card: bench.py's redistribute
    ping-pong (even <-> a rotated cut, ``bench.py:1064-1102``) at 2^28
    f32, each hop's rows equal bit for bit between the collective and the
    host-staged routes, a team hop, a seeded uneven cut, a hop onto 2
    ranks (host-staged), GB/s of both routes by bench.py's count
    (``2*n*4`` bytes an iteration) and the collective route's peak
    memory, a periodic halo-1024 vector at 2^26 moved and exchanged; an
    unstructured halo over 2^26 cells (2^20 indices a rank, duplicates
    included): ``exchange()`` and the five ``reduce`` ops bit for bit
    with numpy, twice, ms per call; checkpoint round trips (a 2^28 f32
    vector with an uneven distribution, a 2^26 bf16 vector, an 8192^2
    cyclic matrix, config 5's pattern at 2^20 rows, a 3-D mdarray), bit
    for bit, with seconds and bytes, and a truncated file refused; the
    communicator at 2^24, ``rma_window``, an ``op_from_expr`` transform
    at 2^28 and the views, against numpy or torch;
21. observability: phase 14's relational pipeline (one rank, n_fact =
    2^26) and phase 15's (4 ranks, 2^24, the partition and the forced
    broadcast join) untraced and with ``dr_tpu_torch.obs`` armed, the
    outputs equal bit for bit, the four spans and their
    ``relational.phase`` children in the trace, the join's median of 5
    both ways; phase 20's 2^28 f32 re-layout traced on both routes (the
    ``redistribute`` span's ``impl``, the phases plan -> exchange ->
    rebind, ``redistribute.bytes_moved`` == ``plan_moves``' moved
    elements x 4, rows equal to the untraced hop's); ``obs.write()``
    into ``chiprun_out/phase21/``, read back and by
    ``tools/trace_view.py``; one step of the 1-D main path (one rank at
    2^30, 4 ranks at 2^26) under ``profiling.trace``: the device's idle
    share, the top device operations and the longest idle gaps with the
    host operations over them, the trace's kernels mapped to K1-K4 by
    their ``__global__`` names and counted against the launch counters;
    ``profiling.device_timer`` of ``dot_n`` within 10% of phase 8's K3
    time, and ``profiling.profile_phases`` of the 4-rank sort at 2^24.

Phase 3 also holds K9 (``flash_update``) against its plain version at
small shapes (d = 128 and 256 on the wgmma kernel, d = 768 on the
mma.sync one; s = 200, a ragged q tile; the causal diagonal inside a
tile), and phase 8 times it at BH = 32, s = skv = 32768, group 4,
causal, beside ``F.scaled_dot_product_attention`` as the library call,
and at d = 256, s = skv = 16384 on a line of its own.

Exits non-zero on any failure.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the kernel
table as one JSON object.
"""

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, the
# dense float32 rate outside the tensor cores and the dense bf16
# tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12

W5 = (0.05, 0.25, 0.4, 0.25, 0.05)  # the bench's 5-point stencil
K_BLOCK, MM_HALO = 256, 512
T_BLOCK, BLK_HALO = 64, 1024
STEPS = 512
DOT_ROUNDS = 8
M2D, T2D = 16384, 16          # the 2-D main path's matrix and time block
STEPS2D, ITERS2D = 520, 32    # 32 full passes + one of 8; 32 passes
M4, STEPS4, CYC_TILE = 8192, 64, 1024  # the 2-D four-rank phase
SORT_LOG2 = 28   # the sort path on one rank: 1 GiB of f32 keys
SORT4_LOG2 = 26  # on four ranks, cut so its numpy oracle stays short
# ring attention: Llama-3-8B's attention (32 q heads, 8 K/V heads, head
# dim 128) at a 32k-token context; bench.py's ring_attention_n shape
RA_S, RA_H, RA_HKV, RA_D = 32768, 32, 8, 128
RA4_P = 4
RA_F32 = (4096, 8, 2)              # S, h, hkv of the f32 blockwise check
RAN_S, RAN_H, RAN_ITERS = 8192, 8, (2, 18)
ORACLE_ROWS = 64
K8_BINS = 1024         # K8's timed shape: 2^30 ids over 1024 bins
# the relational pipeline: 2^26 fact rows (about TPC-H SF 10's lineitem)
# over 2^22 keys (bench.py's fan-in 16) on one rank; 2^24 on 4 ranks
REL_FACT_LOG2, REL_CARD_LOG2, REL4_FACT_LOG2 = 26, 22, 24
# halo-exchange p50: bench.py's periodic halo of 1024 cells a side over
# 2^22 cells a rank, 64 exchanges a timed call
HALO_W, HALO_CELLS, HALO_ROUNDS = 1024, 1 << 22, 64
# the sparse path: bench.py's config 5 pattern (32 random columns a row)
# at 2^22 rows, 2^27 nonzeros (a SuiteSparse web or road matrix's scale,
# where bench.py's 2^17 rows were sized for a TPU), spmm with 8 vectors,
# the banded BCSR case at 2^18 rows (half-band 128); 4 ranks at 2^20
# rows, the banded grid with half-band 16
SP_LOG2, SP_K, SP_NV = 22, 32, 8
SPB_LOG2, SPB_HALF = 18, 128
SP4_LOG2, SP4_HALF = 20, 16
# phase 20, on 4 ranks: bench.py's redistribute ping-pong (even <->
# rotated cut) at 2^28 f32, 1 GiB (bench.py's 2^24 was a TPU chip's
# share), a periodic halo-1024 vector at 2^26; an unstructured halo over
# 2^26 cells, 2^20 mirrored indices a rank; checkpoints of a 2^28 f32
# vector, a 2^26 bf16 vector, an 8192^2 matrix in 1024^2 cyclic tiles,
# config 5's pattern at 2^20 rows and a 512 x 512 x 256 mdarray; the
# communicator at 2^24 and an expression transform at 2^28
RDX_LOG2, RDX_HALO_LOG2 = 28, 26
UH_LOG2, UH_GHOSTS_LOG2 = 26, 20
CK_LOG2, CK_BF_LOG2, CK_M, CK_TILE, CK_MD = 28, 26, 8192, 1024, (512, 512,
                                                                  256)
SURF_LOG2, EXPR_LOG2 = 24, 28
UH_OPS = ("plus", "multiplies", "max", "min", "second")
# phase 21 writes its traces here (a gitignored directory)
OBS_DIR = os.path.join(HERE, "chiprun_out", "phase21")


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


def bound(bytes_moved, flops, peak=FP32_FLOP_PER_S):
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
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


def release(torch):
    """Free what the last phase left, cycles included, and return the
    cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


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


def heat_tol(w, steps, scale):
    """Bound on |f32 result - exact| after ``steps`` 3x3 steps with
    nonnegative weights summing to at most 1: a step rounds each of its
    nnz products and nnz-1 sums once, each by at most 2^-24 of a partial
    sum no larger than the data's largest |value| (``scale``; such a step
    never raises it), and such a step does not grow an earlier error.
    Two f32 results of the same steps differ by at most twice this."""
    nnz = int(np.count_nonzero(np.asarray(w)))
    return steps * (2 * nnz - 1) * 2.0 ** -24 * scale


def kernel_checks(dt, n, m2d, gen, results):
    """Phase 3: every kernel against its plain version, same inputs."""
    import torch
    from dr_tpu_torch.ops import (reduce_pallas, scan_pallas,
                                  stencil2d_pallas, stencil_matmul,
                                  stencil_pallas)
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

    # K2: the same separately rounded products and sums in the same
    # order as the plain version, so the same bits: at the main path's
    # row, on one partial tile with 17 taps, and with a margin deep
    # enough (T*r > 2048) for the kernel's shared-memory route
    w17 = tuple(float(k) / 153.0 for k in range(1, 18))
    for tag, seg, halo, w, tsteps in (
            ("", n, BLK_HALO, W5, T_BLOCK),
            (" r=8 T=17 seg=1024", 1024, 1024, w17, 17),
            (" r=8 T=300 shared route", 4096, 3072, w17, 300)):
        row = torch.randn((1, seg + 2 * halo), generator=gen, device=dev)
        got = stencil_pallas.blocked_stencil_row(row, seg, halo, w, tsteps)
        ref = stencil_pallas.plain_blocked(row, seg, halo, w, tsteps)
        torch.cuda.synchronize()
        e = max_err(got, ref)
        if not tag:
            results["stencil_blocked"]["max_abs_err"] = e
        check_equal(f"K2 stencil_blocked{tag}", got, ref)
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
    # one launch with a fixed-order look-back: the same bits every call
    again = scan_pallas.chunked_cumsum(x, carry=carry)
    check_true("K4 chunked_cumsum same bits twice",
               torch.equal(got.view(torch.int32), again.view(torch.int32)))
    del again, ref
    # a start 4 bytes past a 16-byte boundary (a rank view behind a halo),
    # no carry: the same tolerances
    xs = x[1:]
    got = scan_pallas.chunked_cumsum(xs)
    ref = scan_pallas.plain_cumsum(xs)
    top = float(ref.abs().max())
    check("K4 chunked_cumsum 4 bytes off", max_err(got, ref), 1e-4 * top)
    check("K4 chunked_cumsum 4 bytes off steps", step_err(got, xs, 0.0),
          8 * f32_ulp(top))
    del got, ref, xs
    xb = x[:1 << 24].to(torch.bfloat16)
    g2 = scan_pallas.chunked_cumsum(xb, carry=carry)
    r2 = scan_pallas.plain_cumsum(xb, carry)
    # bf16 output rounds each f32 prefix to 8 significant bits: two f32
    # prefixes a hair apart may round to neighbouring bf16 values, so
    # allow two bf16 ulps (2^-6) of the largest prefix
    check("K4 chunked_cumsum bf16", max_err(g2, r2),
          2 ** -6 * float(r2.float().abs().max()))
    g2 = scan_pallas.chunked_cumsum(xb[3:], carry=carry)  # 6 bytes off
    r2 = scan_pallas.plain_cumsum(xb[3:], carry)
    check("K4 chunked_cumsum bf16 6 bytes off", max_err(g2, r2),
          2 ** -6 * float(r2.float().abs().max()))
    del x, xb, g2, r2

    # K5 at the 2-D main path's pass (the cross template): FMA-contracted
    # sums against the plain version's separately rounded ones, within
    # twice heat_tol; then all nine taps (the full template), and the
    # cross at T = 17 with pad > T, each with m and n off the kernel's
    # tiles (a partial last tile in both directions)
    w = dt.heat_step_weights(0.25)
    xp = torch.randn((m2d + 2 * T2D, m2d), generator=gen, device=dev)
    got = stencil2d_pallas.blocked_stencil2d_padded(xp, m2d, w, T2D, T2D)
    ref = stencil2d_pallas.plain_blocked2d(xp, m2d, w, T2D, T2D)
    torch.cuda.synchronize()
    results["stencil2d_blocked"]["max_abs_err"] = e = max_err(got, ref)
    check("K5 stencil2d_blocked", e,
          2 * heat_tol(w, T2D, float(xp.abs().max())))
    del got, ref, xp
    wf = ((0.05, 0.1, 0.05), (0.1, 0.4, 0.1), (0.05, 0.1, 0.05))
    q = m2d // 4 + 77
    xp = torch.randn((q + 10, m2d), generator=gen, device=dev)
    got = stencil2d_pallas.blocked_stencil2d_padded(xp, q, wf, 5, 5)
    ref = stencil2d_pallas.plain_blocked2d(xp, q, wf, 5, 5)
    check("K5 stencil2d_blocked full 3x3", max_err(got, ref),
          2 * heat_tol(wf, 5, float(xp.abs().max())))
    del got, ref, xp
    # drawn from a generator of its own, so the later checks' inputs do
    # not depend on this one
    q, nq, T, pad = m2d // 16 + 3, m2d - 128, 17, 24
    g5 = torch.Generator(device=dev).manual_seed(gen.initial_seed() + 5)
    xp = torch.randn((q + 2 * pad, nq), generator=g5, device=dev)
    got = stencil2d_pallas.blocked_stencil2d_padded(xp, q, w, T, pad)
    ref = stencil2d_pallas.plain_blocked2d(xp, q, w, T, pad)
    check("K5 stencil2d_blocked partial tiles, T=17, pad 24",
          max_err(got, ref), 2 * heat_tol(w, T, float(xp.abs().max())))
    check_true("K5 stencil2d_blocked pad rows and frozen edges",
               torch.equal(got[:pad + 1], xp[:pad + 1])
               and torch.equal(got[pad + q - 1:], xp[pad + q - 1:])
               and torch.equal(got[:, [0, nq - 1]], xp[:, [0, nq - 1]]))
    del got, ref, xp


def bit_diff(got, want):
    """(same bits?, max |got - want| in float64 over the non-NaN cells);
    a NaN matches a NaN at the same position."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    if got.is_floating_point():
        gn, wn = torch.isnan(got), torch.isnan(want)
        if not torch.equal(gn, wn):
            return False, float("inf")
        got, want = got.masked_fill(gn, 0), want.masked_fill(wn, 0)
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    same = torch.equal(got.view(ints[got.element_size()]),
                       want.view(ints[want.element_size()]))
    return same, (max_err(got, want) if got.numel() else 0.0)


def check_bits(name, got, want, worst):
    """Bit-for-bit check of kernel against plain; ``worst`` (a one-item
    list) keeps the largest difference seen."""
    same, err = bit_diff(got, want)
    worst[0] = max(worst[0], err)
    if not same:
        log(f"  {name}: FAIL (max_abs_err={err!r})")
        raise AssertionError(f"{name}: kernel and plain version differ")


def k6_inputs(n, gen, dev):
    """Keys of the sort's int32 encoding: random, heavy duplicates, keys
    at the dtype max (the pad key), and f32 values with NaN and +-0."""
    import torch
    from dr_tpu_torch.algorithms.sort import _encode
    imax = torch.iinfo(torch.int32).max
    rnd = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                        device=dev, dtype=torch.int32)
    dup = torch.randint(0, 8, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    top = rnd.clone()
    top[::8] = imax
    f = torch.randn(n, generator=gen, device=dev)
    f[1::7] = 0.0
    f[2::7] = -0.0
    f[3::11] = float("nan")
    return {"random": rnd, "duplicates": dup, "max": top,
            "f32 keys-only": _encode(f, distinct_zeros=True)[0],
            "f32": _encode(f)[0]}


def k6_checks(gen, results, device="cuda:0"):
    """Phase 3, K6: bit for bit against torch.sort of the same encoding,
    keys-only and (key, gid) pairs, at M in {256, 4096, 2^15}, full and
    padded blocks (the KV 2^15 block runs on a two-block cluster), then
    batches of 8 and 133 blocks (more than the SMs) at M in {256, 4096,
    16384, 2^15}."""
    import torch
    from dr_tpu_torch.ops import sort_pallas
    dev = torch.device(device)
    imax = torch.iinfo(torch.int32).max
    worst = [0.0]
    for M in (256, 4096, 1 << 15):
        for n in (M, M - 37):
            for kind, keys in k6_inputs(n, gen, dev).items():
                gid = torch.randperm(n, generator=gen, device=dev).to(
                    torch.int32)
                if kind == "max":  # pad-like pairs: identical, at the max
                    gid[-5:] = imax
                    keys = keys.clone()
                    keys[-5:] = imax
                got = sort_pallas.sort_keys(keys)
                check_bits(f"K6 keys M={M} n={n} {kind}", got,
                           sort_pallas.plain_sort_keys(keys), worst)
                gk, gg = sort_pallas.sort_kv(keys, gid)
                rk, rg = sort_pallas.plain_sort_kv(keys, gid)
                check_bits(f"K6 kv keys M={M} n={n} {kind}", gk, rk, worst)
                check_bits(f"K6 kv gids M={M} n={n} {kind}", gg, rg, worst)
    # batches: one launch sorts every row; 133 rows are more than the SMs
    for M in (256, 4096, 16384, 1 << 15):
        for n in (M, M - 37):
            for b in (8, 133):
                keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, n),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)
                keys[:, ::3] = torch.randint(-3, 3, keys[:, ::3].shape,
                                             generator=gen, device=dev,
                                             dtype=torch.int32)
                keys[:, 1::11] = imax
                gid = torch.argsort(torch.rand((b, n), generator=gen,
                                               device=dev), dim=1).to(
                    torch.int32)
                keys[:, -5:] = imax  # pad-like pairs
                gid[:, -5:] = imax
                check_bits(f"K6 batch {b}x{n} keys",
                           sort_pallas.sort_keys(keys),
                           sort_pallas.plain_sort_keys(keys), worst)
                gk, gg = sort_pallas.sort_kv(keys, gid)
                rk, rg = sort_pallas.plain_sort_kv(keys, gid)
                check_bits(f"K6 batch {b}x{n} kv keys", gk, rk, worst)
                check_bits(f"K6 batch {b}x{n} kv gids", gg, rg, worst)
    log("  K6 bitonic_sort: 30 keys-only and 30 KV blocks, 16 keys-only "
        "and 16 KV batches bit-exact ok")
    results["bitonic_sort"]["max_abs_err"] = worst[0]


def k7_columns(n, gen, dev):
    """Four int32 columns (sum, prod, min, max), four float ones (f32
    and bf16 min/max) with +-0, NaN and infinities, and eight 8- and
    16-bit integer and bool ones (reduce's narrow containers)."""
    import torch
    i = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                      device=dev, dtype=torch.int32)
    i8, u8, i16 = i.to(torch.int8), (i >> 8).to(torch.uint8), \
        (i >> 16).to(torch.int16)
    tf = (i & 7) != 0
    f = torch.randn(n, generator=gen, device=dev)
    special = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                            float("-inf")], device=dev)
    pos = torch.randint(0, n, (max(n // 8, 1),), generator=gen, device=dev)
    f[pos] = special[torch.randint(0, 5, pos.shape, generator=gen,
                                   device=dev)]
    b = f.to(torch.bfloat16)
    return ([(i, "sum"), (i, "prod"), (i, "min"), (i, "max")],
            [(f, "min"), (f, "max"), (b, "min"), (b, "max")],
            [(i8, "sum"), (i8 | 1, "prod"), (u8, "min"), (i16, "max")],
            [(tf, "sum"), (tf, "prod"), (i16, "sum"), (u8, "max")])


def k7_checks(n, gen, results, device="cuda:0"):
    """Phase 3, K7: bit for bit against its plain version, NaN matching
    NaN: nseg in {1, 127, 128, 129, 2^15} x n in {1, 1000, 2^15} with
    out-of-range ids and empty segments, then ``n`` elements in one
    segment without ids (reduce's use)."""
    import torch
    from dr_tpu_torch.ops import segred_pallas as sr
    dev = torch.device(device)
    worst = [0.0]
    for nseg in (1, 127, 128, 129, 1 << 15):
        for m in (1, 1000, 1 << 15):
            ids = torch.randint(-2, nseg + 2, (m,), generator=gen,
                                device=dev, dtype=torch.int32)
            for cols in k7_columns(m, gen, dev):
                got = sr.segmented(ids, nseg, cols)
                ref = sr.plain_segmented(ids, nseg, cols)
                for (v, op), g, r in zip(cols, got, ref):
                    check_bits(f"K7 {v.dtype} {op} nseg={nseg} n={m}", g, r,
                               worst)
    # n elements, one segment: |randn| with +0.0 and -0.0 planted, so
    # min is -0.0; then a NaN, which both min and max must propagate;
    # and the int32 sum of the same bits (modulo 2^32)
    x = torch.randn(n, generator=gen, device=dev).abs_()
    x[n // 3] = 0.0
    x[n // 2] = -0.0
    x[n - 1] = 0.0
    for tag in ("+-0", "NaN"):
        cols = ((x, "min"), (x, "max"))
        got = sr.segmented(None, 1, cols)
        ref = sr.plain_segmented(None, 1, cols)
        for (v, op), g, r in zip(cols, got, ref):
            check_bits(f"K7 f32 {op} n={n} one segment {tag}", g, r, worst)
        if tag == "+-0" and not torch.signbit(got[0]).item():
            raise AssertionError("K7 min over +-0 is not -0.0")
        x[n // 5] = float("nan")
    xi = x.view(torch.int32)
    check_bits(f"K7 int32 sum n={n} one segment",
               sr.segmented(None, 1, ((xi, "sum"),))[0],
               sr.plain_segmented(None, 1, ((xi, "sum"),))[0], worst)
    k7_unaligned(gen, dev, worst)
    log(f"  K7 segred: bit-exact ok at nseg 1..2^15 and n={n}, unaligned "
        f"starts and ragged tails")
    results["segred"]["max_abs_err"] = worst[0]
    del x, xi


def k7_unaligned(gen, dev, worst):
    """K7 on columns that start 0 to 3 elements (f32, bf16) or 0 to 15
    (int8, bool) past a 16-byte boundary, ids at the same and at another
    offset, n in {1, 15, 17, 2^20 + 3} (ragged tails) and nseg in {none,
    1, 127, 1024, 1025, 2^15} (every route of the kernel), NaN and +-0.0
    in the floats: bit for bit against the plain version."""
    import torch
    from dr_tpu_torch.ops import segred_pallas as sr
    for n in (1, 15, 17, (1 << 20) + 3):
        base = n + 16
        f = torch.randn(base, generator=gen, device=dev)
        special = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                                float("-inf")], device=dev)
        pos = torch.randint(0, base, (max(base // 8, 1),), generator=gen,
                            device=dev)
        f[pos] = special[torch.randint(0, 5, pos.shape, generator=gen,
                                       device=dev)]
        h = f.bfloat16()
        i8 = torch.randint(-128, 128, (base,), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        tf = torch.rand(base, generator=gen, device=dev) < 0.7
        for nseg in (None, 1, 127, 1024, 1025, 1 << 15):
            ids = None if nseg is None else torch.randint(
                -2, nseg + 2, (base,), generator=gen, device=dev,
                dtype=torch.int32)
            for off in range(16):
                calls = [((i8[off:off + n], "sum"), (i8[off:off + n], "max"),
                          (tf[off:off + n], "sum"), (tf[off:off + n], "min"))]
                if off < 4:
                    calls.append(((f[off:off + n], "min"),
                                  (f[off:off + n], "max"),
                                  (h[off:off + n], "min"),
                                  (h[off:off + n], "max")))
                for j, cols in enumerate(calls):
                    io = (off + j) % 4
                    seg = None if ids is None else ids[io:io + n]
                    got = sr.segmented(seg, nseg or 1, cols)
                    ref = sr.plain_segmented(seg, nseg or 1, cols)
                    for (v, op), g, r in zip(cols, got, ref):
                        check_bits(f"K7 {v.dtype} {op} n={n} nseg={nseg} "
                                   f"offset={off}", g, r, worst)


def stepper(dt, times):
    """A context manager adding each step's host-clock seconds, ended by
    a fence, to ``times[name]``."""
    @contextlib.contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        dt.fence()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
    return step


def main_path(dt, n, seed, times=None, keep_inputs=False):
    """The main path on the current runtime; returns the source vector
    and every result, moved to the host as it is made.  ``times`` (a
    dict) gets each step's host-clock seconds, each ended by a fence.
    ``keep_inputs`` also returns the dot operands (as "x" and "y")."""
    import torch
    step = stepper(dt, {} if times is None else times)
    dev = dt.devices()[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
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


def main_path_2d(dt, m, seed, times=None):
    """Phase 6: the 2-D heat path on the current runtime's one rank;
    returns the source matrix and both results, on the card."""
    import torch
    step = stepper(dt, {} if times is None else times)
    dev = dt.devices()[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    w = dt.heat_step_weights(0.25)
    out = {}
    with step("data"):
        src = torch.randn((m, m), generator=gen, device=dev)
        M = dt.dense_matrix.from_array(src)
    with step("stencil2d_iterate_blocked"):
        dt.stencil2d_iterate_blocked(M, w, STEPS2D, time_block=T2D)
    out["blocked"] = M.to_array()
    del M
    with step("data"):
        M = dt.dense_matrix.from_array(src)
    with step("stencil2d_n"):
        dt.stencil2d_n(M, w, ITERS2D, time_block=T2D)
    out["n"] = M.to_array()
    return src, out


def compare_2d(dt, src, got, ref, tag):
    """Kernel route vs plain route of the 2-D path: each within twice
    heat_tol of the other, finite and of the matrix's shape."""
    w = dt.heat_step_weights(0.25)
    scale = float(src.abs().max())
    for k, steps in (("blocked", STEPS2D), ("n", ITERS2D * T2D)):
        assert got[k].shape == src.shape, (k, got[k].shape)
        check(f"{tag} {k}", max_err(got[k], ref[k]),
              2 * heat_tol(w, steps, scale))


def heat_reference(u, w, steps):
    """``steps`` Jacobi steps of a 3x3 stencil with frozen edges in
    float64, written here independently of the port."""
    import torch
    u = u.double().clone()
    m, n = u.shape
    w = np.asarray(w, dtype=np.float64)
    for _ in range(steps):
        acc = torch.zeros_like(u[1:-1, 1:-1])
        for di in range(3):
            for dj in range(3):
                if w[di, dj]:
                    acc += float(w[di, dj]) * u[di:di + m - 2, dj:dj + n - 2]
        u[1:-1, 1:-1] = acc
    return u


def check_equal(name, got, want):
    import torch
    ok = got.shape == want.shape and bool(torch.equal(got, want))
    log(f"  {name}: bit-exact {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: not bit-exact")


def four_ranks_2d(dt, m, seed, kernels, device="cuda:0"):
    """Phase 7: the 2-D path on 4 logical ranks of one device (a 2x2
    grid) against float64 references."""
    import torch
    dt.init(dt.get_duplicated_devices(4, [device]))
    times = {}
    step = stepper(dt, times)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    w = dt.heat_step_weights(0.25)
    src = torch.randn((m, m), generator=gen, device=device)
    scale = float(src.abs().max())
    blocked_steps = 2 * T2D + T2D // 2
    ref_b = heat_reference(src, w, blocked_steps)
    ref = heat_reference(ref_b, w, STEPS4 - blocked_steps)
    cyclic = dt.block_cyclic(tile=(CYC_TILE, CYC_TILE))
    for name, part in (("block", None), ("cyclic", cyclic)):
        A = dt.dense_matrix.from_array(src, part)
        B = dt.dense_matrix.from_array(src, part)
        assert A.grid_shape == (2, 2), A.grid_shape
        with step(f"stencil2d_iterate {name}"):
            dt.stencil2d_iterate(A, B, w, STEPS4)
        check(f"4 ranks stencil2d_iterate {name} ({A.grid_tiles} tiles) "
              "vs float64", max_err(A.to_array(), ref),
              heat_tol(w, STEPS4, scale))
        del A, B
    # the blocked path on a single-tile matrix under this runtime: two
    # K5 passes of 16 and one of 8
    k5 = kernels.launches["stencil2d_blocked"]
    S = dt.dense_matrix.from_array(src, dt.block_cyclic(grid=(1, 1)))
    with step("stencil2d_iterate_blocked single tile"):
        dt.stencil2d_iterate_blocked(S, w, blocked_steps, time_block=T2D)
    check("4 ranks single-tile stencil2d_iterate_blocked vs float64",
          max_err(S.to_array(), ref_b), heat_tol(w, blocked_steps, scale))
    if kernels.launches["stencil2d_blocked"] - k5 != 3:
        raise AssertionError("single-tile blocked path did not launch K5 "
                             "three times")
    del S, ref, ref_b
    # gemm: an f32 product of length-k dots is within k * 2^-24 of
    # (|A||B|)_ij of the exact one (TF32 off)
    ga = torch.randn((m, m), generator=gen, device=device)
    gb = torch.randn((m, m), generator=gen, device=device)
    exact = torch.matmul(ga.double(), gb.double())
    mag = torch.matmul(ga.double().abs(), gb.double().abs())
    for name, part in (("block", None), ("cyclic", cyclic)):
        A = dt.dense_matrix.from_array(ga, part)
        B = dt.dense_matrix.from_array(gb, part)
        with step(f"gemm {name}"):
            C = dt.gemm(A, B)
        rel = float(((C.to_array().double() - exact).abs() / mag).max())
        check(f"4 ranks gemm {name} vs float64 (relative to |A||B|)", rel,
              m * 2.0 ** -24)
        del A, B, C
    del exact, mag
    # distributed_mdarray: the graft entry's (2P, 6, 5) cube
    cube = torch.arange(8 * 6 * 5, dtype=torch.float32,
                        device=device).reshape(8, 6, 5)
    M3 = dt.distributed_mdarray.from_array(cube)
    T3 = dt.distributed_mdarray((5, 8, 6))
    dt.transpose(T3, M3, axes=(2, 0, 1))
    check_equal("4 ranks mdarray transpose(2, 0, 1)", T3.to_array(),
                cube.permute(2, 0, 1))
    check_equal("4 ranks mdarray submdspan",
                M3.submdspan(slice(1, 8), slice(2, 5), slice(0, 3))
                .to_array(), cube[1:, 2:5, 0:3])
    log("  4-rank 2-D seconds by step: " + json.dumps(times))


def encoded_host(dt_sort, t, distinct_zeros=True):
    """The sort's int32 order keys of a card tensor, on the host."""
    return dt_sort._encode(t, distinct_zeros=distinct_zeros)[0].cpu().numpy()


def check_true(name, ok):
    log(f"  {name}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(name)


def check_stable(name, src, keys, pay, descending=False):
    """``pay`` is the stable sort permutation of ``src`` and ``keys`` the
    keys in that order: a permutation, ``src[pay]`` equal to ``keys``
    bit for bit (zeros as one key), and rising (falling when descending)
    inside every run of equal keys.  With the keys checked against numpy
    this fixes the result."""
    import torch
    from dr_tpu_torch.algorithms import sort as dt_sort
    p = pay.long()
    perm = torch.equal(torch.sort(p).values,
                       torch.arange(p.numel(), device=p.device))
    k = dt_sort._encode(keys)[0]
    same = torch.equal(dt_sort._encode(src[p])[0], k)
    tie = k[1:] == k[:-1]
    step = p[1:] - p[:-1]
    order = bool(((step < 0) if descending else (step > 0))[tie].all())
    check_true(f"{name}: permutation, keys, stable ties", perm and same
               and order)


def sort_path(dt, n, seed, times):
    """Phase 9: the sort path on the current runtime's one rank: sort
    (ascending, then descending) with is_sorted after each, sort_by_key
    with an int32 iota payload, argsort, and reduce min / max / int32
    sum.  Returns the results on the card and the source."""
    import torch
    step = stepper(dt, times)
    dev = dt.devices()[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    out = {}
    with step("data"):
        src = torch.randn(n, generator=gen, device=dev)
        v = dt.distributed_vector.from_array(src)
    with step("sort"):
        dt.sort(v)
    with step("is_sorted"):
        out["up_sorted"] = dt.is_sorted(v)
    out["asc"] = v.to_array().clone()
    with step("sort descending"):
        dt.sort(v, descending=True)
    with step("is_sorted"):
        out["down_sorted"] = dt.is_sorted(v)
    out["desc"] = v.to_array().clone()
    del v
    with step("data"):
        k = dt.distributed_vector.from_array(src)
        pay = dt.distributed_vector(n, np.int32)
        dt.iota(pay, 0)
    with step("sort_by_key"):
        dt.sort_by_key(k, pay)
    out["kv_keys"], out["kv_pay"] = k.to_array().clone(), \
        pay.to_array().clone()
    del k, pay
    with step("data"):
        a = dt.distributed_vector.from_array(src)
    with step("argsort"):
        idx = dt.argsort(a)
    out["argsort"] = idx.to_array().clone()
    with step("reduce min"):
        out["min"] = dt.reduce(a, op=min)
    with step("reduce max"):
        out["max"] = dt.reduce(a, op=max)
    with step("reduce int32 sum"):
        out["isum"] = dt.reduce(idx)
    return src, out


def check_sort_path(src, out):
    """Phase 9's results against numpy sorting the same encoding."""
    import torch
    from dr_tpu_torch.algorithms import sort as dt_sort
    n = src.numel()
    want = np.sort(encoded_host(dt_sort, src))
    check_true("sort vs numpy (bits)",
               np.array_equal(encoded_host(dt_sort, out["asc"]), want))
    check_true("sort descending vs numpy (bits)",
               np.array_equal(encoded_host(dt_sort, out["desc"]), want[::-1]))
    check_true("is_sorted after sort, not after descending",
               out["up_sorted"] and not out["down_sorted"])
    # sort_by_key gives both zeros one key (-0.0 is key -1, +0.0 key 0)
    check_true("sort_by_key keys vs numpy (bits)", np.array_equal(
        encoded_host(dt_sort, out["kv_keys"], False),
        np.where(want == -1, 0, want)))
    check_stable("sort_by_key payload", src, out["kv_keys"], out["kv_pay"])
    check_true("argsort equals the sort_by_key permutation",
               torch.equal(out["argsort"], out["kv_pay"]))
    host = src.cpu().numpy()
    for op in ("min", "max"):
        ref = np.float32(getattr(np, op)(host))
        check_true(f"reduce {op} vs numpy (bits)", np.float32(out[op])
                   .view(np.int32) == ref.view(np.int32))
    # the iota permutation's sum modulo 2^32, as an int32
    isum = (n * (n - 1) // 2 + 2 ** 31) % 2 ** 32 - 2 ** 31
    check_true("reduce int32 sum (modulo 2^32)", out["isum"] == isum)


@contextlib.contextmanager
def no_host_sync(name, device):
    """Fail if the body makes a synchronizing CUDA call: the sort keeps
    its matrices, counts and splitters on the card."""
    import torch
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
    log(f"  {name}: {'no synchronizing call' if cuda else 'ran'}")


def sort_four_ranks(dt, n, seed, kernels, device="cuda:0"):
    """Phase 10: 4 logical ranks of one device, a block_distribution
    with a zero-size rank: keys-only ascending and descending, a window
    across the empty rank, key-value with the payload on an even
    distribution, and the per-phase seconds of both programs."""
    import torch
    from dr_tpu_torch.algorithms import sort as dt_sort
    dt.init(dt.get_duplicated_devices(4, [device]))
    gen = torch.Generator(device=device).manual_seed(seed + 6)
    sizes = [n // 2, 0, n // 4, n - n // 2 - n // 4]
    src = torch.randn(n, generator=gen, device=device)
    k6 = kernels.launches["bitonic_sort"]
    want = np.sort(encoded_host(dt_sort, src))
    v = dt.distributed_vector.from_array(src, distribution=sizes)
    with no_host_sync("4 ranks sort", device):
        dt.sort(v)
    check_true("4 ranks sort vs numpy (bits)",
               np.array_equal(encoded_host(dt_sort, v.to_array()), want))
    dt.sort(v, descending=True)
    check_true("4 ranks sort descending vs numpy (bits)", np.array_equal(
        encoded_host(dt_sort, v.to_array()), want[::-1]))
    check_true("4 ranks is_sorted", not dt.is_sorted(v))
    del v
    b, e = n // 8, n - n // 8 - 5
    w = dt.distributed_vector.from_array(src, distribution=sizes)
    dt.sort(w[b:e])
    ref = encoded_host(dt_sort, src)
    ref[b:e] = np.sort(ref[b:e])
    check_true("4 ranks window sort vs numpy (bits)",
               np.array_equal(encoded_host(dt_sort, w.to_array()), ref))
    check_true("4 ranks is_sorted window", dt.is_sorted(w[b:e]))
    del w
    keys = torch.randint(0, 1000, (n,), generator=gen, device=device).float()
    kd = dt.distributed_vector.from_array(keys, distribution=sizes)
    pd = dt.distributed_vector(n, np.int32)
    dt.iota(pd, 0)
    with no_host_sync("4 ranks sort_by_key", device):
        dt.sort_by_key(kd, pd, descending=True)
    kv_want = np.sort(encoded_host(dt_sort, keys, False))[::-1]
    check_true("4 ranks sort_by_key descending keys vs numpy (bits)",
               np.array_equal(encoded_host(dt_sort, kd.to_array(), False),
                              kv_want))
    check_stable("4 ranks sort_by_key descending payload", keys,
                 kd.to_array(), pd.to_array(), descending=True)
    del kd, pd
    if kernels.launches["bitonic_sort"] != k6:
        raise AssertionError("K6 launched on blocks above its cap")
    phases = {}
    for name, names in (("keys", dt_sort.SORT_PHASES),
                        ("kv", dt_sort.SORTKV_PHASES)):
        prev = 0.0
        for ph in names:
            kd = dt.distributed_vector.from_array(src, distribution=sizes)
            pd = dt.distributed_vector(n, np.int32)
            dt.fence()
            t0 = time.perf_counter()
            if name == "keys":
                dt_sort.sort_phases_n(kd, ph, 1)
            else:
                dt_sort.sort_by_key_phases_n(kd, pd, ph, 1)
            dt.fence()
            t = time.perf_counter() - t0
            phases[f"{name} {ph}"] = t - prev
            prev = t
            del kd, pd
    log("  4-rank sort seconds by phase (prefix differences): "
        + json.dumps(phases))


K6_GEOMS = ((8, 16384), (4, 1 << 15))  # ranks x keys per rank
K6_ROUNDS = 8


def k6_path(dt, seed, device="cuda:0"):
    """Phase 11: the sort at the JAX package's K6 geometry (bench.py's
    16384 keys per rank on 8 ranks) and at the cap (2^15 on 4 ranks):
    sort, sort_by_key and sort_n(8), against numpy; returns the number
    of sorts, the K6 launches the phase must make (the ranks share one
    device, so each sort sorts their blocks in one batch)."""
    import torch
    from dr_tpu_torch.algorithms import sort as dt_sort
    want_launches = 0
    for ranks, per in K6_GEOMS:
        dt.init(dt.get_duplicated_devices(ranks, [device]))
        gen = torch.Generator(device=device).manual_seed(seed + ranks)
        n = ranks * per
        src = torch.randn(n, generator=gen, device=device)
        want = np.sort(encoded_host(dt_sort, src))
        v = dt.distributed_vector.from_array(src)
        dt.sort(v)
        check_true(f"K6 path {ranks}x{per} sort vs numpy (bits)",
                   np.array_equal(encoded_host(dt_sort, v.to_array()), want))
        keys = torch.randint(0, 50, (n,), generator=gen,
                             device=device).float()
        kd = dt.distributed_vector.from_array(keys)
        pd = dt.distributed_vector(n, np.int32)
        dt.iota(pd, 0)
        dt.sort_by_key(kd, pd)
        check_stable(f"K6 path {ranks}x{per} sort_by_key", keys,
                     kd.to_array(), pd.to_array())
        w = dt.distributed_vector.from_array(src)
        dt.sort_n(w, K6_ROUNDS)
        check_true(f"K6 path {ranks}x{per} sort_n({K6_ROUNDS}) vs numpy",
                   np.array_equal(encoded_host(dt_sort, w.to_array()), want))
        want_launches += 2 + K6_ROUNDS
    return want_launches


def composed_taps2d(w, steps):
    """The 3x3 weights composed with themselves ``steps`` times in
    float64: one cross-correlation with this kernel equals ``steps``
    unmasked steps."""
    w = np.asarray(w, dtype=np.float64)
    c = np.ones((1, 1))
    for _ in range(steps):
        out = np.zeros((c.shape[0] + 2, c.shape[1] + 2))
        for di in range(3):
            for dj in range(3):
                out[di:di + c.shape[0], dj:dj + c.shape[1]] += w[di, dj] * c
        c = out
    return c


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
    # the floor of the bit-exact form: each cell-step issues its 2r+1
    # multiplies and 2r adds as one instruction each (no FMA), at 128
    # lanes a clock on each SM and the card's highest SM clock
    ghz = max_sm_ghz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    floor = float(T_BLOCK) * n * (2 * len(W5) - 1) / (sms * 128 * ghz * 1e6)
    log(f"  K2 bound_ms={r['bound_ms']!r} ({r['bound_by']}); issue floor "
        f"without FMA {floor!r} ms ({sms} SMs at {ghz} GHz)")
    for line in ptxas_lines("stencil_blocked"):
        log(f"  K2 ptxas: {line}")
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

    import dr_tpu_torch as dt
    from dr_tpu_torch.ops import stencil2d_pallas
    m = M2D
    w = dt.heat_step_weights(0.25)
    xp = torch.randn((m + 2 * T2D, m), generator=gen, device=dev)
    r = results["stencil2d_blocked"]
    r["ms"] = events_ms(lambda: stencil2d_pallas.blocked_stencil2d_padded(
        xp, m, w, T2D, T2D), 10)
    r["plain_ms"] = events_ms(lambda: stencil2d_pallas.plain_blocked2d(
        xp, m, w, T2D, T2D), 2)
    # one library call for the same T steps without the frozen edges:
    # conv2d (a cross-correlation) with the composed (2T+1)^2 kernel
    taps = torch.from_numpy(composed_taps2d(w, T2D).astype(np.float32)).to(
        dev)[None, None]
    r["library_ms"] = events_ms(lambda: F.conv2d(xp[None, None], taps), 3)
    nnz = int(np.count_nonzero(np.asarray(w)))
    r["bound_ms"], r["bound_by"] = bound(
        2 * (m + 2 * T2D) * m * f, float(T2D) * (2 * nnz - 1) * (m - 2) ** 2)
    del xp
    for line in ptxas_lines("stencil2d_blocked"):
        log(f"  K5 ptxas: {line}")


def max_sm_ghz():
    """The card's highest SM clock in GHz (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) / 1e3


def ptxas_lines(name):
    """The registers and spills ptxas reported when it built one kernel's
    source (the template instances in order)."""
    from dr_tpu_torch.ops import kernels
    so = kernels._target(kernels.CSRC / kernels.SOURCES[name])
    p = kernels.BUILD / f"{so.stem}.ptxas.txt"
    if not p.exists():
        return ["not found"]
    return [line.strip() for line in p.read_text().splitlines()
            if "registers" in line or "spill" in line]


def bitonic_ops(M):
    """Operations of a bitonic network over M keys: M/2 compare-exchanges
    in each of log2(M) (log2(M) + 1) / 2 stages, 2 each (a min and a
    max)."""
    lg = int(math.log2(M))
    return 2.0 * (M // 2) * lg * (lg + 1) // 2


def sort_timings(gen, results):
    """Phase 8, K6 and K7: kernel, plain and library times.  K6 at the
    K6 path's blocks: 16384 keys (the row) and 2^15, keys-only and KV,
    and the K6 path's batch of 8 x 16384 in one launch; the library call
    is torch.sort of the same keys (of the packed int64 pairs for KV);
    each row also gives its one-SM floor, the compare-exchanges of one
    row at one SM's share of the fp32 rate (the floor of a design that
    gives each row one SM).  K7 at reduce's shape, 2^30 f32 in one
    segment (library torch.amin), and at n = nseg = 2^15 (library
    scatter_reduce)."""
    import torch
    from dr_tpu_torch.ops import segred_pallas as sr
    from dr_tpu_torch.ops import sort_pallas
    dev = torch.device("cuda", 0)
    one_sm = FP32_FLOP_PER_S / 132
    for b, M in ((1, K6_GEOMS[0][1]), (1, 1 << 15),
                 (K6_GEOMS[0][0], K6_GEOMS[0][1])):
        shape = (M,) if b == 1 else (b, M)
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             device=dev, dtype=torch.int32)
        gid = torch.argsort(torch.rand(shape, generator=gen, device=dev),
                            dim=-1).to(torch.int32)
        packed = (keys.long() << 32) | (gid.long() + (1 << 31))
        floor = bitonic_ops(M) / one_sm * 1e3
        row = {
            "ms": events_ms(lambda: sort_pallas.sort_keys(keys), 50),
            "plain_ms": events_ms(lambda: sort_pallas.plain_sort_keys(keys),
                                  50),
            "library_ms": events_ms(lambda: torch.sort(keys), 50)}
        row["bound_ms"], row["bound_by"] = bound(2 * b * M * 4,
                                                 b * bitonic_ops(M))
        row["one_sm_ms"] = floor
        kv = {
            "ms": events_ms(lambda: sort_pallas.sort_kv(keys, gid), 50),
            "plain_ms": events_ms(lambda: sort_pallas.plain_sort_kv(keys,
                                                                    gid), 50),
            "library_ms": events_ms(lambda: torch.sort(packed), 50)}
        kv["bound_ms"], kv["bound_by"] = bound(4 * b * M * 4,
                                               b * bitonic_ops(M))
        kv["one_sm_ms"] = floor
        log(f"  K6 {b}x{M} keys-only {json.dumps(row)}; KV {json.dumps(kv)}")
        if (b, M) == (1, K6_GEOMS[0][1]):
            results["bitonic_sort"].update(
                {k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")})
    n = 1 << 30
    x = torch.randn(n, generator=gen, device=dev)
    r = results["segred"]
    r["ms"] = events_ms(lambda: sr.segmented(None, 1, ((x, "min"),)), 10)
    r["plain_ms"] = events_ms(lambda: sr.plain_segmented(
        None, 1, ((x, "min"),)), 3)
    r["library_ms"] = events_ms(lambda: torch.amin(x), 10)
    r["bound_ms"], r["bound_by"] = bound(4 * n + 4, float(n))
    del x
    m = 1 << 15
    ids = torch.randint(0, m, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    vals = torch.randint(-1000, 1000, (m,), generator=gen, device=dev,
                         dtype=torch.int32)
    lids = ids.long()
    small = {
        "ms": events_ms(lambda: sr.segmented(ids, m, ((vals, "sum"),)), 50),
        "plain_ms": events_ms(lambda: sr.plain_segmented(
            ids, m, ((vals, "sum"),)), 50),
        "library_ms": events_ms(lambda: torch.zeros(
            m, dtype=torch.int32, device=dev).scatter_reduce_(
                0, lids, vals, "sum"), 50)}
    small["bound_ms"], small["bound_by"] = bound(m * 8 + m * 4, float(m))
    log(f"  K7 n=nseg=2^15 int32 sum {json.dumps(small)}")


# ------------------------------------------------------- ring attention

def k9_operands(gen, dev, BH, group, s, skv, d):
    """bf16 q/k/v from ``gen`` and the zero (m, l, acc) state."""
    import torch
    q = torch.randn((BH, s, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((BH // group, skv, d), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    state = (torch.full((BH, s, 1), float("-inf"), device=dev),
             torch.zeros((BH, s, 1), device=dev),
             torch.zeros((BH, s, d), device=dev))
    return q, k, v, state


def normalized(state):
    import torch
    m, l, acc = state
    return acc / torch.where(l > 0, l, 1.0)


def check_allclose(name, got, want, rtol, atol, quiet=False):
    """|got - want| <= atol + rtol |want| everywhere, both finite where
    ``want`` is; returns the max |got - want|.  ``quiet`` logs only a
    failure."""
    import torch
    assert got.shape == want.shape and got.dtype == want.dtype, name
    g, w = got.double(), want.double()
    same_inf = torch.equal(torch.isneginf(g), torch.isneginf(w))
    fin = torch.isfinite(w)
    ex = float(((g - w).abs() - (atol + rtol * w.abs()))[fin].max()) \
        if fin.any() else 0.0
    e = float((g - w).abs()[fin].max()) if fin.any() else 0.0
    ok = same_inf and bool(torch.isfinite(g[fin]).all()) and ex <= 0
    if not (ok and quiet):
        log(f"  {name}: max_abs_err={e!r} (rtol {rtol}, atol {atol}) "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: outside tolerance")
    return e


#: bf16 outputs of two orders of the same f32 math: the flash tolerance
#: (2e-3, a bf16 rounding of p may flip between the orders) plus one
#: bf16 ulp of the value (2^-7 relative) for the final rounding
BF16_OUT = dict(rtol=2e-3 + 2.0 ** -7, atol=2e-3)


def k9_close(tag, got, ref):
    """K9's state against its plain version's: m within 1e-6 (one max of
    d-term logits summed in two orders; the difference grows with d, so
    d / 256 times that above d = 256), l within 1e-5 relative (as much
    wider above d = 256), acc / l within rtol = atol = 2e-3 (a bf16
    rounding of p may flip between the orders); returns the acc / l
    error."""
    wide = max(1.0, got[2].shape[-1] / 256)
    check_allclose(f"{tag} m", got[0], ref[0], 1e-6 * wide, 1e-6 * wide,
                   quiet=True)
    check_allclose(f"{tag} l", got[1], ref[1], 1e-5 * wide, 0.0, quiet=True)
    return check_allclose(f"{tag} acc / l", normalized(got), normalized(ref),
                          2e-3, 2e-3, quiet=True)


#: phase 3's K9 shapes (s, d, group): d = 128 and 256 take the wgmma
#: kernel (s = 200 is not a multiple of its 128-row q tile), d = 768 the
#: mma.sync kernel, which stages Q and K in 6 chunks
K9_CHECKS = ((1024, 128, 4), (200, 128, 4), (384, 256, 1), (384, 256, 2),
             (256, 768, 2))


def k9_checks(gen, results, device="cuda:0"):
    """Phase 3, K9 against its plain version (:func:`k9_close`): causal
    and not, GQA, d = 128, 256 and 768, offsets (0, 0), (2s, s), (s, 2s)
    (wholly future when causal) and (s + 37, s) (the causal diagonal
    inside a tile), and a chained second update."""
    import torch
    from dr_tpu_torch.ops import flash_attention as fa
    worst = 0.0
    for s, d, group in K9_CHECKS:
        for causal in (True, False):
            for q_off, k_off in ((0, 0), (2 * s, s), (s, 2 * s),
                                 (s + 37, s)):
                tag = (f"K9 s={s} d={d} group={group} causal={causal} "
                       f"offsets=({q_off}, {k_off})")
                # the K/V block's length is a multiple of 128 (the rule)
                skv = -(-s // 128) * 128
                q, k, v, st = k9_operands(gen, device, 8, group, s, skv, d)
                got = fa.flash_update(q, k, v, *st, q_off, k_off,
                                      causal=causal)
                ref = fa.plain_flash_update(q, k, v, *st, q_off, k_off,
                                            causal=causal)
                if causal and (q_off, k_off) == (s, 2 * s):
                    check_true(f"{tag}: the state stays zero",
                               bool(torch.isneginf(got[0]).all())
                               and not bool(got[1].any())
                               and not bool(got[2].any()))
                k2, v2 = k.flip(1).contiguous(), v.flip(1).contiguous()
                got2 = fa.flash_update(q, k2, v2, *got, q_off, 0,
                                       causal=causal)
                ref2 = fa.plain_flash_update(q, k2, v2, *ref, q_off, 0,
                                             causal=causal)
                for step, g, r in ((1, got, ref), (2, got2, ref2)):
                    worst = max(worst, k9_close(f"{tag} update {step}", g, r))
    log(f"  K9 flash_update: {8 * len(K9_CHECKS)} chained pairs of updates "
        f"within tolerance (s, d, group) {K9_CHECKS}, acc / l max_abs_err "
        f"{worst!r}")
    results["flash_update"]["max_abs_err"] = worst


def flash_timings(gen, results):
    """Phase 8, K9: one update from zero state at BH = 32, s = skv =
    32768, d = 128, group 4, causal, offsets 0 (phase 12's call); the
    library call is F.scaled_dot_product_attention on the same tensors
    (GQA, causal), timed only.  At this shape the kernel's state, causal
    and not, is held against its plain version's (:func:`k9_close`)."""
    import torch
    import torch.nn.functional as F
    from dr_tpu_torch.ops import flash_attention as fa
    BH, group, s, d = RA_H, RA_H // RA_HKV, RA_S, RA_D
    q, k, v, st = k9_operands(gen, "cuda:0", BH, group, s, s, d)
    r = results["flash_update"]
    errs, lerrs = {}, {}
    for causal in (True, False):
        got = fa.flash_update(q, k, v, *st, 0, 0, causal=causal)
        ref = fa.plain_flash_update(q, k, v, *st, 0, 0, causal=causal)
        errs[causal] = k9_close(f"K9 BH={BH} s=skv={s} causal={causal}",
                                got, ref)
        lerrs[causal] = l_rel_err(got, ref)
        del got, ref
    log(f"  K9 at the timed shape vs plain (m 1e-6, l 1e-5 relative, acc / l "
        f"2e-3): acc / l max_abs_err causal {errs[True]!r}, non-causal "
        f"{errs[False]!r}; l max relative error causal {lerrs[True]!r}, "
        f"non-causal {lerrs[False]!r}")
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), *errs.values())
    r["ms"] = events_ms(lambda: fa.flash_update(q, k, v, *st, 0, 0,
                                                causal=True), 5)
    r["plain_ms"] = events_ms(lambda: fa.plain_flash_update(
        q, k, v, *st, 0, 0, causal=True), 1)
    q4, k4, v4 = (x.view(1, -1, s, d) for x in (q, k, v))
    r["library_ms"] = events_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), 5)
    ideal = 2.0 * BH * s * s * d          # the causal triangle, two products
    moved = (BH * s * d * 2 + 2 * (BH // group) * s * d * 2   # q, k, v
             + 2 * (2 * BH * s * 4 + BH * s * d * 4))          # state in, out
    r["bound_ms"], r["bound_by"] = bound(moved, ideal, BF16_TC_FLOP_PER_S)
    done = BH * fa.causal_computed_flops(s, s, d, fa.BLOCK_Q, fa.BLOCK_K)
    nc = events_ms(lambda: fa.flash_update(q, k, v, *st, 0, 0,
                                           causal=False), 3)
    log(f"  K9 causal {r['ms']!r} ms: {ideal / r['ms'] / 1e9!r} effective "
        f"TFLOP/s, {done / r['ms'] / 1e9!r} TFLOP/s of the tiles it runs; "
        f"non-causal {nc!r} ms, {2 * ideal / nc / 1e9!r} TFLOP/s; "
        f"SDPA {r['library_ms']!r} ms")
    del q, k, v, st, q4, k4, v4
    flash_timings_d256(gen)


def l_rel_err(got, ref):
    """max |l - l_ref| / l_ref over the rows that attended."""
    lg, lr = got[1].double(), ref[1].double()
    pos = lr > 0
    return float(((lg - lr).abs()[pos] / lr[pos]).max())


def flash_timings_d256(gen):
    """Phase 8, K9 at d = 256: BH = 32, s = skv = 16384, group 4, zero
    state.  The non-causal update (every row attends 16384 keys) is held
    against its plain version (:func:`k9_close`); the causal one is timed
    beside SDPA on the same tensors, logged on its own line.  (Causal at
    this size, a row attending a few keys can show one bf16 flip of p
    above acc / l's 2e-3, the mma.sync design too; phase 3 holds the causal
    d = 256 path at s = 384.)"""
    import torch.nn.functional as F
    from dr_tpu_torch.ops import flash_attention as fa
    BH, group, s, d = RA_H, RA_H // RA_HKV, RA_S // 2, 2 * RA_D
    q, k, v, st = k9_operands(gen, "cuda:0", BH, group, s, s, d)
    got = fa.flash_update(q, k, v, *st, 0, 0, causal=False)
    ref = fa.plain_flash_update(q, k, v, *st, 0, 0, causal=False)
    err = k9_close(f"K9 d={d} BH={BH} s=skv={s} causal=False", got, ref)
    lerr = l_rel_err(got, ref)
    del got, ref
    ms = events_ms(lambda: fa.flash_update(q, k, v, *st, 0, 0,
                                           causal=True), 5)
    nc = events_ms(lambda: fa.flash_update(q, k, v, *st, 0, 0,
                                           causal=False), 3)
    q4, k4, v4 = (x.view(1, -1, s, d) for x in (q, k, v))
    sdpa = events_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), 5)
    ideal = 2.0 * BH * s * s * d
    moved = (BH * s * d * 2 + 2 * (BH // group) * s * d * 2
             + 2 * (2 * BH * s * 4 + BH * s * d * 4))
    bms, by = bound(moved, ideal, BF16_TC_FLOP_PER_S)
    log(f"  K9 d={d} BH={BH} s=skv={s} group={group}: causal {ms!r} ms, "
        f"{ideal / ms / 1e9!r} effective TFLOP/s; non-causal {nc!r} ms; "
        f"SDPA causal {sdpa!r} ms; bound {bms!r} ms ({by}); non-causal "
        f"vs plain: acc / l max_abs_err {err!r}, l max relative error "
        f"{lerr!r}")


def ra_inputs(seed, S, h, hkv, d, device, dtype):
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((1, S, h, d), generator=gen, device=device).to(dtype)
    k, v = (torch.randn((1, S, hkv, d), generator=gen, device=device)
            .to(dtype) for _ in range(2))
    return q, k, v


def dense_rows(q, k, v, rows, causal):
    """float64 attention of the chosen query rows of every head (rows:
    (h, R) sequence positions), written here independently of the port;
    returns (h, R, d)."""
    import torch
    _, S, h, d = q.shape
    group = h // k.shape[2]
    outs = []
    for hh in range(h):
        qr = q[0, rows[hh], hh].double()                   # (R, d)
        kh = k[0, :, hh // group].double()
        vh = v[0, :, hh // group].double()
        logits = qr @ kh.T / math.sqrt(d)
        if causal:
            pos = torch.arange(S, device=q.device)
            logits = logits.masked_fill(pos[None, :] > rows[hh][:, None],
                                        float("-inf"))
        outs.append(torch.softmax(logits, -1) @ vh)
    return torch.stack(outs)


def check_oracle_rows(name, out, q, k, v, rows, causal, rtol, atol):
    """``out`` at the chosen rows against :func:`dense_rows`."""
    import torch
    want = dense_rows(q, k, v, rows, causal)
    got = torch.stack([out[0, rows[hh], hh].double()
                       for hh in range(out.shape[2])])
    check_allclose(f"{name} vs float64", got, want, rtol, atol)


def ring_one_rank(dt, kernels, seed, results, S=RA_S, device="cuda:0"):
    """Phase 12: ring attention on one rank, causal then non-causal;
    returns the inputs and the causal output for phase 13."""
    import torch
    cuda = torch.device(device).type == "cuda"
    dt.init([device])
    q, k, v = ra_inputs(seed + 12, S, RA_H, RA_HKV, RA_D, device,
                        torch.bfloat16)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = {c: dt.ring_attention(q, k, v, causal=c) for c in (True, False)}
    dt.fence()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    log(f"  ring attention 1 rank, S={S}: both calls {wall:.3f} s, "
        f"launches {counts}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        results["flash_update"]["launches"] = counts["flash_update"]
        if counts["flash_update"] != 2:
            raise AssertionError(f"K9 launched {counts['flash_update']} "
                                 "times for two one-rank calls, expected 2")
        log(f"  peak device memory (ring attention, 1 rank): {peak} bytes "
            f"({peak / 2 ** 30:.2f} GiB; {live} live at the start)")
        for c in (True, False):
            ms = events_ms(lambda: dt.ring_attention(q, k, v, causal=c), 3)
            flops = 2.0 * S * S * RA_H * RA_D * (1 if c else 2)
            log(f"  ring attention 1 rank causal={c}: {ms!r} ms per call, "
                f"{flops / ms / 1e9!r} effective TFLOP/s")
    gen = torch.Generator(device=device).manual_seed(seed + 13)
    rows = torch.randint(0, S, (RA_H, ORACLE_ROWS), generator=gen,
                         device=device)
    worst = 0.0
    for c in (True, False):
        assert out[c].shape == q.shape and out[c].dtype == torch.bfloat16
        with plain_versions(kernels):
            ref = dt.ring_attention(q, k, v, causal=c)
        worst = max(worst, check_allclose(
            f"ring attention 1 rank causal={c} vs plain", out[c], ref,
            **BF16_OUT))
        del ref
        # the flash math against float64 of the bf16 inputs: the
        # reference's bound (tests/test_ring_attention.py:104)
        check_oracle_rows(f"ring attention 1 rank causal={c}", out[c], q, k,
                          v, rows, c, 5e-2, 5e-3)
    if cuda:
        results["flash_update"]["max_abs_err"] = max(
            results["flash_update"].get("max_abs_err", 0.0), worst)
    return (q, k, v), out[True], peak


def ring_four_ranks(dt, kernels, seed, qkv, one_rank, device="cuda:0",
                    f32=RA_F32, ran=(RAN_S, RAN_H, RAN_ITERS)):
    """Phase 13: 4 ranks of one device: the causal call of phase 12
    (16 K9 launches, serial == pipelined), the f32 blockwise route
    against float64, ring_attention_n's rate."""
    import torch
    cuda = torch.device(device).type == "cuda"
    P = RA4_P
    dt.init(dt.get_duplicated_devices(P, [device]))
    q, k, v = qkv
    kernels.reset_counts()
    got = dt.ring_attention(q, k, v, causal=True)
    dt.fence()
    n = kernels.launches["flash_update"]
    log(f"  ring attention {P} ranks S={q.shape[1]}: K9 launches {n}")
    if cuda and n != P * P:
        raise AssertionError(f"K9 launched {n} times on {P} ranks, "
                             f"expected {P * P}")
    check_allclose(f"ring attention {P} ranks vs 1 rank", got, one_rank,
                   **BF16_OUT)
    serial = dt.ring_attention(q, k, v, causal=True, schedule="serial")
    check_equal(f"ring attention {P} ranks serial vs pipelined", serial, got)
    if cuda:
        ms = events_ms(lambda: dt.ring_attention(q, k, v, causal=True), 3)
        flops = 2.0 * q.shape[1] ** 2 * q.shape[2] * q.shape[3]
        log(f"  ring attention {P} ranks causal: {ms!r} ms per call, "
            f"{flops / ms / 1e9!r} effective TFLOP/s")
    del got, serial
    # the f32 blockwise route (TF32 off): the reference's dense bound
    S, h, hkv = f32
    fq, fk, fv = ra_inputs(seed + 14, S, h, hkv, RA_D, device, torch.float32)
    rows = torch.arange(S, device=device).expand(h, S)
    for causal in (True, False):
        full = dt.ring_attention(fq, fk, fv, causal=causal)
        chunked = dt.ring_attention(fq, fk, fv, causal=causal, q_chunk=256)
        for tag, o in (("", full), (" q_chunk=256", chunked)):
            check_oracle_rows(f"f32 ring {P} ranks S={S} h={h} hkv={hkv} "
                              f"causal={causal}{tag}", o, fq, fk, fv, rows,
                              causal, 2e-3, 2e-3)
        # the reference's chunked-vs-unchunked bound
        check_allclose(f"f32 ring causal={causal} q_chunk vs unchunked",
                       chunked, full, 2e-4, 2e-5)
    del fq, fk, fv, full, chunked
    # ring_attention_n at bench.py's shape: the rate from the difference
    # of two chain lengths (K9 launches iters * P * P)
    S, h, iters = ran
    nq, nk, nv = ra_inputs(seed + 15, S, h, h, RA_D, device, torch.bfloat16)
    secs = {}
    for it in iters:
        dt.fence()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = dt.ring_attention_n(nq, nk, nv, it, causal=True)
        dt.fence()
        secs[it] = time.perf_counter() - t0
        n = kernels.launches["flash_update"]
        if cuda and n != it * P * P:
            raise AssertionError(f"ring_attention_n({it}) launched K9 {n} "
                                 f"times, expected {it * P * P}")
        check_true(f"ring_attention_n({it}) finite, shape {tuple(out.shape)}",
                   bool(torch.isfinite(out.float()).all())
                   and out.shape == nq.shape)
    a, b = iters
    per = (secs[b] - secs[a]) / (b - a)
    flops = 2.0 * S * S * h * RA_D
    log(f"  ring_attention_n {P} ranks S={S} h={h} causal: seconds "
        f"{json.dumps(secs)}, {per * 1e3!r} ms per iteration, "
        f"{flops / per / 1e12!r} TFLOP/s (host clock)")


# ------------------------------------------------------------- relational

def k8_checks(n, gen, results, device="cuda:0"):
    """Phase 3, K8: bit for bit against its plain version (scatter_add_):
    n random ids over 1024 bins with 0/1 counts, then 2^15 bins with
    out-of-range ids on both sides, then n ids in one bin."""
    import torch
    from dr_tpu_torch.ops import hist_pallas
    dev = torch.device(device)
    worst = [0.0]
    for bins, lo, hi in ((K8_BINS, 0, K8_BINS), (1 << 15, -3, (1 << 15) + 3),
                         (1, 0, 1)):
        ids = torch.randint(lo, hi, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        cnt = torch.randint(0, 2, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        check_bits(f"K8 bins={bins} n={n}", hist_pallas.bincount(ids, cnt, bins),
                   hist_pallas.plain_bincount(ids, cnt, bins), worst)
        del ids, cnt
    log(f"  K8 hist: bit-exact ok at 1024, 2^15 and 1 bins, n={n}")
    results["hist"]["max_abs_err"] = worst[0]


def hist_timings(gen, results):
    """Phase 8, K8: 2^30 random int32 ids over 1024 bins, counts all
    one (so torch.bincount, the library call, computes the same
    function): kernel, plain and library times; the bound reads the ids
    and counts once and writes the bins."""
    import torch
    from dr_tpu_torch.ops import hist_pallas
    dev = torch.device("cuda", 0)
    n, bins = 1 << 30, K8_BINS
    ids = torch.randint(0, bins, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    check_true("K8 equals torch.bincount", torch.equal(
        hist_pallas.bincount(ids, ones, bins),
        torch.bincount(ids, minlength=bins).to(torch.int32)))
    r = results["hist"]
    r["ms"] = events_ms(lambda: hist_pallas.bincount(ids, ones, bins), 10)
    r["plain_ms"] = events_ms(lambda: hist_pallas.plain_bincount(
        ids, ones, bins), 3)
    r["library_ms"] = events_ms(lambda: torch.bincount(ids, minlength=bins),
                                10)
    r["bound_ms"], r["bound_by"] = bound(8 * n + 4 * bins, float(n))
    # few bins: 16 addresses for every warp's shared atomics (phase 14's
    # 16-bin histogram of the joined values)
    few, m = ids[:1 << 26] % 16, 1 << 26
    row = {"ms": events_ms(lambda: hist_pallas.bincount(few, ones[:m], 16),
                           10),
           "library_ms": events_ms(lambda: torch.bincount(few, minlength=16),
                                   10),
           "bound_ms": bound(8 * m + 64, float(m))[0]}
    log(f"  K8 n=2^26 bins=16: {json.dumps(row)}")
    del few
    log(f"  K8 n=2^30 bins={bins}: {json.dumps({k: r[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms')})}")


def relational_data(n_fact, ncard, seed, dev, shift=0):
    """The bench's pipeline data (bench.py:910-931) on the card: f32 fact
    keys over ``ncard`` keys (fan-in n_fact / ncard), N(0,1) fact values,
    a permuted one-row-per-key dimension table (keys ``shift`` up)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    fk = torch.randint(0, ncard, (n_fact,), generator=gen,
                       device=dev).float()
    fv = torch.randn(n_fact, generator=gen, device=dev)
    dk = (torch.randperm(ncard, generator=gen, device=dev) + shift).float()
    dv = torch.randn(ncard, generator=gen, device=dev)
    return fk, fv, dk, dv


def relational_path(dt, data, times):
    """join -> groupby sum over the joined rows -> top_k 8 of the groups,
    then a 16-bin histogram of the joined values over [-3, 3]
    (bench.py:933-961, 1012-1014) on the current runtime."""
    step = stepper(dt, times)
    fk, fv, dk, dv = data
    n_fact = fk.numel()
    with step("data"):
        F, FV, D, DV = (dt.distributed_vector.from_array(a) for a in data)
        cap = 2 * n_fact  # dim keys are unique: <= 1 match per fact row
        jk, jl, jr, gk, gv = (dt.distributed_vector(cap) for _ in range(5))
        tv = dt.distributed_vector(8)
        ti = dt.distributed_vector(8, np.int32)
        hb = dt.distributed_vector(16, np.int32)
    with step("join"):
        m = dt.join(F, FV, D, DV, jk, jl, jr)
    with step("groupby"):
        ng = dt.groupby_aggregate(jk[0:m], jl[0:m], gk, gv, agg="sum")
    with step("top_k"):
        dt.top_k(gv[0:ng], tv, ti)
    with step("histogram"):
        dt.histogram(jl[0:m], hb, -3.0, 3.0)
    return {"m": m, "ng": ng, "jk": jk.to_array()[:m],
            "jl": jl.to_array()[:m], "jr": jr.to_array()[:m],
            "gk": gk.to_array()[:ng], "gv": gv.to_array()[:ng],
            "tv": tv.to_array(), "ti": ti.to_array(), "hb": hb.to_array()}


def hist_oracle(x, bins, lo, hi):
    """numpy's bucket rule in f32 torch ops (right edge in the last
    bucket, out-of-range dropped), counted by torch.bincount.  The edges
    are f32 tensors on the card: divided by a Python scalar, torch's
    CUDA division multiplies by the reciprocal, which rounds otherwise."""
    import torch
    lo, hi = (torch.tensor(v, device=x.device) for v in (lo, hi))
    inr = (x >= lo) & (x <= hi)
    b = torch.floor((x[inr] - lo) * bins / (hi - lo)).long().clamp(
        max=bins - 1)
    return torch.bincount(b, minlength=bins).to(torch.int32)


def join_oracle(data, fill=None):
    """Rows of join(fact, dim) ordered by (key, source, position), built
    from torch ops alone: every fact row (its dimension value, or
    ``fill`` where the key has none), and under ``fill`` (an outer join)
    the unmatched dimension rows after them in key order."""
    import torch
    fk, fv, dk, dv = data
    top = int(max(fk.max(), dk.max())) + 1
    dv_by = torch.zeros(top, device=fk.device)
    has = torch.zeros(top, dtype=torch.bool, device=fk.device)
    dv_by[dk.long()] = dv
    has[dk.long()] = True
    if fill is None:
        keys, lv, rv = fk, fv, dv_by[fk.long()]
    else:
        present = torch.zeros(top, dtype=torch.bool, device=fk.device)
        present[fk.long()] = True
        ru = ~present[dk.long()]
        keys = torch.cat([fk, dk[ru]])
        lv = torch.cat([fv, torch.full_like(dv[ru], fill)])
        rv = torch.cat([torch.where(has[fk.long()], dv_by[fk.long()], fill),
                        dv[ru]])
    order = torch.sort(keys, stable=True).indices
    return keys[order], lv[order], rv[order]


def check_relational(tag, data, out):
    """The pipeline's results against oracles independent of the port:
    joined rows bit for bit, groups and counts bit for bit, each group's
    f32 sum within the recursive-summation bound (count * 2^-24 * the
    sum of |values|) of its float64 sum, top_k's indices equal to a
    stable descending sort of the groups' sums (and to the float64
    sums' top 8), the histogram bit for bit."""
    import torch
    fk, fv, dk, dv = data
    check_true(f"{tag} join count", out["m"] == fk.numel())
    for name, got, want in zip(("keys", "left", "right"),
                               (out["jk"], out["jl"], out["jr"]),
                               join_oracle(data)):
        check_true(f"{tag} join {name} (bits)", torch.equal(
            got.view(torch.int32), want.view(torch.int32)))
    uk, inv, cnt = torch.unique(fk, return_inverse=True, return_counts=True)
    check_true(f"{tag} groupby count", out["ng"] == uk.numel())
    check_true(f"{tag} groupby keys (bits)", torch.equal(out["gk"], uk))
    s64 = torch.zeros(uk.numel(), dtype=torch.float64,
                      device=fk.device).index_add_(0, inv, fv.double())
    a64 = torch.zeros_like(s64).index_add_(0, inv, fv.double().abs())
    err = (out["gv"].double() - s64).abs()
    tol = cnt.double() * 2.0 ** -24 * a64 + 1e-30
    check_true(f"{tag} groupby sums within count * 2^-24 * sum|v| "
               f"(max err {float(err.max())!r})", bool((err <= tol).all()))
    idx = torch.sort(out["gv"], descending=True, stable=True).indices[:8]
    check_true(f"{tag} top_k indices (bits)", torch.equal(
        out["ti"], idx.to(torch.int32)))
    check_true(f"{tag} top_k values (bits)",
               torch.equal(out["tv"], out["gv"][idx]))
    check_true(f"{tag} top_k vs float64 sums' top 8", torch.equal(
        torch.sort(s64, descending=True, stable=True).indices[:8], idx))
    check_true(f"{tag} histogram (bits)",
               torch.equal(out["hb"], hist_oracle(fv, 16, -3.0, 3.0)))


def relational_geometry(dt, ranks, seed, kernels, device="cuda:0"):
    """The bench's kernel geometry (bench.py:1029-1051): 8192 int32 keys
    in [0, 512) a rank with int32 values, groupby sum (K6 sorts the
    ranks' blocks in one batch, K7 reduces each rank's once) and a
    256-bin histogram over [-4, 4] (K8 once a rank), against numpy.  A
    CPU rehearsal launches nothing."""
    import torch
    dt.init(dt.get_duplicated_devices(ranks, [device]))
    want = ranks if torch.device(device).type == "cuda" else 0
    rng = np.random.default_rng(seed)
    nk = 8192 * ranks
    keys = rng.integers(0, 512, nk).astype(np.int32)
    vals = rng.integers(0, 99, nk).astype(np.int32)
    hv = rng.standard_normal(nk).astype(np.float32)
    gk, gv, hvv = (dt.distributed_vector.from_array(a)
                   for a in (keys, vals, hv))
    ok = dt.distributed_vector(1024, np.int32)
    ov = dt.distributed_vector(1024, np.int32)
    hb = dt.distributed_vector(256, np.int32)
    dt.fence()
    before = dict(kernels.launches)
    ng = dt.groupby_aggregate(gk, gv, ok, ov, agg="sum")
    dt.histogram(hvv, hb, -4.0, 4.0)
    dt.fence()
    got = {k: kernels.launches[k] - before[k] for k in before}
    log(f"  kernel geometry {ranks} x 8192: launches {got}")
    wants = {"segred": want, "hist": want, "bitonic_sort": min(want, 1)}
    for k, w in wants.items():
        if got[k] != w:
            raise AssertionError(f"{k} launched {got[k]} times at the "
                                 f"kernel geometry, expected {w}")
    uk, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv, weights=vals).astype(np.int32)
    check_true(f"geometry {ranks} ranks groupby vs numpy", ng == len(uk)
               and np.array_equal(dt.to_numpy(ok)[:ng], uk)
               and np.array_equal(dt.to_numpy(ov)[:ng], sums))
    x = hv[(hv >= -4.0) & (hv <= 4.0)]
    b = np.minimum(np.floor((x - np.float32(-4.0)) * np.float32(256)
                            / np.float32(8.0)).astype(np.int64), 255)
    check_true(f"geometry {ranks} ranks histogram vs numpy",
               np.array_equal(dt.to_numpy(hb), np.bincount(b, minlength=256)))


def relational_one_rank(dt, kernels, seed, results, device="cuda:0",
                        sizes=(REL_FACT_LOG2, REL_CARD_LOG2, 30)):
    """Phase 14: the pipeline at n_fact = 2^26 over 2^22 keys (timed on
    its second run), a 1024-bin
    histogram of 2^30 f32 normals over [-4, 4], and the kernel geometry,
    on one rank; returns the peak device memory.  ``sizes`` (the log2 of
    n_fact, of ncard and of the histogram's length) and ``device="cpu"``
    rehearse it on the CPU."""
    import torch
    cuda = torch.device(device).type == "cuda"
    dt.init([device])
    n_fact, ncard = 1 << sizes[0], 1 << sizes[1]
    data = relational_data(n_fact, ncard, seed + 14, device)
    # one warm run, as bench.py's: the first launch of each of torch's
    # kernels loads its module
    relational_path(dt, data, {})
    release(torch)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    times = {}
    t0 = time.perf_counter()
    out = relational_path(dt, data, times)
    step = stepper(dt, times)
    with step("data"):
        x = torch.randn(1 << sizes[2], generator=torch.Generator(
            device=device).manual_seed(seed + 15), device=device)
        hx = dt.distributed_vector.from_array(x)
        hb = dt.distributed_vector(K8_BINS, np.int32)
    with step("histogram 2^30"):
        dt.histogram(hx, hb, -4.0, 4.0)
    counts = dict(kernels.launches)
    log(f"  relational path {time.perf_counter() - t0:.2f} s, launches "
        f"{counts}")
    log("  relational path seconds by step: " + json.dumps(times))
    stages = times["join"] + times["groupby"] + times["top_k"]
    log(f"  pipeline {stages * 1e3!r} ms for {n_fact} fact rows: "
        f"{n_fact / stages!r} rows/s; joined {out['m']}, groups {out['ng']}")
    if counts["segred"] != 0 or counts["hist"] != 2 * cuda:
        raise AssertionError(
            f"relational path launched K7 {counts['segred']} times "
            f"(expected 0: 2^26 scratch keys a rank are above its cap) "
            f"and K8 {counts['hist']} (expected 2, one a histogram)")
    check_relational("1 rank", data, out)
    check_true(f"histogram 2^{sizes[2]} (bits)", torch.equal(
        hb.to_array(), hist_oracle(x, K8_BINS, -4.0, 4.0)))
    del out, data, x, hx, hb
    release(torch)
    relational_geometry(dt, 1, seed, kernels, device)
    results["hist"]["launches"] = kernels.launches["hist"]
    return torch.cuda.max_memory_allocated() if cuda else 0


@contextlib.contextmanager
def broadcast_max(value):
    saved = os.environ.get("DR_GPU_JOIN_BROADCAST_MAX")
    os.environ["DR_GPU_JOIN_BROADCAST_MAX"] = str(value)
    try:
        yield
    finally:
        if saved is None:
            del os.environ["DR_GPU_JOIN_BROADCAST_MAX"]
        else:
            os.environ["DR_GPU_JOIN_BROADCAST_MAX"] = saved


def join_both_routes(dt, data, how, fill, tag):
    """One join on the default route (partition: more than 2^18 rows on
    4 ranks) and on the forced broadcast route: equal bit for bit;
    returns the rows and the two routes."""
    import torch
    from dr_tpu_torch.algorithms import relational as rel
    res = []
    for forced in (False, True):
        F, FV, D, DV = (dt.distributed_vector.from_array(a) for a in data)
        cap = 2 * (data[0].numel() + data[2].numel())
        outs = [dt.distributed_vector(cap) for _ in range(3)]
        with contextlib.ExitStack() as st:
            if forced:
                st.enter_context(broadcast_max(1 << 30))
            dt.fence()
            t0 = time.perf_counter()
            m = dt.join(F, FV, D, DV, *outs, how=how, fill=fill)
            dt.fence()
            secs = time.perf_counter() - t0
        route = rel.last_join_route()
        log(f"  {tag} {how} join {route['impl']}: {secs * 1e3!r} ms, "
            f"route {json.dumps(route)}")
        res.append((m, [o.to_array()[:m].view(torch.int32) for o in outs],
                    route))
    (m0, rows0, r0), (m1, rows1, r1) = res
    if r0["impl"] != "partition" or r1["impl"] != "broadcast":
        raise AssertionError(f"{tag}: routes {r0['impl']}, {r1['impl']}")
    check_true(f"{tag} {how}: partition gathers fewer rows a device than "
               "broadcast", r0["gathered_rows_per_device"]
               < r1["gathered_rows_per_device"])
    check_true(f"{tag} {how}: partition equals broadcast (bits)", m0 == m1
               and all(a.equal(b) for a, b in zip(rows0, rows1)))
    return m0, rows0


def relational_four_ranks(dt, kernels, seed, device="cuda:0",
                          fact_log2=REL4_FACT_LOG2):
    """Phase 15: 4 ranks of one card at n_fact = 2^24 over 2^20 keys: the
    pipeline (partition join), the join on both routes, an outer join
    with keys missing on both sides on both routes, and the kernel
    geometry."""
    import torch
    dt.init(dt.get_duplicated_devices(4, [device]))
    n_fact, ncard = 1 << fact_log2, 1 << (fact_log2 - 4)
    data = relational_data(n_fact, ncard, seed + 16, device)
    times = {}
    out = relational_path(dt, data, times)
    log("  4-rank relational path seconds by step: " + json.dumps(times))
    check_relational("4 ranks", data, out)
    del out
    join_both_routes(dt, data, "inner", 0, "4 ranks")
    # dimension keys shifted up by ncard / 2: fact keys below it and
    # dimension keys above the fact range have no partner
    odata = relational_data(n_fact, ncard, seed + 17, device,
                            shift=ncard // 2)
    m, rows = join_both_routes(dt, odata, "outer", -1.0, "4 ranks")
    want = join_oracle(odata, fill=-1.0)
    check_true("4 ranks outer join count", m == want[0].numel())
    for name, got, w in zip(("keys", "left", "right"), rows, want):
        check_true(f"4 ranks outer join {name} vs oracle (bits)",
                   torch.equal(got, w.view(torch.int32)))
    del data, odata, rows, want
    release(torch)
    relational_geometry(dt, 4, seed, kernels, device)


# ---------------------------------------------------- entry and dryrun

def entry_phase(dt, kernels, device="cuda:0"):
    """Phase 16: ``entry()``'s step and masked sum on the card against the
    same step on the CPU, on its own input and on random rows; then
    ``dryrun(4)`` on 4 ranks of the card with the launch counts read
    around it.  Returns the counts."""
    import torch
    from dr_tpu_torch import entry as E
    gen = torch.Generator().manual_seed(16)
    fn_c, args_c = E.entry("cpu")
    fn, args = E.entry(device)
    width = args[0][0].shape[1]
    rand = [torch.randn((1, width), generator=gen) for _ in range(2)]
    for tag, a_c, b_c in (("", *args_c), (" random rows", [rand[0]],
                                           [rand[1]])):
        out_c, sum_c = fn_c(a_c, b_c)
        if tag:
            a_d, b_d = [rand[0].to(device)], [rand[1].to(device)]
        else:
            a_d, b_d = args
        out, total = fn(a_d, b_d)
        scale = float(out_c[0].abs().max())
        # the same separately rounded products and sums on both sides
        check(f"entry step{tag} vs CPU", max_err(out[0].cpu(), out_c[0]),
              1e-6 * scale)
        # f32 sums of 2^16 cells in two orders
        check(f"entry masked sum{tag} vs CPU", abs(float(total)
                                                  - float(sum_c)),
              1e-5 * float(out_c[0].abs().sum()))
    dt.final()
    kernels.reset_counts()
    t0 = time.perf_counter()
    E.dryrun(4, [device])
    counts = dict(kernels.launches)
    log(f"  dryrun(4) {time.perf_counter() - t0:.2f} s, launches {counts}")
    for names in (("stencil_matmul",), ("chunked_dot",), ("chunked_cumsum",),
                  ("bitonic_sort", "segred"), ("flash_update",)):
        if sum(counts[k] for k in names) <= 0:
            raise AssertionError(f"dryrun launched no {'/'.join(names)}")
    return counts


# --------------------------------------------------- halo p50 and GB/s

def halo_p50(dt, ranks, device="cuda:0", cells=HALO_CELLS):
    """Phase 17: bench.py's halo-exchange p50 (``bench.py:552-573``): a
    periodic ``halo_bounds(1024, 1024)`` vector of ``cells`` a rank,
    timed calls of ``exchange_n(64)``, 4 calls a batch, 5 batches, by
    CUDA events; returns the median microseconds per exchange.  The
    ghosts are then checked against their owners."""
    import torch
    dt.init(dt.get_duplicated_devices(ranks, [device]))
    n = ranks * cells
    v = dt.distributed_vector(n, np.float32, halo=dt.halo_bounds(
        HALO_W, HALO_W, periodic=True))
    dt.iota(v, 0)
    h = v.halo()
    h.exchange_n(HALO_ROUNDS)  # warm
    torch.cuda.synchronize()
    per = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(4):
            h.exchange_n(HALO_ROUNDS)
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) * 1e3 / (4 * HALO_ROUNDS))
    for r, row in enumerate(v.rows):
        left = ((r - 1) % ranks) * cells + cells - HALO_W
        right = ((r + 1) % ranks) * cells
        want = torch.cat([torch.arange(left, left + HALO_W),
                          torch.arange(r * cells, (r + 1) * cells),
                          torch.arange(right, right + HALO_W)]).float()
        check(f"halo {ranks} ranks rank {r} ghosts",
              max_err(row[0].cpu(), want), 0.0)
    del v, h
    return float(np.median(per)), per


def gbps_lines(n, steps4, results):
    """GB/s/chip of phase 4's steps and phase 8's kernel times, bytes
    counted as bench.py counts them: effective ``2*n*4*steps`` and
    physical ``2*n*4*passes`` for the 1-D stencils
    (``bench.py:261-268``), ``2*n*4`` a dot (``:519``) and a scan."""
    f = 4
    out = {}
    for step, kern, block in (("stencil_iterate_matmul", "stencil_matmul",
                               K_BLOCK),
                              ("stencil_iterate_blocked", "stencil_blocked",
                               T_BLOCK)):
        t = steps4[step]
        passes = -(-STEPS // block)
        out[step] = {
            "seconds": t,
            "effective_gbps": 2.0 * n * f * STEPS / t / 1e9,
            "physical_gbps": 2.0 * n * f * passes / t / 1e9,
            "kernel_physical_gbps": 2.0 * n * f / (results[kern]["ms"]
                                                   * 1e-3) / 1e9}
    t = steps4["dot_n"]
    out["dot_n"] = {"seconds": t,
                    "gbps": 2.0 * n * f * DOT_ROUNDS / t / 1e9,
                    "kernel_gbps": 2.0 * n * f / (
                        results["chunked_dot"]["ms"] * 1e-3) / 1e9}
    t = steps4["inclusive_scan"]
    out["inclusive_scan"] = {"seconds": t, "gbps": 2.0 * n * f / t / 1e9,
                             "kernel_gbps": 2.0 * n * f / (
                                 results["chunked_cumsum"]["ms"] * 1e-3)
                             / 1e9}
    return out


# ------------------------------------------------------------ sparse

def config5_coo(m, k=SP_K, seed=0):
    """bench.py's config 5 pattern (``bench.py:767-800``): ``k`` random
    columns a row from ``default_rng(seed)``, f32 normal values; rows
    sorted, so the host CSR is (indptr, cols, values) directly."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m, dtype=np.int64), k)
    cols = rng.integers(0, m, size=m * k)
    vals = rng.standard_normal(m * k).astype(np.float32)
    return rows, cols, vals, np.arange(0, m * k + 1, k, dtype=np.int64)


def banded_coo(m, half, seed=1):
    """bench.py's banded BCSR case (``bench.py:879-902``): rows of
    ``2*half+1`` f32 normal values around the diagonal."""
    rng = np.random.default_rng(seed)
    ii = np.repeat(np.arange(m, dtype=np.int64), 2 * half + 1)
    jj = ii + np.tile(np.arange(-half, half + 1), m)
    keep = (jj >= 0) & (jj < m)
    ii, jj = ii[keep], jj[keep]
    vals = rng.standard_normal(len(ii)).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(ii, minlength=m))])
    return ii, jj, vals, indptr


def host_csr(shape, cols, vals, indptr):
    """The float64 scipy matrix and its absolute value."""
    import scipy.sparse as sps
    S = sps.csr_matrix((vals.astype(np.float64), cols, indptr), shape=shape)
    return S, abs(S)


def check_rows(name, got, S, absS, b):
    """Each row within 1e-5 * (|A|·|b|)_i + 1e-6 of the float64 product
    (f32 sums of the row's products in some order)."""
    got = np.asarray(got, dtype=np.float64)
    ref = S @ b.astype(np.float64)
    tol = 1e-5 * (absS @ np.abs(b).astype(np.float64)) + 1e-6
    err = np.abs(got - ref)
    worst = float((err / tol).max())
    log(f"  {name}: max_abs_err={float(err.max())!r} worst err/tol="
        f"{worst!r} {'ok' if worst <= 1 else 'FAIL'}")
    if not worst <= 1:
        raise AssertionError(f"{name}: rows off the float64 product")


def gemv_twice(dt, A, b, m, fmt=None):
    """c = A·b twice from zero (``fmt`` forces a layout); both results on
    the host, which must be the same bits."""
    import importlib
    tg = importlib.import_module("dr_tpu_torch.algorithms.gemv")
    outs = []
    for _ in range(2):
        c = dt.distributed_vector(m)
        if fmt is None:
            dt.gemv(c, A, b)
        else:
            tg._gemv_as(c, A, b, fmt)
        outs.append(c.to_array().cpu())
    if not torch_equal(outs[0], outs[1]):
        raise AssertionError("gemv gave other bits on a second call")
    return outs[0].numpy()


def torch_equal(a, b):
    import torch
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def marginal_ms(run, r1=2, r2=18, samples=3):
    """Milliseconds a round from ``run(r2)`` minus ``run(r1)`` by CUDA
    events (bench.py's marginal: the per-call constant cancels); the
    median of ``samples``."""
    import torch
    run(r1)
    torch.cuda.synchronize()
    vals = []
    for _ in range(samples):
        ts = []
        for r in (r1, r2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(r)
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
        vals.append((ts[1] - ts[0]) / (r2 - r1))
    return float(np.median(vals))


def sparse_one_rank(dt, seed, m_log2=SP_LOG2, mb_log2=SPB_LOG2,
                    timed=True):
    """Phase 18: config 5's pattern at 2^m_log2 rows on one rank: the
    autoselected format (ELL), gemv against float64 scipy and the same
    bits twice, gemv_n GFLOP/s beside the bytes bound and cuSPARSE, spmm
    nv = 8, and the banded BCSR case at 2^mb_log2 rows.  Returns the
    numbers printed."""
    import torch
    import importlib
    tg = importlib.import_module("dr_tpu_torch.algorithms.gemv")
    dev = dt.devices()[0]
    out = {}
    m = 1 << m_log2
    t0 = time.perf_counter()
    rows, cols, vals, indptr = config5_coo(m)
    nnz = len(vals)
    out["host_data_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = dt.sparse_matrix.from_coo((m, m), rows, cols, vals)
    fmt = tg.resolved_format(A)
    dt.fence()
    out["build_s"] = time.perf_counter() - t0
    log(f"  m=2^{m_log2} nnz={nnz}: host data {out['host_data_s']:.2f} s, "
        f"card build + ELL layout {out['build_s']:.2f} s, format {A.format}"
        f" -> {fmt}")
    if A.format != "ell" or fmt != "ell":
        raise AssertionError(f"config 5 took {A.format}/{fmt}, not ell")
    S, absS = host_csr((m, m), cols, vals, indptr)
    del rows
    b = np.random.default_rng(seed).standard_normal(m).astype(np.float32)
    check_rows("gemv (ell) vs float64 scipy", gemv_twice(dt, A, b, m),
               S, absS, b)
    B = np.random.default_rng(seed + 1).standard_normal(
        (m, SP_NV)).astype(np.float32)
    Y = dt.spmm(A, B)
    check_rows(f"spmm nv={SP_NV} (ell) vs float64 scipy", Y.cpu().numpy(),
               S, absS, B)
    del Y
    if timed:
        bv = dt.distributed_vector.from_array(torch.from_numpy(b).to(dev))
        c = dt.distributed_vector(m)
        ms = marginal_ms(lambda r: tg.gemv_n(c, A, bv, r))
        out["gemv_ms"] = ms
        out["gemv_gflops"] = 2.0 * nnz / (ms * 1e-3) / 1e9
        out["bound_ms"] = (nnz * 8 + m * 12) / HBM_BYTES_PER_S * 1e3
        Bd = torch.from_numpy(B).to(dev)
        ms = marginal_ms(lambda r: tg.spmm_n(A, Bd, r))
        out["spmm8_ms"] = ms
        out["spmm8_gflops"] = 2.0 * nnz * SP_NV / (ms * 1e-3) / 1e9
        # one cuSPARSE call computing the same product (columns sorted
        # within rows, as its CSR wants; never called by the port)
        key = torch.from_numpy(np.repeat(np.arange(m, dtype=np.int64),
                                         SP_K) * m + cols).to(dev)
        order = torch.sort(key).indices
        col_d = (key[order] % m).to(torch.int32)
        del key
        vals_d = torch.from_numpy(vals).to(dev)[order]
        del order
        crow = torch.from_numpy(indptr.astype(np.int32)).to(dev)
        Acsr = torch.sparse_csr_tensor(crow, col_d, vals_d, size=(m, m))
        bd = torch.from_numpy(b).to(dev)
        check_rows("cuSPARSE vs float64 scipy", (Acsr @ bd).cpu().numpy(),
                   S, absS, b)
        out["cusparse_ms"] = events_ms(lambda: Acsr @ bd, 20)
        log(f"  gemv_n {out['gemv_ms']!r} ms a round, "
            f"{out['gemv_gflops']!r} GFLOP/s, bound {out['bound_ms']!r} ms "
            f"(nnz*8 + m*12 bytes); cuSPARSE (torch.sparse_csr_tensor @ b) "
            f"{out['cusparse_ms']!r} ms; spmm_n nv={SP_NV} "
            f"{out['spmm8_ms']!r} ms a round, {out['spmm8_gflops']!r} "
            f"GFLOP/s")
        del Acsr, crow, col_d, vals_d, bv, c, Bd, bd
    del A, S, absS, cols, vals, B
    gc.collect()

    # the banded case: block structure takes BCSR
    mb = 1 << mb_log2
    rows, cols, vals, indptr = banded_coo(mb, SPB_HALF)
    nnzb = len(vals)
    Ab = dt.sparse_matrix.from_coo((mb, mb), rows, cols, vals)
    fmt = tg.resolved_format(Ab)
    log(f"  banded m=2^{mb_log2} half-band {SPB_HALF} nnz={nnzb}: format "
        f"{Ab.format} -> {fmt}, kb={Ab._bcsr_kb}")
    if Ab.format != "bcsr" or fmt != "bcsr":
        raise AssertionError(f"banded matrix took {Ab.format}/{fmt}")
    S, absS = host_csr((mb, mb), cols, vals, indptr)
    bb = np.random.default_rng(seed + 2).standard_normal(mb).astype(
        np.float32)
    check_rows("banded gemv (bcsr) vs float64 scipy",
               gemv_twice(dt, Ab, bb, mb), S, absS, bb)
    if timed:
        bv = dt.distributed_vector.from_array(torch.from_numpy(bb).to(dev))
        c = dt.distributed_vector(mb)
        ms = marginal_ms(lambda r: tg.gemv_n(c, Ab, bv, r))
        out["bcsr_ms"] = ms
        out["bcsr_gflops"] = 2.0 * nnzb / (ms * 1e-3) / 1e9
        out["bcsr_bound_ms"] = (nnzb * 8 + mb * 12) / HBM_BYTES_PER_S * 1e3
        log(f"  banded gemv_n {ms!r} ms a round, {out['bcsr_gflops']!r} "
            f"GFLOP/s, bound {out['bcsr_bound_ms']!r} ms")
    return out


def sparse_four_ranks(dt, seed, device="cuda:0", m_log2=SP4_LOG2,
                      half=SP4_HALF):
    """Phase 19: 4 ranks of the card at 2^m_log2 rows against float64
    scipy: row tiles (ELL), the ring layout with serial equal to
    pipelined bit for bit, a 2x2 block-cyclic grid, the banded matrix on
    the grid (BCSR), a skewed matrix (one dense row: csr) and spmm on
    the grid."""
    import os
    dt.init(dt.get_duplicated_devices(4, [device]))
    m = 1 << m_log2
    rows, cols, vals, indptr = config5_coo(m, seed=seed)
    S, absS = host_csr((m, m), cols, vals, indptr)
    b = np.random.default_rng(seed + 3).standard_normal(m).astype(np.float32)
    A = dt.sparse_matrix.from_coo((m, m), rows, cols, vals)
    log(f"  row tiles: format {A.format}, ring viable {A.ensure_ring()}")
    if A.format != "ell" or not A.ensure_ring():
        raise AssertionError("config 5 on 4 ranks must be ell, ring-viable")
    check_rows("4 ranks gemv (ell) vs float64 scipy",
               gemv_twice(dt, A, b, m), S, absS, b)
    ring = {}
    saved = os.environ.get("DR_GPU_RING_SCHEDULE")
    try:
        for sched in ("serial", "pipelined"):
            os.environ["DR_GPU_RING_SCHEDULE"] = sched
            ring[sched] = gemv_twice(dt, A, b, m, fmt="ring")
    finally:
        if saved is None:
            os.environ.pop("DR_GPU_RING_SCHEDULE", None)
        else:
            os.environ["DR_GPU_RING_SCHEDULE"] = saved
    check_rows("4 ranks gemv (ring) vs float64 scipy", ring["serial"], S,
               absS, b)
    check_true("4 ranks ring serial == pipelined, bit for bit",
               np.array_equal(ring["serial"].view(np.int32),
                              ring["pipelined"].view(np.int32)))
    del A
    grid = dt.block_cyclic(grid=(2, 2))
    G = dt.sparse_matrix.from_coo((m, m), rows, cols, vals, partition=grid)
    log(f"  2x2 grid: format {G.format}")
    check_rows("2x2 grid gemv vs float64 scipy", gemv_twice(dt, G, b, m), S,
               absS, b)
    B = np.random.default_rng(seed + 4).standard_normal(
        (m, SP_NV)).astype(np.float32)
    check_rows(f"2x2 grid spmm nv={SP_NV} vs float64 scipy",
               dt.spmm(G, B).cpu().numpy(), S, absS, B)
    del G, S, absS, rows, cols, vals
    gc.collect()
    rows, cols, vals, indptr = banded_coo(m, half, seed=seed + 5)
    S, absS = host_csr((m, m), cols, vals, indptr)
    Gb = dt.sparse_matrix.from_coo((m, m), rows, cols, vals, partition=grid)
    log(f"  banded 2x2 grid (half-band {half}): format {Gb.format}")
    if Gb.format != "bcsr":
        raise AssertionError(f"banded grid took {Gb.format}")
    check_rows("2x2 grid banded gemv (bcsr) vs float64 scipy",
               gemv_twice(dt, Gb, b, m), S, absS, b)
    del Gb, S, absS, rows, cols, vals
    # one dense row defeats the ELL padding gate: csr
    rng = np.random.default_rng(seed + 6)
    rows = np.concatenate([np.zeros(m, np.int64),
                           np.repeat(np.arange(m, dtype=np.int64), 4)])
    cols = np.concatenate([np.arange(m), rng.integers(0, m, 4 * m)])
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    import scipy.sparse as sps
    S = sps.csr_matrix((vals.astype(np.float64), (rows, cols)),
                       shape=(m, m))
    K = dt.sparse_matrix.from_coo((m, m), rows, cols, vals)
    log(f"  skewed (one dense row): format {K.format}")
    if K.format != "csr":
        raise AssertionError(f"skewed matrix took {K.format}")
    check_rows("4 ranks skewed gemv (csr) vs float64 scipy",
               gemv_twice(dt, K, b, m), S, abs(S), b)


# -------------------------------------- re-layout, halo and checkpoint

def rows_equal(a, b):
    """The rank rows of two f32 vectors, bit for bit."""
    return len(a.rows) == len(b.rows) and all(
        torch_equal(x, y) for x, y in zip(a.rows, b.rows))


def host_ms(run, iters, fence):
    """Milliseconds a call of ``run`` by the host clock, ``fence()``
    before and after, after one warm-up call."""
    run()
    fence()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    fence()
    return (time.perf_counter() - t0) / iters * 1e3


def redistribute_phase(dt, seed, device="cuda:0", log2=RDX_LOG2,
                       halo_log2=RDX_HALO_LOG2, timed=True):
    """Phase 20 (a): bench.py's redistribute configuration on 4 ranks:
    every hop's rows equal between the collective and the host-staged
    route, the value the source's, bit for bit; then both routes' GB/s
    by bench.py's count, and a halo vector moved and exchanged."""
    import torch
    from dr_tpu_torch.parallel import redistribute as rdx
    from dr_tpu_torch.parallel.runtime import Runtime
    rt = dt.init(dt.get_duplicated_devices(4, [device]))
    P, n = 4, 1 << log2
    gen = torch.Generator(device=device).manual_seed(seed + 20)
    src = torch.randn(n, generator=gen, device=device)
    base = n // P
    rot = [base // 2, base, base, n - base // 2 - 2 * base]
    cuts = np.sort(np.random.default_rng(seed + 20).integers(0, n + 1, P - 1))
    uneven = [int(b - a) for a, b in zip(np.r_[0, cuts], np.r_[cuts, n])]
    va = dt.distributed_vector.from_array(src)
    vb = dt.distributed_vector.from_array(src)
    for tag, d in (("the rotated cut", rot), ("even", None),
                   ("a team on rank 2", [0, 0, n, 0]),
                   (f"a seeded uneven cut {uneven}", uneven),
                   ("even", None)):
        rdx._collective(va, d, rt)
        rdx._host_staged(vb, d, rt)
        check_true(f"redistribute to {tag}: collective rows == "
                   "host-staged rows (bits)", rows_equal(va, vb))
        check_true(f"redistribute to {tag}: values == source (bits)",
                   torch_equal(va.to_array(), src))
    del vb
    two = Runtime(rt.devices[:2])
    dt.redistribute(va, [n // 4, n - n // 4], runtime=two)
    check_true("redistribute onto 2 ranks (host-staged): values == source "
               "(bits)", va.nshards == 2 and torch_equal(va.to_array(), src))
    dt.redistribute(va, None)
    check_true("redistribute back onto 4 ranks: values == source (bits)",
               va.nshards == 4 and torch_equal(va.to_array(), src))
    out = {"n": n, "hops_per_iter": 2, "rotated_cut": rot}
    if timed:
        def pingpong(route):
            def run():
                route(va, rot, rt)
                route(va, None, rt)
            return run

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        ms = events_ms(pingpong(lambda v, d, r: dt.redistribute(v, d)), 10)
        peak = torch.cuda.max_memory_allocated()
        ms_host = host_ms(pingpong(rdx._host_staged), 2, rt.fence)
        out.update({
            "collective_ms_per_iter": ms,
            "collective_gbps": 2 * n * 4 / (ms * 1e-3) / 1e9,
            "host_staged_ms_per_iter": ms_host,
            "host_staged_gbps": 2 * n * 4 / (ms_host * 1e-3) / 1e9,
            "collective_peak_bytes": peak,
            "collective_peak_above_live_bytes": peak - live})
        log(f"  redistribute ping-pong: collective {ms!r} ms an iteration "
            f"({out['collective_gbps']!r} GB/s), host-staged {ms_host!r} ms "
            f"({out['host_staged_gbps']!r} GB/s); collective peak {peak} "
            f"bytes, {peak - live} above the {live} live")
        check_true("after the timed ping-pong: values == source (bits)",
                   torch_equal(va.to_array(), src))
    del va
    nh = 1 << halo_log2
    hv = dt.distributed_vector.from_array(src[:nh], halo=dt.halo_bounds(
        HALO_W, HALO_W, periodic=True))
    dt.redistribute(hv, None)
    hv.halo().exchange()
    cells = nh // P
    ok = True
    for r, row in enumerate(hv.rows):
        left = ((r - 1) % P) * cells + cells - HALO_W
        right = ((r + 1) % P) * cells
        want = torch.cat([src[left:left + HALO_W],
                          src[r * cells:(r + 1) * cells],
                          src[right:right + HALO_W]])
        ok = ok and torch_equal(row[0], want)
    check_true(f"halo vector (2^{halo_log2}, halo {HALO_W}) redistributed "
               "and exchanged: every row == its owners (bits)", ok)
    return out


def ghost_map(n, P, k, rng):
    """Each rank mirrors ``k`` global indices: half from its neighbours'
    blocks, half uniform over the vector, duplicates included."""
    seg = n // P
    out = {}
    for r in range(P):
        nb = rng.choice([(r - 1) % P, (r + 1) % P], k // 2)
        near = nb * seg + rng.integers(0, seg, k // 2)
        out[r] = np.concatenate([near, rng.integers(0, n, k - k // 2)])
    return out


def numpy_fold(base, flat, ghosts, op):
    want = base.copy()
    if op == "second":
        want[flat] = ghosts
    else:
        {"plus": np.add, "multiplies": np.multiply, "max": np.maximum,
         "min": np.minimum}[op].at(want, flat, ghosts)
    return want


def uhalo_phase(dt, seed, device="cuda:0", log2=UH_LOG2,
                ghosts_log2=UH_GHOSTS_LOG2, timed=True):
    """Phase 20 (b): an unstructured halo on 4 ranks: ``exchange()``
    against numpy's gather and every ``reduce`` op against numpy's
    ``ufunc.at`` / fancy assignment, bit for bit and the same bits on a
    second call; ms per ``exchange()`` and per ``reduce("plus")``."""
    import torch
    dt.init(dt.get_duplicated_devices(4, [device]))
    P, n, k = 4, 1 << log2, 1 << ghosts_log2
    rng = np.random.default_rng(seed + 21)
    src = rng.standard_normal(n).astype(np.float32)
    gmap = ghost_map(n, P, k, rng)
    flat = np.concatenate([gmap[r] for r in range(P)])
    contrib = {r: rng.standard_normal(k).astype(np.float32) for r in range(P)}
    ghosts = np.concatenate([contrib[r] for r in range(P)])
    depth = int(np.bincount(flat, minlength=n).max())
    src_dev = torch.from_numpy(src).to(device)
    v = dt.distributed_vector.from_array(src_dev)
    t0 = time.perf_counter()
    uh = dt.unstructured_halo(v, gmap)
    build = time.perf_counter() - t0
    log(f"  unstructured halo: {P} x 2^{ghosts_log2} indices over 2^{log2} "
        f"cells, {len(flat) - len(np.unique(flat))} repeats, deepest "
        f"column {depth}; built in {build:.3f} s")
    uh.exchange()
    check_true("unstructured exchange: every rank's ghosts == numpy gather "
               "(bits)", all(np.array_equal(
                   uh.ghost_values(r).cpu().numpy().view(np.int32),
                   src[gmap[r]].view(np.int32)) for r in range(P)))
    for op in UH_OPS:
        want = numpy_fold(src, flat, ghosts, op).view(np.int32)
        outs = []
        for _ in range(2):
            v.assign_array(src_dev)
            for r in range(P):
                uh.set_ghost_values(r, contrib[r])
            uh.reduce(op)
            outs.append(v.to_array().cpu().numpy().view(np.int32))
        check_true(f"unstructured reduce {op} == numpy (bits)",
                   np.array_equal(outs[0], want))
        check_true(f"unstructured reduce {op}: the same bits on a second "
                   "call", np.array_equal(outs[0], outs[1]))
    out = {"n": n, "indices_per_rank": k, "deepest_column": depth}
    if timed:
        out["exchange_ms"] = events_ms(uh.exchange, 20)
        out["reduce_plus_ms"] = events_ms(lambda: uh.reduce("plus"), 20)
        log(f"  unstructured halo: exchange {out['exchange_ms']!r} ms, "
            f"reduce plus {out['reduce_plus_ms']!r} ms")
    return out


def checkpoint_phase(dt, seed, device="cuda:0", log2=CK_LOG2,
                     bf_log2=CK_BF_LOG2, m=CK_M, tile=CK_TILE,
                     sp_log2=SP4_LOG2, md=CK_MD):
    """Phase 20 (c): save and load on 4 ranks, each round trip bit for
    bit, with seconds and file bytes; a truncated file is refused."""
    import tempfile
    import torch
    from dr_tpu_torch.utils import checkpoint as ck
    from dr_tpu_torch.utils.resilience import CheckpointCorruptError
    rt = dt.init(dt.get_duplicated_devices(4, [device]))
    gen = torch.Generator(device=device).manual_seed(seed + 22)
    rng = np.random.default_rng(seed + 22)
    out = {}

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    def same_values(a, b):
        return a.dtype == b.dtype and torch.equal(bits(a.to_array()),
                                                  bits(b.to_array()))

    def same_triples(a, b):
        sa, sb = ck.snapshot(a)[1], ck.snapshot(b)[1]
        return all(np.array_equal(sa[k], sb[k]) for k in sa)

    with tempfile.TemporaryDirectory() as td:
        def roundtrip(tag, c, same):
            path = os.path.join(td, tag + ".npz")
            rt.fence()
            t0 = time.perf_counter()
            ck.save(path, c)
            t1 = time.perf_counter()
            back = ck.load(path)
            back.block_until_ready()
            t2 = time.perf_counter()
            out[tag] = {"save_s": t1 - t0, "load_s": t2 - t1,
                        "bytes": os.path.getsize(path)}
            log(f"  checkpoint {tag}: save {t1 - t0:.3f} s, load "
                f"{t2 - t1:.3f} s, {out[tag]['bytes']} bytes")
            check_true(f"checkpoint {tag}: round trip (bits)",
                       same(c, back))
            return path, back

        n = 1 << log2
        cuts = np.sort(rng.integers(0, n + 1, 3))
        sizes = [int(b - a) for a, b in zip(np.r_[0, cuts], np.r_[cuts, n])]
        v = dt.distributed_vector.from_array(
            torch.randn(n, generator=gen, device=device), distribution=sizes)
        path, back = roundtrip(f"f32 vector 2^{log2}", v, same_values)
        check_true("  the loaded vector keeps its distribution",
                   back.layout == v.layout)
        os.unlink(path)
        del v, back
        b = dt.distributed_vector.from_array(torch.randn(
            1 << bf_log2, generator=gen, device=device).to(torch.bfloat16))
        path, back = roundtrip(f"bf16 vector 2^{bf_log2}", b, same_values)
        with open(path, "rb") as fh:
            head = fh.read(os.path.getsize(path) // 2)
        torn = os.path.join(td, "torn.npz")
        with open(torn, "wb") as fh:
            fh.write(head)
        try:
            ck.load(torn)
            refused = False
        except CheckpointCorruptError:
            refused = True
        check_true("a truncated copy raises CheckpointCorruptError", refused)
        for p_ in (path, torn):
            os.unlink(p_)
        del b, back, head
        M = dt.dense_matrix.from_array(
            torch.randn((m, m), generator=gen, device=device),
            dt.block_cyclic(tile=(tile, tile), grid=(2, 2)))
        path, back = roundtrip(f"{m}^2 matrix, {tile}^2 cyclic tiles", M,
                               same_values)
        check_true("  the loaded matrix keeps its partition",
                   back.partition == M.partition and not back.is_block)
        os.unlink(path)
        del M, back
        ms = 1 << sp_log2
        rows, cols, vals, _ = config5_coo(ms, seed=seed)
        S = dt.sparse_matrix.from_coo((ms, ms), rows, cols, vals)
        del rows, cols, vals
        path, back = roundtrip(f"config 5 sparse 2^{sp_log2} rows", S,
                               same_triples)
        os.unlink(path)
        del S, back
        A = dt.distributed_mdarray.from_array(
            torch.randn(md, generator=gen, device=device))
        path, back = roundtrip("mdarray " + "x".join(map(str, md)), A,
                               same_values)
        os.unlink(path)
    return out


def surface_phase(dt, seed, device="cuda:0", log2=SURF_LOG2,
                  expr_log2=EXPR_LOG2):
    """Phase 20 (d): the communicator, ``rma_window``, an expression
    transform and the views on 4 ranks, against numpy or torch, bit for
    bit."""
    import torch
    from dr_tpu_torch import views
    from dr_tpu_torch.utils.expr import op_from_expr
    dt.init(dt.get_duplicated_devices(4, [device]))
    P, n = 4, 1 << log2
    k = n // P
    rng = np.random.default_rng(seed + 23)
    v = rng.standard_normal(n).astype(np.float32)
    comm = dt.default_comm()
    sh = comm.scatter(v)
    check_true("communicator scatter / gather at 2^%d (bits)" % log2,
               all(s.device == torch.device(device) for s in sh)
               and np.array_equal(comm.gather(sh), v))
    blocks = v.reshape(P, k)
    for periodic in (False, True):
        for name, step, edge in (("shift_forward", 1, 0),
                                 ("shift_backward", -1, -1)):
            want = np.roll(blocks, step, 0)
            if not periodic:
                want[edge] = 0
            got = comm.gather(getattr(comm, name)(sh, periodic=periodic))
            check_true(f"communicator {name} periodic={periodic} == numpy "
                       "(bits)", np.array_equal(got, want.reshape(-1)))
    mw = 4096
    kk = n // (P * P * mw)
    mat = v.reshape(P * kk, P, mw)
    got = comm.gather(comm.alltoall(comm.scatter(mat)))
    want = mat.reshape(P, kk, P, mw).transpose(2, 0, 1, 3).reshape(
        P * P, kk, mw)
    check_true("communicator alltoall == numpy (bits)",
               np.array_equal(got, want))
    dv = dt.distributed_vector(n)
    win = dt.rma_window(dv)
    idx = rng.choice(n, 1 << 16, replace=False)
    vals = rng.standard_normal(1 << 16).astype(np.float32)
    win.put(idx, vals)
    win.fence()
    host = dt.to_numpy(dv)
    check_true("rma_window put / fence / get (bits)",
               np.array_equal(win.get(idx).cpu().numpy(), vals)
               and np.array_equal(host[idx], vals)
               and np.count_nonzero(host) == np.count_nonzero(vals))
    x = torch.randn(1 << expr_log2, generator=torch.Generator(
        device=device).manual_seed(seed + 23), device=device)
    xv = dt.distributed_vector.from_array(x)
    xo = dt.distributed_vector(1 << expr_log2)
    dt.transform(xv, xo, op_from_expr("(x0 * 2.0 + 1.0)", 1))
    check_true(f"op_from_expr transform at 2^{expr_log2} == torch "
               "(bits)", torch_equal(xo.to_array(), x * 2.0 + 1.0))
    del x, xv, xo
    vd = dt.distributed_vector.from_array(v)
    for tag, e in (("enumerate", views.enumerate(vd)),
                   ("| enumerate()", vd | views.enumerate())):
        ids, vals_ = e.to_array()
        check_true(f"views {tag} == numpy", ids.dtype == torch.int32
                   and np.array_equal(ids.cpu().numpy(), np.arange(n))
                   and np.array_equal(vals_.cpu().numpy(), v))
    ranks, vals_ = views.ranked_view(vd).to_array()
    check_true("views ranked_view == numpy", np.array_equal(
        ranks.cpu().numpy(), np.repeat(np.arange(P), k))
        and np.array_equal(vals_.cpu().numpy(), v))
    check_true("ranked_view segments: int32 ranks on each rank's device",
               all(dt.local(s)[0].device == torch.device(device)
                   and dt.local(s)[0].dtype == torch.int32
                   and bool((dt.local(s)[0] == dt.rank(s)).all())
                   for s in dt.segments(views.ranked_view(vd))))
    for tag, r, want in (
            ("| take | drop", vd | views.take(n - 5) | views.drop(7),
             v[7:n - 5]),
            ("| slice_view", vd | views.slice_view((3, k + 9)), v[3:k + 9]),
            ("| transform", vd | views.transform(lambda t: t * 3.0),
             v * np.float32(3.0))):
        check_true(f"views {tag} == numpy (bits)",
                   np.array_equal(dt.to_numpy(r), want))
    return {"n": n, "expr_n": 1 << expr_log2}


# ------------------------------------------- phase 21: observability

#: the __global__ kernel that begins one call of each wrapper on the main
#: path (dot.cu follows each dot_partials* with one sum_partials)
CALL_KERNELS = {
    "stencil_matmul": ("stencil_matmul_kernel",),
    "stencil_blocked": ("window_kernel", "shared_kernel"),
    "chunked_dot": ("dot_partials", "dot_partials_f32x4"),
    "chunked_cumsum": ("scan_tiles",),
}
K_OF = {"stencil_matmul": "K1", "stencil_blocked": "K2",
        "chunked_dot": "K3", "chunked_cumsum": "K4",
        "stencil2d_blocked": "K5", "bitonic_sort": "K6", "segred": "K7",
        "flash_update": "K9"}
#: the Chrome-trace categories of host work that a gap can overlap
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
REL_SPANS = ("relational.join", "relational.groupby",
             "relational.histogram", "relational.top_k")
REL_PHASES = ("sort_left", "sort_right", "merge", "sort", "aggregate")


def global_kernels():
    """``__global__`` function name -> launch counter, read from
    ``dr_tpu_torch/csrc/*.cu``."""
    from dr_tpu_torch.ops import kernels
    pat = re.compile(r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*"
                     r"(\w+)\s*\(")
    out = {}
    for counter, src in kernels.SOURCES.items():
        for m in pat.finditer((kernels.CSRC / src).read_text()):
            out[m.group(1)] = counter
    return out


def kernel_base(name):
    """The function name of a kernel name as the profiler gives it
    (demangled): ``void (anonymous namespace)::scan_tiles<float>(float
    const*, ...)`` -> ``scan_tiles``."""
    s = name.replace("(anonymous namespace)::", "")
    s = s.split("(", 1)[0].split("<", 1)[0].strip()
    return s.split("::")[-1].split()[-1] if s else name


def analyse_trace(path, gk, top=5):
    """The device's idle share over one Chrome trace of
    ``torch.profiler``: 1 - (the union of kernel, memcpy and memset
    intervals) / (first device event's start to the last one's end);
    the ``top`` device operations by total time; the ``top`` longest
    idle gaps with the host operations overlapping each; and the
    launches of each wrapper counted from its kernels."""
    from dr_tpu_torch.utils.profiling import DEVICE_CATS
    with open(path, encoding="utf-8") as fh:
        evs = json.load(fh)["traceEvents"]
    dev = sorted((e for e in evs if e.get("cat") in DEVICE_CATS
                  and "dur" in e), key=lambda e: float(e["ts"]))
    if not dev:
        raise AssertionError(f"{path}: no device event in the trace")
    host = [e for e in evs if e.get("cat") in HOST_CATS and "dur" in e]
    busy, gaps = 0.0, []
    s0 = float(dev[0]["ts"])
    cur_s, cur_e = s0, s0 + float(dev[0]["dur"])
    for e in dev[1:]:
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    window = cur_e - s0

    def label(e):
        base = kernel_base(e["name"])
        if e["cat"] == "kernel" and base in gk:
            return f"{K_OF[gk[base]]} {base}"
        return f"{e['cat']} {e['name'][:70]}"

    by = {}
    for e in dev:
        t, c = by.get(label(e), (0.0, 0))
        by[label(e)] = (t + float(e["dur"]), c + 1)
    ops = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
    longest = []
    for g, a, b in sorted(gaps, reverse=True)[:top]:
        over = {}
        for h in host:
            hs, he = float(h["ts"]), float(h["ts"]) + float(h["dur"])
            ov = min(he, b) - max(hs, a)
            if ov > 0:
                key = f"{h['cat']}:{h['name'][:60]}"
                over[key] = over.get(key, 0.0) + ov
        longest.append({"gap_us": g, "at_us": a - s0, "host": [
            k for k, _ in sorted(over.items(), key=lambda kv: -kv[1])[:4]]})
    bases = [kernel_base(e["name"]) for e in dev if e["cat"] == "kernel"]
    launches = {c: sum(b in ks for b in bases)
                for c, ks in CALL_KERNELS.items()}
    return {"idle_share": 1.0 - busy / window, "window_us": window,
            "busy_us": busy, "device_events": len(dev), "gaps": len(gaps),
            "top_ops": [{"op": k, "us": t, "n": c} for k, (t, c) in ops],
            "longest_gaps": longest, "launches": launches,
            "sum_partials": sum(b == "sum_partials" for b in bases)}


def traced_main_step(dt, kernels, n, ranks, seed, logdir, card,
                     device="cuda:0"):
    """One step of the 1-D main path (a ``stencil_iterate_matmul`` call
    of one K1 step, a ``stencil_iterate_blocked`` pass, ``dot_n`` of one
    round and ``inclusive_scan``, halo exchanges included) under
    ``profiling.trace``, after one warm step; the trace's kernels mapped
    to K1-K4 and counted against the launch counters over the same
    window.  Returns the analysis."""
    import torch
    from dr_tpu_torch.utils import profiling
    dt.init(dt.get_duplicated_devices(ranks, [device]))
    gen = torch.Generator(device=device).manual_seed(seed + 21)
    src = torch.randn(n, generator=gen, device=device)
    a = dt.distributed_vector.from_array(
        src, halo=dt.halo_bounds(MM_HALO, MM_HALO, periodic=True))
    b = dt.distributed_vector.from_array(
        src, halo=dt.halo_bounds(BLK_HALO, BLK_HALO, periodic=True))
    x = dt.distributed_vector.from_array(
        torch.rand(n, generator=gen, device=device))
    s = dt.distributed_vector.from_array(src)
    res = dt.distributed_vector(n)
    del src

    def step():
        with profiling.annotate("stencil_iterate_matmul"):
            dt.stencil_iterate_matmul(a, W5, K_BLOCK, k_block=K_BLOCK)
        with profiling.annotate("stencil_iterate_blocked"):
            dt.stencil_iterate_blocked(b, W5, T_BLOCK, time_block=T_BLOCK)
        with profiling.annotate("dot_n"):
            dt.dot_n(x, s, 1)
        with profiling.annotate("inclusive_scan"):
            dt.inclusive_scan(s, res)
        dt.fence()

    step()
    os.makedirs(logdir, exist_ok=True)
    for old in os.listdir(logdir):
        os.remove(os.path.join(logdir, old))
    kernels.reset_counts()
    t0 = time.perf_counter()
    with profiling.trace(logdir):
        step()
    secs = time.perf_counter() - t0
    counts = dict(kernels.launches)
    (name,) = os.listdir(logdir)
    path = os.path.join(logdir, name)
    info = analyse_trace(path, global_kernels())
    tag = f"{ranks} rank(s), n=2^{n.bit_length() - 1}"
    log(f"  [{card}] traced main step, {tag}: idle share "
        f"{info['idle_share']!r} of {info['window_us']!r} us "
        f"({info['device_events']} device events, {info['gaps']} gaps; "
        f"{secs!r} s by the host clock under the profiler; trace "
        f"{os.path.relpath(path, HERE)}, {os.path.getsize(path)} bytes)")
    for op in info["top_ops"]:
        log(f"  [{card}]   device op {op['op']}: {op['us']!r} us in "
            f"{op['n']}")
    for g in info["longest_gaps"]:
        log(f"  [{card}]   idle gap {g['gap_us']!r} us at +{g['at_us']!r} "
            f"us; host: {'; '.join(g['host'])}")
    want = {c: counts[c] for c in CALL_KERNELS}
    log(f"  {tag}: launches in the trace {info['launches']}, counters "
        f"{want}, sum_partials {info['sum_partials']}")
    for c in CALL_KERNELS:
        if counts[c] <= 0:
            raise AssertionError(f"{K_OF[c]} ({c}) never launched on the "
                                 f"traced main step ({tag})")
    check_true(f"{tag}: kernel launches in the trace == the launch "
               "counters (K1-K4)", info["launches"] == want
               and info["sum_partials"] == want["chunked_dot"])
    info["trace"] = os.path.relpath(path, HERE)
    info["launch_counters"] = want
    del a, b, x, s, res
    dt.final()
    return info


def relational_outputs_equal(tag, off, on):
    """Two runs of ``relational_path``: the same counts and every output
    the same bits."""
    import torch
    differ = [k for k in ("jk", "jl", "jr", "gk", "gv", "tv", "ti", "hb")
              if not torch.equal(off[k].view(torch.int32),
                                 on[k].view(torch.int32))]
    check_true(f"{tag}: outputs traced == untraced (bits; differing: "
               f"{differ})", off["m"] == on["m"] and off["ng"] == on["ng"]
               and not differ)


def relational_spans(tag, evs, want_phases=REL_PHASES):
    names = {e["name"] for e in evs}
    phases = {e["args"]["phase"] for e in evs
              if e["name"] == "relational.phase"}
    check_true(f"{tag}: the trace holds {list(REL_SPANS)}",
               set(REL_SPANS) <= names)
    check_true(f"{tag}: relational.phase names include "
               f"{list(want_phases)} (got {sorted(phases)})",
               set(want_phases) <= phases)
    spans = {e["id"] for e in evs if e["name"] in REL_SPANS}
    check_true(f"{tag}: every phase hangs under its op's span", all(
        e["args"].get("parent") in spans for e in evs
        if e["name"] == "relational.phase"))
    return [e["args"].get("route") for e in evs
            if e["name"] == "relational.phase"
            and e["args"]["phase"] == "merge"]


def traced_run(obs, fn):
    """``fn()`` with tracing armed; returns its result and the events it
    added to the ring (which keeps the phase's events for the export)."""
    start = obs.size()
    obs.arm(True)
    try:
        out = fn()
    finally:
        obs.arm(False)
    return out, obs.events()[start:]


def join_medians(dt, obs, data, reps=5):
    """Median seconds of ``reps`` joins of the pipeline's tables, traced
    and untraced in turns (host clock, fenced; a join reads its row
    count on the host)."""
    F, FV, D, DV = (dt.distributed_vector.from_array(a) for a in data)
    outs = [dt.distributed_vector(2 * data[0].numel()) for _ in range(3)]

    def once():
        dt.fence()
        t0 = time.perf_counter()
        dt.join(F, FV, D, DV, *outs)
        dt.fence()
        return time.perf_counter() - t0

    once()
    times = {"untraced": [], "traced": []}
    for _ in range(reps):
        times["untraced"].append(once())
        times["traced"].append(traced_run(obs, once)[0])
    return {k: float(np.median(v)) for k, v in times.items()}, times


def relational_obs(dt, obs, kernels, seed, card, device="cuda:0",
                   sizes=(REL_FACT_LOG2, REL_CARD_LOG2, REL4_FACT_LOG2)):
    """Phase 21 (a): the relational pipeline of phase 14 untraced and
    traced on one rank (the same bits, the four spans and their phases,
    the join's median of 5 both ways), then phase 15's on 4 ranks through
    the partition and the forced broadcast join.  Returns the numbers."""
    import torch
    out = {}
    dt.init([device])
    n_fact, ncard = 1 << sizes[0], 1 << sizes[1]
    data = relational_data(n_fact, ncard, seed + 14, device)
    off = relational_path(dt, data, {})
    kernels.reset_counts()
    on, evs = traced_run(obs, lambda: relational_path(dt, data, {}))
    log(f"  1 rank, n_fact=2^{sizes[0]}: launches {dict(kernels.launches)} "
        f"traced, {len(evs)} events")
    relational_outputs_equal(f"1 rank 2^{sizes[0]}", off, on)
    relational_spans(f"1 rank 2^{sizes[0]}", evs)
    del off, on
    med, times = join_medians(dt, obs, data)
    out["join_1rank_s"] = med
    log(f"  [{card}] join n_fact=2^{sizes[0]} 1 rank, median of 5 "
        f"(host clock, fenced): untraced {med['untraced']!r} s, traced "
        f"{med['traced']!r} s; runs {json.dumps(times)}")
    del data
    release(torch)
    dt.final()

    dt.init(dt.get_duplicated_devices(4, [device]))
    n4 = 1 << sizes[2]
    data = relational_data(n4, n4 >> 4, seed + 16, device)
    off = relational_path(dt, data, {})
    on, evs = traced_run(obs, lambda: relational_path(dt, data, {}))
    relational_outputs_equal(f"4 ranks 2^{sizes[2]} partition join",
                             off, on)
    routes = relational_spans(f"4 ranks 2^{sizes[2]}", evs,
                              REL_PHASES + ("partition_plan",))
    check_true(f"4 ranks: the pipeline's join took the partition route "
               f"({routes})", routes == ["partition"])
    with broadcast_max(1 << 30):
        off_b = relational_path(dt, data, {})
        on_b, evs = traced_run(obs, lambda: relational_path(dt, data, {}))
    relational_outputs_equal(f"4 ranks 2^{sizes[2]} broadcast join",
                             off_b, on_b)
    routes = relational_spans(f"4 ranks 2^{sizes[2]} broadcast", evs)
    check_true(f"4 ranks: the forced join took the broadcast route "
               f"({routes})", routes == ["broadcast"])
    check_true("4 ranks: partition rows == broadcast rows (bits)",
               all(torch.equal(on[k].view(torch.int32),
                               on_b[k].view(torch.int32))
                   for k in ("jk", "jl", "jr")))
    del off, on, off_b, on_b
    med, times = join_medians(dt, obs, data)
    out["join_4ranks_partition_s"] = med
    log(f"  [{card}] join n_fact=2^{sizes[2]} 4 ranks (partition), median "
        f"of 5: untraced {med['untraced']!r} s, traced {med['traced']!r} "
        f"s; runs {json.dumps(times)}")
    del data
    release(torch)
    dt.final()
    return out


def redistribute_obs(dt, obs, seed, card, device="cuda:0", log2=RDX_LOG2):
    """Phase 21 (b): phase 20's 2^28 f32 re-layout on 4 ranks with
    tracing armed: the collective hop to the rotated cut (span impl,
    phases plan -> exchange -> rebind, bytes_moved == plan_moves' moved
    elements x 4) and a host-staged hop onto 2 ranks (span impl host,
    no bytes), each equal bit for bit with the same hop untraced.
    Returns the numbers."""
    import torch
    from dr_tpu_torch.parallel.redistribute import plan_moves
    from dr_tpu_torch.parallel.runtime import Runtime
    rt = dt.init(dt.get_duplicated_devices(4, [device]))
    P, n = 4, 1 << log2
    gen = torch.Generator(device=device).manual_seed(seed + 20)
    src = torch.randn(n, generator=gen, device=device)
    base = n // P
    rot = [base // 2, base, base, n - base // 2 - 2 * base]
    ref = dt.distributed_vector.from_array(src)
    dt.redistribute(ref, rot)
    v = dt.distributed_vector.from_array(src)
    even = v.layout
    counter = obs.metrics.counter("redistribute.bytes_moved")
    b0 = counter.value
    _, evs = traced_run(obs, lambda: dt.redistribute(v, rot))
    moved_bytes = counter.value - b0
    _, moved = plan_moves(even, v.layout)
    span = [e for e in evs if e["name"] == "redistribute"]
    phases = [e["args"]["phase"] for e in evs
              if e["name"] == "redistribute.phase"]
    check_true(f"collective hop: one span, impl collective "
               f"({[e['args'] for e in span]})", len(span) == 1
               and span[0]["args"]["impl"] == "collective")
    check_true(f"collective hop: phases {phases} == plan, exchange, rebind",
               phases == ["plan", "exchange", "rebind"])
    check_true(f"collective hop: bytes_moved {moved_bytes} == moved "
               f"elements {moved} x 4", moved_bytes == moved * 4 > 0)
    check_true("collective hop traced: rows == untraced rows (bits)",
               rows_equal(v, ref))
    span_us = [span[0]["dur"]]
    two = Runtime(rt.devices[:2])
    cut = [n // 4, n - n // 4]
    dt.redistribute(ref, cut, runtime=two)
    b0 = counter.value
    _, evs = traced_run(obs, lambda: dt.redistribute(v, cut, runtime=two))
    span = [e for e in evs if e["name"] == "redistribute"]
    phases = [e["args"]["phase"] for e in evs
              if e["name"] == "redistribute.phase"]
    check_true(f"host-staged hop onto 2 ranks: span impl host, phases "
               f"{phases}", len(span) == 1
               and span[0]["args"]["impl"] == "host"
               and phases == ["host_staged"])
    check_true("host-staged hop: no bytes counted",
               counter.value == b0)
    check_true("host-staged hop traced: rows == untraced rows (bits), "
               "values == source", rows_equal(v, ref)
               and torch_equal(v.to_array(), src))
    span_us.append(span[0]["dur"])
    log(f"  [{card}] redistribute 2^{log2} f32, 4 ranks: bytes_moved "
        f"{moved_bytes} ({moved} elements); the spans' host-clock us "
        f"(collective, host-staged) {span_us}")
    del v, ref, src
    dt.final()
    return {"bytes_moved": moved_bytes, "moved_elements": moved,
            "span_us": span_us}


def export_obs(obs, path):
    """Phase 21 (c): the ring's events (those of (a) and (b)) through
    ``obs.write()``, the file read back (its non-metadata events ==
    ``obs.size()``) and read by ``tools/trace_view.py`` in a
    subprocess."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    size = obs.size()
    written = obs.write(path)
    with open(written, encoding="utf-8") as fh:
        doc = json.load(fh)
    body = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    check_true(f"export {os.path.relpath(written, HERE)}: loads, "
               f"{len(body)} events == obs.size() {size}",
               len(body) == size > 0)
    view = subprocess.run([sys.executable, os.path.join(HERE, "tools",
                                                         "trace_view.py"),
                           written], capture_output=True, text=True,
                          timeout=120)
    check_true(f"tools/trace_view.py reads it (rc {view.returncode})",
               view.returncode == 0
               and "spans by self-time" in view.stdout)
    for line in view.stdout.splitlines()[:12]:
        log(f"    {line}")
    obs.reset()
    return os.path.relpath(written, HERE)


def profiling_obs(dt, seed, card, device="cuda:0", log2=30, sort_log2=24,
                  marginal=(2, 10, 3, 0.1)):
    """Phase 21 (e): ``profiling.device_timer`` of ``dot_n`` at 2^30 on
    one rank (ms a round), and ``profiling.profile_phases`` of the sample
    sort on 4 ranks at 2^24 f32 through ``sort_phases_n``'s
    ``stop_after``.  Returns the ms and the breakdown."""
    import torch
    from dr_tpu_torch.algorithms import sort as dt_sort
    from dr_tpu_torch.utils import profiling
    dt.init([device])
    gen = torch.Generator(device=device).manual_seed(seed + 22)
    x = dt.distributed_vector.from_array(
        torch.rand(1 << log2, generator=gen, device=device))
    y = dt.distributed_vector.from_array(
        torch.rand(1 << log2, generator=gen, device=device))
    ms = 1e3 * profiling.device_timer(lambda r: float(dt.dot_n(x, y, r)),
                                      r1=4, r2=36, samples=5)
    log(f"  [{card}] profiling.device_timer(dot_n, 2^{log2}): {ms!r} ms a "
        "round")
    del x, y
    dt.final()
    dt.init(dt.get_duplicated_devices(4, [device]))
    src = torch.randn(1 << sort_log2, generator=gen, device=device)

    def make_run(i):
        v = dt.distributed_vector.from_array(src)
        phase = dt_sort.SORT_PHASES[i]

        def run(r):
            dt_sort.sort_phases_n(v, phase, r)
            dt.fence()
        return run

    r1, r2, samples, spread = marginal
    bd = profiling.profile_phases(make_run, dt_sort.SORT_PHASES, r1=r1,
                                  r2=r2, samples=samples, min_spread=spread)
    log(f"  [{card}] profiling.profile_phases(sort, 4 ranks, "
        f"2^{sort_log2} f32), dominant {bd.dominant}:")
    for line in bd.table(bytes_per_op=(1 << sort_log2) * 4).splitlines():
        log(f"  {line}")
    dt.final()
    return ms, {"seconds": bd.seconds, "total": bd.total,
                "dominant": bd.dominant}


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
        "stencil2d_blocked": ("dr_tpu_torch/csrc/stencil2d_blocked.cu",
                              "dr_tpu/ops/stencil2d_pallas.py:48"),
        "bitonic_sort": ("dr_tpu_torch/csrc/bitonic_sort.cu",
                         "dr_tpu/ops/sort_pallas.py:87"),
        "segred": ("dr_tpu_torch/csrc/segred.cu",
                   "dr_tpu/ops/segred_pallas.py:89"),
        # K8 is K7's kernel with one int32 sum column, counted on its own
        "hist": ("dr_tpu_torch/csrc/segred.cu",
                 "dr_tpu/ops/hist_pallas.py:32"),
        # one kernel for the resident (:242) and streaming (:150) variants
        "flash_update": ("dr_tpu_torch/csrc/flash_attention.cu",
                         "dr_tpu/ops/flash_attention.py:242,150"),
    }
    results = {k: {"name": k, "route": "cuda", "source": s,
                   "replaces": rp} for k, (s, rp) in replaces.items()}

    n = 1 << (20 if quick else 30)
    m2d = 2048 if quick else M2D
    gen = torch.Generator(device="cuda").manual_seed(seed)
    log(f"phase 3: kernels vs plain versions at n={n}, {m2d}x{m2d}")
    kernel_checks(dt, n, m2d, gen, results)
    k6_checks(gen, results)
    k7_checks(n, gen, results)
    k8_checks(n, gen, results)
    k9_checks(gen, results)
    torch.cuda.synchronize()
    if quick:
        log(json.dumps({"quick": True, "checked": list(results)}))
        return 0

    log(f"phase 4: main path, 1 rank on cuda:0, n={n}")
    dt.init(["cuda:0"])
    torch.cuda.reset_peak_memory_stats()
    log(f"  device memory live at the start: "
        f"{torch.cuda.memory_allocated()} bytes")
    kernels.reset_counts()
    t0 = time.perf_counter()
    steps = {}
    src, got = main_path(dt, n, seed, steps)
    counts = dict(kernels.launches)
    log(f"  main path {time.perf_counter() - t0:.2f} s, launches {counts}")
    log("  main path seconds by step: " + json.dumps(steps))
    steps4 = steps
    peak = torch.cuda.max_memory_allocated()
    for k in ("stencil_matmul", "stencil_blocked", "chunked_dot",
              "chunked_cumsum"):
        results[k]["launches"] = counts[k]
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the "
                                 "main path")
    with plain_versions(kernels):
        _, ref = main_path(dt, n, seed)
    compare_paths(got, ref, "main path")
    del src, got, ref
    release(torch)

    log("phase 5: main path, 4 ranks on cuda:0, n=2^26")
    four_ranks(dt, 1 << 26, seed)
    dt.final()
    release(torch)

    log(f"phase 6: 2-D heat path, 1 rank on cuda:0, {M2D}x{M2D}")
    dt.init(["cuda:0"])
    torch.cuda.reset_peak_memory_stats()
    log(f"  device memory live at the start: "
        f"{torch.cuda.memory_allocated()} bytes")
    kernels.reset_counts()
    t0 = time.perf_counter()
    steps = {}
    src, got = main_path_2d(dt, M2D, seed, steps)
    counts = dict(kernels.launches)
    log(f"  2-D path {time.perf_counter() - t0:.2f} s, launches {counts}")
    log("  2-D path seconds by step: " + json.dumps(steps))
    peak2 = torch.cuda.max_memory_allocated()
    want = -(-STEPS2D // T2D) + ITERS2D
    results["stencil2d_blocked"]["launches"] = counts["stencil2d_blocked"]
    if counts["stencil2d_blocked"] != want:
        raise AssertionError(f"K5 launched {counts['stencil2d_blocked']} "
                             f"times on the 2-D path, expected {want}")
    with plain_versions(kernels):
        _, ref = main_path_2d(dt, M2D, seed)
    compare_2d(dt, src, got, ref, "2-D path")
    del src, got, ref
    dt.final()
    release(torch)

    log(f"phase 7: 2-D path, 4 ranks on cuda:0, {M4}x{M4}")
    four_ranks_2d(dt, M4, seed, kernels)
    dt.final()
    release(torch)

    log("phase 8: timings")
    timings(n, gen, results)
    sort_timings(gen, results)
    hist_timings(gen, results)
    flash_timings(gen, results)
    release(torch)

    log(f"phase 9: sort path, 1 rank on cuda:0, n=2^{SORT_LOG2} f32")
    dt.init(["cuda:0"])
    torch.cuda.reset_peak_memory_stats()
    log(f"  device memory live at the start: "
        f"{torch.cuda.memory_allocated()} bytes")
    kernels.reset_counts()
    t0 = time.perf_counter()
    steps = {}
    src, out = sort_path(dt, 1 << SORT_LOG2, seed, steps)
    counts = dict(kernels.launches)
    log(f"  sort path {time.perf_counter() - t0:.2f} s, launches {counts}")
    log("  sort path seconds by step: " + json.dumps(steps))
    peak3 = torch.cuda.max_memory_allocated()
    results["segred"]["launches"] = counts["segred"]
    if counts["segred"] != 3 or counts["bitonic_sort"] != 0:
        raise AssertionError(f"sort path launched K7 {counts['segred']} "
                             f"times (expected 3, one per reduce) and K6 "
                             f"{counts['bitonic_sort']} (expected 0)")
    check_sort_path(src, out)
    del src, out
    dt.final()
    release(torch)

    log(f"phase 10: sort path, 4 ranks on cuda:0, n=2^{SORT4_LOG2}")
    sort_four_ranks(dt, 1 << SORT4_LOG2, seed, kernels)
    dt.final()
    release(torch)

    log("phase 11: K6 path, 8 ranks x 16384 and 4 ranks x 2^15 on cuda:0")
    kernels.reset_counts()
    want = k6_path(dt, seed)
    counts = dict(kernels.launches)
    log(f"  K6 path launches {counts}")
    results["bitonic_sort"]["launches"] = counts["bitonic_sort"]
    if counts["bitonic_sort"] != want:
        raise AssertionError(f"K6 launched {counts['bitonic_sort']} times "
                             f"on the K6 path, expected {want}")
    dt.final()
    release(torch)

    log(f"phase 12: ring attention, 1 rank on cuda:0, S={RA_S}, "
        f"h={RA_H}, hkv={RA_HKV}, d={RA_D}, bf16")
    qkv, one_rank, peak4 = ring_one_rank(dt, kernels, seed, results)
    dt.final()
    release(torch)

    log(f"phase 13: ring attention, {RA4_P} ranks on cuda:0")
    ring_four_ranks(dt, kernels, seed, qkv, one_rank)
    del qkv, one_rank
    dt.final()
    release(torch)

    log(f"phase 14: relational path, 1 rank on cuda:0, "
        f"n_fact=2^{REL_FACT_LOG2}, ncard=2^{REL_CARD_LOG2}")
    peak5 = relational_one_rank(dt, kernels, seed, results)
    dt.final()
    release(torch)

    log(f"phase 15: relational path, 4 ranks on cuda:0, "
        f"n_fact=2^{REL4_FACT_LOG2}")
    relational_four_ranks(dt, kernels, seed)
    dt.final()
    release(torch)

    log("phase 16: entry() and dryrun(4) on cuda:0")
    dr_counts = entry_phase(dt, kernels)
    dt.final()
    release(torch)

    log("phase 17: halo-exchange p50 (periodic halo 1024, 2^22 cells a "
        "rank, exchange_n(64), 4 calls x 5 batches) and GB/s/chip")
    for ranks in (1, 4):
        p50, per = halo_p50(dt, ranks)
        log(f"  halo exchange p50 {ranks} rank(s): {p50!r} us per exchange "
            f"(batches {per})")
        dt.final()
    release(torch)
    log("  GB/s/chip (phase 4's host-clock steps; phase 8's kernels): "
        + json.dumps(gbps_lines(n, steps4, results)))

    log(f"phase 18: sparse path, 1 rank on cuda:0, m=2^{SP_LOG2}, "
        f"{SP_K} a row")
    dt.init(["cuda:0"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sp = sparse_one_rank(dt, seed)
    peak6 = torch.cuda.max_memory_allocated()
    log(f"  sparse path {time.perf_counter() - t0:.2f} s: " + json.dumps(sp))
    dt.final()
    release(torch)

    log(f"phase 19: sparse path, 4 ranks on cuda:0, m=2^{SP4_LOG2}")
    t0 = time.perf_counter()
    sparse_four_ranks(dt, seed)
    log(f"  4-rank sparse path {time.perf_counter() - t0:.2f} s")
    dt.final()
    release(torch)

    log("phase 20: redistribute, unstructured halo, checkpoint and the "
        "surface, 4 ranks on cuda:0")
    kernels.reset_counts()
    t0 = time.perf_counter()
    relayout = {}
    for name, fn in (("redistribute", redistribute_phase),
                     ("unstructured_halo", uhalo_phase),
                     ("checkpoint", checkpoint_phase),
                     ("surface", surface_phase)):
        t1 = time.perf_counter()
        relayout[name] = fn(dt, seed)
        log(f"  phase 20 {name}: {time.perf_counter() - t1:.1f} s")
        dt.final()
        release(torch)
    log(f"  phase 20 {time.perf_counter() - t0:.1f} s, launches "
        f"{dict(kernels.launches)} (no kernel is on this path)")
    log("  phase 20 numbers: " + json.dumps(relayout))

    log("phase 21: observability: the relational and re-layout spans at "
        "full size, the Chrome export, profiler traces of the 1-D main "
        "path and the profiling helpers")
    from dr_tpu_torch import obs
    t0 = time.perf_counter()
    obs.reset()
    obs21 = {"card": card}
    t1 = time.perf_counter()
    obs21["relational"] = relational_obs(dt, obs, kernels, seed, card)
    log(f"  phase 21 relational: {time.perf_counter() - t1:.1f} s")
    release(torch)
    t1 = time.perf_counter()
    obs21["redistribute"] = redistribute_obs(dt, obs, seed, card)
    log(f"  phase 21 redistribute: {time.perf_counter() - t1:.1f} s")
    release(torch)
    obs21["export"] = export_obs(obs, os.path.join(OBS_DIR,
                                                   "obs_trace.json"))
    for ranks, size in ((1, n), (4, 1 << 26)):
        t1 = time.perf_counter()
        obs21[f"main_trace_{ranks}"] = traced_main_step(
            dt, kernels, size, ranks, seed,
            os.path.join(OBS_DIR, f"main_{ranks}rank"), card)
        log(f"  phase 21 traced main step, {ranks} rank(s): "
            f"{time.perf_counter() - t1:.1f} s")
        release(torch)
    t1 = time.perf_counter()
    dot_ms, obs21["sort_phases"] = profiling_obs(dt, seed, card)
    k3_ms = results["chunked_dot"]["ms"]
    obs21["device_timer_dot_ms"], obs21["k3_events_ms"] = dot_ms, k3_ms
    check(f"[{card}] device_timer(dot_n) {dot_ms!r} ms vs phase 8's K3 "
          f"{k3_ms!r} ms, relative", abs(dot_ms - k3_ms) / k3_ms, 0.10)
    log(f"  phase 21 profiling helpers: {time.perf_counter() - t1:.1f} s")
    release(torch)
    log(f"  phase 21 {time.perf_counter() - t0:.1f} s")
    log("  phase 21 numbers: " + json.dumps(obs21))

    log(f"peak device memory (1-D main path): {peak} bytes "
        f"({peak / 2 ** 30:.2f} GiB)")
    log(f"peak device memory (2-D path): {peak2} bytes "
        f"({peak2 / 2 ** 30:.2f} GiB)")
    log(f"peak device memory (sort path): {peak3} bytes "
        f"({peak3 / 2 ** 30:.2f} GiB)")
    log(f"peak device memory (ring attention, 1 rank): {peak4} bytes "
        f"({peak4 / 2 ** 30:.2f} GiB)")
    log(f"peak device memory (relational path, 1 rank): {peak5} bytes "
        f"({peak5 / 2 ** 30:.2f} GiB)")
    log(f"peak device memory (sparse path, 1 rank): {peak6} bytes "
        f"({peak6 / 2 ** 30:.2f} GiB)")
    log(f"dryrun(4) launches: {json.dumps(dr_counts)}")
    order = ("stencil_matmul", "stencil_blocked", "chunked_dot",
             "chunked_cumsum", "stencil2d_blocked", "bitonic_sort", "segred",
             "hist", "flash_update")
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
