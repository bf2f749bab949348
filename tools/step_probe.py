#!/usr/bin/env python3
"""Time the plain stencil step's kernel (``csrc/stencil_step.cu``) on one
CUDA card at the benchmark's shape (2^30 f32 cells, one rank, halo 2,
periodic, W5) beside the torch-op step it replaces and, with
``--variant NAME`` (repeatable, ``+`` joins several), beside builds of
the source with the text changes of ``VARIANTS``, in turns.

Every build is first held against the torch-op step
(``stencil._torch_step``) bit for bit, given ghosts and all.  Times are
the mean over back-to-back calls from CUDA events: ``kernel ms`` the
launch alone (``dr_stencil_step`` called directly), ``step ms`` the
whole kernel route (the ghost slices, the copy-through, the launch),
``torch ms`` the torch-op step; each beside the byte bound (the field
read once and written once at 3.35 TB/s).  The card's name and power
limit and ptxas' registers for the build are printed first.
``--quick`` checks at 2^20 cells and times nothing.

Run from the repository root:  ``python3 tools/step_probe.py
[--variant NAME] [--quick]``.  Builds into ``dr_tpu_torch/_build/``.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

import dr_tpu_torch as dt  # noqa: E402
from dr_tpu_torch.algorithms import stencil  # noqa: E402
from dr_tpu_torch.ops import kernels  # noqa: E402
from dr_tpu_torch.parallel.halo import ghost_slices  # noqa: E402
from k4k5_probe import build_variant  # noqa: E402

W5 = (0.05, 0.25, 0.4, 0.25, 0.05)
HBM = 3.35e12

_STORE = ("    __stcs(q, make_float4(o[0], o[1], o[2], o[3]));\n"
          "    __stcs(q + 1, make_float4(o[4], o[5], o[6], o[7]));\n")
_BPS = "constexpr int BLOCKS_PER_SM = 4;"
#: text changes to the current stencil_step.cu
VARIANTS = {
    "bps2": [(_BPS, "constexpr int BLOCKS_PER_SM = 2;")],
    "bps6": [(_BPS, "constexpr int BLOCKS_PER_SM = 6;")],
    "bps8": [(_BPS, "constexpr int BLOCKS_PER_SM = 8;")],
    "w4": [("constexpr int WARPS = 8; ", "constexpr int WARPS = 4; ")],
    "w16": [("constexpr int WARPS = 8; ", "constexpr int WARPS = 16;")],
    # plain (write-back) stores
    "nostcs": [(_STORE, "    q[0] = make_float4(o[0], o[1], o[2], o[3]);\n"
                "    q[1] = make_float4(o[4], o[5], o[6], o[7]);\n")],
    # evict-first loads
    "ldcs": [("const float4 a = __ldg(p), b = __ldg(p + 1);",
              "const float4 a = __ldcs(p), b = __ldcs(p + 1);")],
}


def card():
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "power limit not read"
    return f"{name}, {limit}"


def ptxas_lines():
    so = kernels._target(kernels.CSRC / kernels.SOURCES["stencil_step"])
    text = (kernels.BUILD / f"{so.stem}.ptxas.txt").read_text()
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln]


def field(n):
    """One rank, halo 2, periodic: the in and out vectors, random owned
    and ghost cells."""
    dt.init(["cuda:0"])
    gen = torch.Generator(device="cuda").manual_seed(30)
    hb = dt.halo_bounds(2, 2, periodic=True)
    a = dt.distributed_vector(n, torch.float32, halo=hb)
    b = dt.distributed_vector(n, torch.float32, halo=hb)
    for v in (a, b):
        v.rows[0].copy_(torch.randn(v.rows[0].shape, generator=gen,
                                    device="cuda"))
    return a, b


def direct(lib, a, y):
    """``dr_stencil_step`` of the benchmark's step into ``y``, called
    directly on ``lib``."""
    fn = lib.dr_stencil_step
    fn.argtypes = kernels._SIGNATURES["dr_stencil_step"]
    fn.restype = ctypes.c_int
    nshards, seg, hprev, hnxt, n = a.layout
    gp, gn = ghost_slices(a.rows, a.runtime.devices, a.layout, True)
    x, gp, gn = a.rows[0], gp[0], gn[0]
    w = (ctypes.c_float * 5)(*W5)
    stream = kernels.stream_of(x)

    def call():
        err = fn(x.data_ptr(), gp.data_ptr(), gn.data_ptr(), y.data_ptr(), w,
                 2, hprev, hprev + n, hprev, hprev + n, stream)
        assert err == 0, err
    return call


def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    print(f"card: {card()}", flush=True)
    n = (1 << 20) if args.quick else (1 << 30)
    a, b = field(n)
    op = stencil._weights_op(W5)[0]
    layout, devs = a.layout, a.runtime.devices
    want = stencil._torch_step(layout, devs, a.rows, b.rows, op, 2, 2,
                               True)[0]
    got = stencil._step_rows(layout, devs, a.rows, b.rows, op, 2, 2,
                             True)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want), "kernel route != torch-op step"
    del got
    for ln in ptxas_lines():
        print(f"ptxas main: {ln}", flush=True)
    builds = {"main": kernels.library("stencil_step")}
    for spec in args.variant:
        changes = [c for v in spec.split("+") for c in VARIANTS[v]]
        builds[spec] = build_variant("stencil_step.cu", changes, spec)
    calls = {}
    y = torch.empty_like(want)
    for name, lib in builds.items():
        y.zero_()
        call = direct(lib, a, y)
        call()
        torch.cuda.synchronize()
        ok = torch.equal(y[:, 2:2 + n], want[:, 2:2 + n])
        print(f"{name}: owned cells equal the torch-op step: {ok}",
              flush=True)
        assert ok, name
        calls[name] = call
    print(f"checked at n = {n}: the kernel route equals the torch-op "
          "step bit for bit", flush=True)
    if args.quick:
        return 0
    bound = 8 * n / HBM * 1e3
    order = list(calls) + list(reversed(calls))
    times = {name: [] for name in calls}
    for name in order:
        times[name].append(events_ms(calls[name], args.reps))
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f"kernel ms {name}: {ms!r} ({ts}), {100 * bound / ms:.2f}% of "
              f"the bound {bound!r} ms", flush=True)
    step = events_ms(lambda: stencil._step_rows(
        layout, devs, a.rows, b.rows, op, 2, 2, True), args.reps)
    print(f"step ms (kernel route, copies and ghosts): {step!r}, "
          f"{100 * bound / step:.2f}% of the bound", flush=True)
    torch_ms = events_ms(lambda: stencil._torch_step(
        layout, devs, a.rows, b.rows, op, 2, 2, True), 3)
    print(f"torch ms (the torch-op step, plain ms): {torch_ms!r}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stencil._step_rows(layout, devs, a.rows, b.rows, op, 2, 2, True)
    torch.cuda.synchronize()
    print(f"kernel route's peak above its inputs: "
          f"{torch.cuda.max_memory_allocated() - base} bytes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
