#!/usr/bin/env python3
"""Time K4 (``chunked_cumsum``) and K5 (``stencil2d_blocked``) on one
CUDA card at ``chip_smoke.py`` phase 8's shapes, beside their library
calls (K5's: a copy of the padded array, the bytes alone) and, with
``--old DIR``, beside another build of the two sources,
in turns (new, old, old, new).

``DIR`` holds an earlier ``scan.cu`` and ``stencil2d_blocked.cu`` (e.g.
the parent commit's ``dr_tpu_torch/csrc``) with the C interfaces of the
three-launch K4, ``dr_chunked_cumsum(x, n, dtype, carry, totals,
offsets, nscratch, out, stream)``, and of K5, ``dr_stencil2d_blocked``
(unchanged).  Every build is first held against the plain version:
K4 within 1e-4 of its largest prefix and 8 ulps of it on
``chip_smoke.step_err``, and the same bits on a second call; K5 within
twice ``chip_smoke.heat_tol``, and the new build against the old one bit
for bit (both contract the same FMAs in the same order).

Times: ``ms`` is the mean over back-to-back calls from CUDA events (what
``chip_smoke.py`` reports); ``device_ms`` the kernels' own time per call
from ``torch.profiler``, or "not measured" where it shows none.  The
card's name and power limit are printed first.  ``--quick`` checks at
2^20 elements and 2048^2 cells and times nothing.

Run from the repository root:  ``python3 tools/k4k5_probe.py [--old
DIR] [--quick]``.  Builds into ``dr_tpu_torch/_build/``.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

import chip_smoke  # noqa: E402
from dr_tpu_torch.ops import kernels, scan_pallas  # noqa: E402
from dr_tpu_torch.ops import stencil2d_pallas  # noqa: E402
from sort_probe import build_old, events_ms  # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
HEAT = ((0.0, 0.25, 0.0), (0.25, 0.0, 0.25), (0.0, 0.25, 0.0))
_NAMES = ("scan", "stencil2d", "block_totals", "chunk_scan")

#: text changes to the current scan.cu, timed in turns with it by
#: ``--k4-variant NAME[+NAME...]``; those in K4_DIAGNOSTIC compute a wrong
#: scan (they drop a wait, to show what it costs) and are not checked
K4_VARIANTS = {
    "lb64": [("constexpr int LB = 128;", "constexpr int LB = 64;")],
    "lb256": [("constexpr int LB = 128;", "constexpr int LB = 256;")],
    "t128": [("constexpr int THREADS = 256;",
              "constexpr int THREADS = 128;")],
    "tile16k": [("constexpr int TILE_BYTES = 32768;",
                 "constexpr int TILE_BYTES = 16384;")],
    "blockidx": [("tile_sh = atomicAdd(reinterpret_cast<unsigned int*>(ws), "
                  "1u);", "tile_sh = blockIdx.x;")],
    # no wait for the inclusive prefix LB tiles back
    "nochain": [("u64 base = b >= LB ? ld_relaxed(incl + (b - LB)) : 1ull;",
                 "u64 base = 1ull;")],
    # no aggregates read
    "noagg": [("w[k] = j < b ? ld_relaxed(agg + j) : 1ull;", "w[k] = 1ull;")],
    # each status word read once, an unpublished one taken as 0
    "nowait": [("    if (done) break;\n", "    break;\n")],
}
K4_DIAGNOSTIC = {"nochain", "noagg", "nowait"}
#: text changes to the current stencil2d_blocked.cu, checked bit for bit
#: against it and timed in turns with it by ``--k5-variant NAME[+NAME]``
K5_VARIANTS = {
    # odd blocks start ~8 us late, so fewer SMs store their centres at once
    "stagger": [("  int t = blockIdx.x;\n  if (t >= tiles) return;\n",
                 "  int t = blockIdx.x;\n  if (t >= tiles) return;\n"
                 "  if (blockIdx.x & 1) {\n"
                 "    const long long c0 = clock64();\n"
                 "    while (clock64() - c0 < 14000) {\n    }\n  }\n")],
    # every tile steps with the per-cell select of the edge tiles
    "allmask": [("    if (inner) {", "    if (false) {")],
}
#: stamps each tile's phases (clock64 on its SM, globaltimer around it)
#: into the output's first pad rows, 6 words a tile (``--k5-trace``)
K5_TRACE = [
    ("    const Tile tl = tile_at(t, tiles_c, T, TP);\n",
     "    const Tile tl = tile_at(t, tiles_c, T, TP);\n"
     "    long long k5c[4];\n    unsigned long long k5g0, k5g3;\n"
     "    k5c[0] = clock64();\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k5g0));\n"),
    ("  // the window is in registers: the buffer is free\n",
     "  // the window is in registers: the buffer is free\n"
     "    k5c[1] = clock64();\n"),
    ("    // the centre: window rows", "    k5c[2] = clock64();\n"
     "    // the centre: window rows"),
    ("                          u[r][4 * h + 3]);\n      }\n    }\n",
     "                          u[r][4 * h + 3]);\n      }\n    }\n"
     "    if (threadIdx.x == 0) {\n      k5c[3] = clock64();\n"
     "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k5g3));\n"
     "      unsigned long long* q =\n"
     "          reinterpret_cast<unsigned long long*>(out) + 6 * t;\n"
     "      for (int i = 0; i < 4; ++i) q[i] = k5c[i];\n"
     "      q[4] = k5g0;\n      q[5] = k5g3;\n    }\n"),
]

#: stamps a tile's phases (clock64 on its SM, globaltimer at its start)
#: into 6 words a tile after the status words (``--k4-trace``)
K4_TRACE = [
    ("  if (threadIdx.x == 0)\n    tile_sh = atomicAdd(",
     "  long long tr[4];\n  tr[0] = clock64();\n  u64 g0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n"
     "  if (threadIdx.x == 0)\n    tile_sh = atomicAdd("),
    ("  const long long b = tile_sh;\n",
     "  const long long b = tile_sh;\n  tr[1] = clock64();\n"),
    ("  if (threadIdx.x == 0) st_relaxed(agg + b, encode((double)total));",
     "  tr[2] = clock64();\n"
     "  if (threadIdx.x == 0) st_relaxed(agg + b, encode((double)total));"),
    ("  const float ef = (float)excl_sh;\n",
     "  const float ef = (float)excl_sh;\n  tr[3] = clock64();\n"),
    ("    }\n  }\n}\n\ntemplate <typename T>\nint run(",
     "    }\n  }\n  if (threadIdx.x == 0) {\n"
     "    u64* q = ws + WS_HEAD + 2 * tiles + 6 * b;\n    q[0] = g0;\n"
     "    for (int i = 0; i < 4; ++i) q[1 + i] = tr[i];\n"
     "    q[5] = clock64();\n  }\n}\n\ntemplate <typename T>\nint run("),
]


def old_scan(lib):
    lib.dr_chunked_cumsum.argtypes = [_P, _L, _I, _P, _P, _P, _L, _P, _P]
    lib.dr_chunked_cumsum.restype = _I

    def run(x, carry):
        nb = -(-x.numel() // 4096)
        totals = torch.empty(nb, dtype=torch.float32, device=x.device)
        offsets = torch.empty_like(totals)
        out = torch.empty_like(x)
        err = lib.dr_chunked_cumsum(
            x.data_ptr(), x.numel(), scan_pallas._DTYPE_CODE[x.dtype],
            kernels.ptr(carry), totals.data_ptr(), offsets.data_ptr(), nb,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old K4 failed: cudaError {err}")
        return out
    return run


def old_stencil2d(lib):
    lib.dr_stencil2d_blocked.argtypes = kernels._SIGNATURES[
        "dr_stencil2d_blocked"]
    lib.dr_stencil2d_blocked.restype = _I

    def run(xp, m, w, T, pad):
        n = xp.shape[1]
        out = torch.empty_like(xp)
        out[:pad] = xp[:pad]
        out[pad + m:] = xp[pad + m:]
        wt = (ctypes.c_float * 9)(*[float(v) for r in w for v in r])
        full = int(any(w[i][j] for i in (0, 2) for j in (0, 2)))
        err = lib.dr_stencil2d_blocked(
            xp.data_ptr(), out.data_ptr(), wt, full, m, n, pad, T,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old K5 failed: cudaError {err}")
        return out
    return run


def build_variant(name, changes, tag):
    """Build csrc/``name`` with text ``changes`` (old, new) and print
    ptxas' registers and spills for it."""
    src = (kernels.CSRC / name).read_text()
    for old, new in changes:
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not in the source once")
        src = src.replace(old, new)
    digest = hashlib.sha256(src.encode()).hexdigest()[:12]
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    cu = kernels.BUILD / f"variant_{name[:-3]}-{digest}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    out = subprocess.run([kernels._nvcc(), kernels.ARCH, "-std=c++17", "-O3",
                          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                          "-o", str(so), str(cu)], capture_output=True,
                         text=True, check=True)
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas {tag}: {line.strip()}", flush=True)
    return ctypes.CDLL(str(so))


def variant_scan(spec, extra=0):
    """The current wrapper's call on the current scan.cu with the text
    changes of ``spec`` ("lb512+per32"; "trace" for K4_TRACE, with
    ``extra`` more workspace words a tile); returns (out, workspace)
    with ``extra``."""
    names = spec.split("+")
    changes = [c for name in names
               for c in (K4_TRACE if name == "trace" else K4_VARIANTS[name])]
    lib = build_variant("scan.cu", changes, spec)
    tile_bytes = 16384 if "tile16k" in names else 32768
    lib.dr_chunked_cumsum.argtypes = kernels._SIGNATURES["dr_chunked_cumsum"]
    lib.dr_chunked_cumsum.restype = _I

    def run(x, carry):
        n, size = x.numel(), x.element_size()
        shift = x.data_ptr() % 16 // size
        ws = torch.zeros(16 + (2 + extra) * -(-(n + shift) //
                                             (tile_bytes // size)),
                         dtype=torch.int64, device=x.device)
        out = torch.empty(n + shift, dtype=x.dtype, device=x.device)[shift:]
        err = lib.dr_chunked_cumsum(
            x.data_ptr(), n, scan_pallas._DTYPE_CODE[x.dtype],
            kernels.ptr(carry), ws.data_ptr(), ws.numel(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K4 variant {spec} failed: cudaError {err}")
        return (out, ws) if extra else out
    return run


def k4_trace(x, carry, spec):
    """One traced call: the spread of each phase of a tile, in SM clocks,
    and the tiles in flight."""
    run = variant_scan(spec, extra=6)
    run(x, carry)
    _, ws = run(x, carry)
    torch.cuda.synchronize()
    tiles = (ws.numel() - 16) // 8
    t = ws[16 + 2 * tiles:].view(tiles, 6).double()
    phases = {"ticket": t[:, 2] - t[:, 1], "load_reduce": t[:, 3] - t[:, 2],
              "look_back": t[:, 4] - t[:, 3], "store": t[:, 5] - t[:, 4],
              "tile": t[:, 5] - t[:, 1]}
    q = torch.tensor([0.1, 0.5, 0.9, 0.99], dtype=torch.float64,
                     device=t.device)
    row = {"trace": spec, "tiles": tiles,
           "span_us": float(t[:, 0].max() - t[:, 0].min()) / 1e3}
    for k, v in phases.items():
        row[k + "_clk_p10_50_90_99"] = [round(float(a)) for a in
                                        torch.quantile(v[::7], q)]
    print(json.dumps(row), flush=True)


def variant_stencil2d(spec):
    """The current wrapper's launch on the current stencil2d_blocked.cu
    with the text changes of ``spec`` ("trace" for K5_TRACE)."""
    changes = [c for name in spec.split("+")
               for c in (K5_TRACE if name == "trace" else K5_VARIANTS[name])]
    return old_stencil2d(build_variant("stencil2d_blocked.cu", changes,
                                       spec))


def device_ms(fn, reps):
    """Kernel time per call from the profiler, by kernel of the two
    sources, with the total; None where it shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.key_averages():
        if ev.device_type.name != "CUDA":
            continue
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        short = next((k for k in _NAMES if k in ev.key), "other")
        if t:
            by[short] = by.get(short, 0.0) + t / reps / 1e3
    if not by:
        return None
    by["total"] = sum(by.values())
    return by


def timed(name, fns, library, reps):
    """fns: {"new": fn, other tag: fn or None, ...}; in turns new, the
    others, the others reversed, new."""
    fns = {k: f for k, f in fns.items() if f is not None}
    others = [k for k in fns if k != "new"]
    order = ["new"] + others + others[::-1] + ["new"]
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(events_ms(fns[k], reps))
    row = {"case": name, "library_ms": events_ms(library, reps),
           "library_device_ms": device_ms(library, 10) or "not measured"}
    for k in fns:
        row[f"{k}_ms"] = times[k]
        row[f"{k}_device_ms"] = device_ms(fns[k], 10) or "not measured"
    print(json.dumps(row), flush=True)


def k5_trace(spec, gen, dev):
    """One traced K5 pass at 16384^2, T = 16: each tile's cycles by phase,
    and the SM clock they imply (cycles over globaltimer ns)."""
    m, T = 16384, 16
    xp = torch.randn((m + 2 * T, m), generator=gen, device=dev)
    run = variant_stencil2d(spec)
    run(xp, m, HEAT, T, T)
    out = run(xp, m, HEAT, T, T)
    torch.cuda.synchronize()
    tiles = -(-m // (144 - 2 * T)) * -(-m // (256 - 2 * T))
    t = out[:T].reshape(-1).view(torch.int64)[:6 * tiles].view(tiles, 6)
    t = t.double()
    phases = {"wait_load": t[:, 1] - t[:, 0], "steps": t[:, 2] - t[:, 1],
              "store": t[:, 3] - t[:, 2], "tile": t[:, 3] - t[:, 0]}
    q = torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64, device=t.device)
    row = {"trace": spec, "tiles": tiles,
           "span_us": float(t[:, 5].max() - t[:, 4].min()) / 1e3,
           "sm_ghz": float((t[:, 3] - t[:, 0]).sum() / (t[:, 5] - t[:, 4])
                           .sum())}
    for k, v in phases.items():
        row[k + "_clk_p10_50_90"] = [round(float(a))
                                     for a in torch.quantile(v, q)]
    print(json.dumps(row), flush=True)


def k4_case(name, x, carry, oscan, reps, variants=None):
    start = float(carry) if carry is not None else 0.0
    ref = scan_pallas.plain_cumsum(x, carry)
    top = float(ref.float().abs().max())
    builds = {"new": lambda: scan_pallas.chunked_cumsum(x, carry=carry)}
    if oscan:
        builds["old"] = lambda: oscan(x, carry)
    for tag, f in (variants or {}).items():
        builds[tag] = lambda f=f: f(x, carry)
    for tag, fn in builds.items():
        if set(tag.split("+")) & K4_DIAGNOSTIC:
            continue
        got = fn()
        again = fn()
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32 if x.element_size() == 4
                                    else torch.int16),
                           again.view(torch.int32 if x.element_size() == 4
                                      else torch.int16))
        err = chip_smoke.max_err(got, ref)
        if x.dtype == torch.float32:
            tol = 1e-4 * top
            steps = chip_smoke.step_err(got, x, start)
            stol = 8 * chip_smoke.f32_ulp(top)
        else:
            tol, steps, stol = 2 ** -6 * top, 0.0, 0.0
        print(json.dumps({"check": f"{name} {tag}", "max_abs_err": err,
                          "tol": tol, "step_err": steps, "step_tol": stol,
                          "same_bits_twice": same}), flush=True)
        if not (err <= tol and steps <= stol and same):
            raise AssertionError(f"{name}: {tag} build fails its check")
        del got, again
    if reps:
        timed(name, builds, lambda: torch.cumsum(x, 0), reps)


def k5_case(name, m, n, w, T, gen, dev, ostencil, reps, variants=None):
    xp = torch.randn((m + 2 * T, n), generator=gen, device=dev)
    got = stencil2d_pallas.blocked_stencil2d_padded(xp, m, w, T, T)
    ref = stencil2d_pallas.plain_blocked2d(xp, m, w, T, T)
    err = chip_smoke.max_err(got, ref)
    tol = 2 * chip_smoke.heat_tol(w, T, float(xp.abs().max()))
    row = {"check": name, "max_abs_err": err, "tol": tol}
    ok = err <= tol
    if ostencil:
        old = ostencil(xp, m, w, T, T)
        row["equal_to_old_build"] = bool(torch.equal(got, old))
        row["max_diff_old"] = chip_smoke.max_err(got, old)
        ok = ok and row["equal_to_old_build"]
        del old
    for tag, f in (variants or {}).items():
        row[f"{tag}_equal"] = bool(torch.equal(got, f(xp, m, w, T, T)))
        ok = ok and row[f"{tag}_equal"]
    print(json.dumps(row), flush=True)
    del ref, got
    if not ok:
        raise AssertionError(f"{name}: a build fails its check")
    if reps:
        fns = {"new": lambda: stencil2d_pallas.blocked_stencil2d_padded(
            xp, m, w, T, T)}
        if ostencil:
            fns["old"] = lambda: ostencil(xp, m, w, T, T)
        for tag, f in (variants or {}).items():
            fns[tag] = lambda f=f: f(xp, m, w, T, T)
        timed(name, fns, lambda: xp.clone(), reps)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--k4-variant", action="append", default=[])
    ap.add_argument("--k4-trace", action="append", default=[],
                    help="trace a call of the current scan.cu with these "
                    "variants ('trace' alone: as it is)")
    ap.add_argument("--k5-variant", action="append", default=[])
    ap.add_argument("--k5-trace", action="append", default=[],
                    help="trace a pass of the current stencil2d_blocked.cu "
                    "with these variants ('trace' alone: as it is)")
    ap.add_argument("--only", default=None, choices=("k4", "k5"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4k5_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.build_all(["chunked_cumsum", "stencil2d_blocked"])
    for p in sorted(kernels.BUILD.glob("*.ptxas.txt")):
        if p.stem.startswith(("scan", "stencil2d_blocked")):
            for line in p.read_text().splitlines():
                if "registers" in line or "spill" in line or \
                        "Compiling" in line:
                    print(f"ptxas {p.stem.split('-')[0]}: {line.strip()}")
    oscan = ostencil = None
    if args.old and args.only != "k5":
        oscan = old_scan(build_old(args.old, "scan.cu"))
    if args.old and args.only != "k4":
        ostencil = old_stencil2d(build_old(args.old, "stencil2d_blocked.cu"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    n = 1 << (20 if args.quick else 30)
    reps = 0 if args.quick else 10
    if args.only in (None, "k4"):
        variants = {v: variant_scan(v) for v in args.k4_variant}
        x = torch.randn(n + 4, generator=gen, device=dev)
        carry = torch.tensor(3.5, device=dev)
        for spec in args.k4_trace:
            k4_trace(x[:n], carry, spec)
        k4_case(f"K4 f32 {n}", x[:n], carry, oscan, reps, variants)
        k4_case(f"K4 f32 {n - 1}, 4 bytes off", x[1:n], None, oscan,
                reps if not variants else 0)
        xb = x[:1 << 24].to(torch.bfloat16)
        k4_case("K4 bf16 2^24", xb, carry, oscan, 0)
        k4_case("K4 bf16 2^24 - 3, 6 bytes off", xb[3:], carry, oscan, 0)
        del x, xb
    if args.only in (None, "k5"):
        for spec in args.k5_trace:
            k5_trace(spec, gen, dev)
        variants = {v: variant_stencil2d(v) for v in args.k5_variant}
        m = 2048 if args.quick else 16384
        k5_case(f"K5 {m}^2 T=16 heat", m, m, HEAT, 16, gen, dev, ostencil,
                reps, variants)
        full = ((0.05, 0.1, 0.05), (0.1, 0.4, 0.1), (0.05, 0.1, 0.05))
        k5_case("K5 1101x1280 T=7 full", 1101, 1280, full, 7, gen, dev,
                ostencil, 0, variants)
        k5_case("K5 131x128 T=64 heat", 131, 128, HEAT, 64, gen, dev,
                ostencil, 0, variants)
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
