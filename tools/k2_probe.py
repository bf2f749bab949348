#!/usr/bin/env python3
"""Time K2 (``stencil_blocked``) on one CUDA card at ``chip_smoke.py``
phase 8's shape (one padded row of 2^30 f32, halo 1024, T = 64, the
5-point weights) and, with ``--old DIR``, beside another build of
``stencil_blocked.cu``, in turns (new, old, old, new).

``DIR`` holds an earlier ``stencil_blocked.cu`` (e.g. the parent
commit's ``dr_tpu_torch/csrc``) with the same C interface,
``dr_stencil_blocked(in, out, weights, radius, halo, seg, width, tsteps,
stream)``.  Every build is first held against ``plain_blocked`` bit for
bit at that shape and at smaller ones (r = 1 and 8, T = 1, 17 and 64, a
single partial tile, a margin deep enough for the shared-memory route),
and must give the same bits on a second call.

``--variant NAME`` (repeatable, ``+`` joins several) also checks and
times the current source with the text changes of :data:`VARIANTS`.
``--trace`` runs one traced call of the current source at the main shape
and prints each phase of a tile in SM clocks (load into registers, the T
steps, the store) and the SM clock they imply.  ``--sass`` prints the
instructions of the radius-2 window kernel's step loop by opcode
(``cuobjdump``; the kernel's whole SASS goes to
``dr_tpu_torch/_build/k2_sass.txt``).

Times: ``ms`` is the mean over back-to-back calls from CUDA events (what
``chip_smoke.py`` reports: the wrapper's ghost copies count);
``device_ms`` the kernels' own time per call from ``torch.profiler``, by
kernel, or "not measured" where it shows none.  The card's name and
power limit are printed first.  ``--quick`` checks at 2^20 and times
nothing.

Run from the repository root:  ``python3 tools/k2_probe.py [--old DIR]
[--variant NAME] [--trace] [--sass] [--quick]``.  Builds into
``dr_tpu_torch/_build/``.
"""

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

from dr_tpu_torch.ops import kernels, stencil_pallas  # noqa: E402
from k4k5_probe import build_variant  # noqa: E402
from sort_probe import build_old, events_ms  # noqa: E402

W5 = (0.05, 0.25, 0.4, 0.25, 0.05)
W17 = tuple(float(v) for v in
            (torch.arange(1, 18, dtype=torch.float64) /
             torch.arange(1, 18, dtype=torch.float64).sum()))
SEG, HALO, T = 1 << 30, 1024, 64
_NAMES = ("window_kernel", "shared_kernel", "blocked_kernel")

#: text changes to the current stencil_blocked.cu, checked bit for bit
#: and timed in turns with it
VARIANTS = {
    # each warp its own window of 32 x 64 cells: no exchange between
    # warps (the barrier is the warp's own), 1.14x recompute at T*r = 128
    "warp": [("constexpr int NW = 8; ", "constexpr int NW = 1; "),
             ("constexpr int C = 32; ", "constexpr int C = 64; ")],
    # 512 threads x 16 cells
    "t512": [("constexpr int NW = 8; ", "constexpr int NW = 16; "),
             ("constexpr int C = 32; ", "constexpr int C = 16; ")],
    # 24 warps an SM (at most 85 registers)
    "occ24": [("MIN_BLOCKS = 512 / THREADS;", "MIN_BLOCKS = 768 / THREADS;")],
    # one step an iteration, the new cells copied back
    "onestep": [("""  for (; s + 2 <= tsteps; s += 2) {
    step<RAD>(u, nu, xb[0], lane, warp, left, right, w);
    step<RAD>(nu, u, xb[1], lane, warp, left, right, w);
  }
""", """  for (; s + 1 <= tsteps; s += 1) {
    step<RAD>(u, nu, xb[s & 1], lane, warp, left, right, w);
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = nu[c];
  }
""")],
    # the barrier right after the publication: no cells stepped between
    "nosplit": [("""  for (int c = 0; c < C; ++c) asm volatile("" : "+f"(u[c]));
""", """  for (int c = 0; c < C; ++c) asm volatile("" : "+f"(u[c]));
  __syncthreads();
"""), ("""  __syncthreads();
#pragma unroll
  for (int k = 0; k < RAD; ++k) {
    const float a""", """#pragma unroll
  for (int k = 0; k < RAD; ++k) {
    const float a""")],
    # no asm statements pinning the inner cells between arrival and wait
    "nofence": [("  for (int c = 0; c < C; ++c) asm volatile(\"\" : \"+f\"(u[c]));\n",
                 ""),
                ("    asm volatile(\"\" : \"+f\"(nu[c]));\n", "")],
}

#: stamps each tile's phases (clock64 on its SM, globaltimer around it,
#: the SM's id) into 8 words a tile of a buffer set by dr_k2_trace
TRACE = [
    ("constexpr int MAX_MARGIN = W / 4;\n",
     "constexpr int MAX_MARGIN = W / 4;\n"
     "__device__ unsigned long long* k2_trace;\n"),
    ("  const long long g0 = halo + o0 - M;  // row index of window cell 0\n",
     "  const long long g0 = halo + o0 - M;  // row index of window cell 0\n"
     "  long long k2c[4];\n  unsigned long long k2g0, k2g3;\n"
     "  unsigned k2sm;\n  k2c[0] = clock64();\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k2g0));\n"
     "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(k2sm));\n"),
    ("  __syncthreads();\n  float u[C];\n",
     "  __syncthreads();\n  float u[C];\n  k2c[1] = clock64();\n"),
    ("  // the centre, window cells",
     "  k2c[2] = clock64();\n  // the centre, window cells"),
    ("      out4[(halo + o) / 4] = stage[slot(q / CH, q % CH)];\n  }\n}\n",
     "      out4[(halo + o) / 4] = stage[slot(q / CH, q % CH)];\n  }\n"
     "  if (t == 0) {\n    k2c[3] = clock64();\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k2g3));\n"
     "    unsigned long long* p = k2_trace + 8 * blockIdx.x;\n"
     "    for (int i = 0; i < 4; ++i) p[i] = k2c[i];\n"
     "    p[4] = k2g0;\n    p[5] = k2g3;\n    p[6] = k2sm;\n  }\n}\n"),
    ("extern \"C\" int dr_stencil_blocked(",
     "extern \"C\" int dr_k2_trace(void* p) {\n"
     "  return (int)cudaMemcpyToSymbol(k2_trace, &p, sizeof(p));\n}\n\n"
     "extern \"C\" int dr_stencil_blocked("),
]


def wrap(lib, tag):
    """The wrapper's call on another build of the source."""
    lib.dr_stencil_blocked.argtypes = kernels._SIGNATURES[
        "dr_stencil_blocked"]
    lib.dr_stencil_blocked.restype = ctypes.c_int

    def run(row, seg, halo, w, tsteps):
        out = torch.empty_like(row)
        out[..., :halo] = row[..., :halo]
        out[..., halo + seg:] = row[..., halo + seg:]
        wt = (ctypes.c_float * len(w))(*w)
        err = lib.dr_stencil_blocked(
            row.data_ptr(), out.data_ptr(), wt, (len(w) - 1) // 2, halo, seg,
            row.shape[-1], tsteps, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K2 {tag} failed: cudaError {err}")
        return out
    return run


def device_ms(fn, reps):
    """Kernel time per call from the profiler, by K2 kernel (the ghost
    copies under "other"), with the total; None where it shows none."""
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


def check(name, builds, seg, halo, w, tsteps, gen, dev):
    """Every build against plain_blocked bit for bit, and twice."""
    row = torch.randn((1, 2 * halo + seg), generator=gen, device=dev)
    ref = stencil_pallas.plain_blocked(row, seg, halo, w, tsteps)
    res = {"check": name}
    ok = True
    for tag, fn in builds.items():
        got = fn(row, seg, halo, w, tsteps)
        again = fn(row, seg, halo, w, tsteps)
        torch.cuda.synchronize()
        eq = bool(torch.equal(got, ref))
        same = bool(torch.equal(got, again))
        res[f"{tag}_equal"] = eq
        res[f"{tag}_same_twice"] = same
        if not eq:
            res[f"{tag}_max_diff"] = float((got - ref).abs().max())
        ok = ok and eq and same
        del got, again
    print(json.dumps(res), flush=True)
    if not ok:
        raise AssertionError(f"{name}: a build differs from plain_blocked")
    return row


def trace(gen, dev, n):
    """One traced call at the main shape: each tile's phases in clocks."""
    lib = build_variant("stencil_blocked.cu", TRACE, "trace")
    run = wrap(lib, "trace")
    cw = 8192 - 2 * 128
    tiles = -(-n // cw)
    buf = torch.zeros(8 * tiles, dtype=torch.int64, device=dev)
    lib.dr_k2_trace.argtypes = [ctypes.c_void_p]
    if lib.dr_k2_trace(buf.data_ptr()):
        raise RuntimeError("dr_k2_trace failed")
    row = torch.randn((1, n + 2 * HALO), generator=gen, device=dev)
    run(row, n, HALO, W5, T)
    run(row, n, HALO, W5, T)
    torch.cuda.synchronize()
    t = buf.view(tiles, 8).double()
    phases = {"load": t[:, 1] - t[:, 0], "steps": t[:, 2] - t[:, 1],
              "store": t[:, 3] - t[:, 2], "tile": t[:, 3] - t[:, 0]}
    q = torch.tensor([0.1, 0.5, 0.9, 0.99], dtype=torch.float64,
                     device=dev)
    res = {"trace": "window r=2", "tiles": tiles,
           "span_ms": float(t[:, 5].max() - t[:, 4].min()) / 1e6,
           "sm_ghz": float((t[:, 3] - t[:, 0]).sum() /
                           (t[:, 5] - t[:, 4]).sum()),
           "sms": int(torch.unique(t[:, 6]).numel())}
    for k, v in phases.items():
        res[k + "_clk_p10_50_90_99"] = [round(float(a)) for a in
                                        torch.quantile(v[::7], q)]
    print(json.dumps(res), flush=True)


def sass_loop(so, fn_pattern="window_kernelILi2E", dump=None):
    """The opcodes of the longest backward-branch loop (the step loop)
    of the one function matching ``fn_pattern`` in ``so``; ``dump``
    names a file for the function's instructions."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print(json.dumps({"sass": "cuobjdump not found"}), flush=True)
        return
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs if f.split("\n", 1)[0].find(fn_pattern)
                 >= 0), None)
    if body is None:
        print(json.dumps({"sass": f"{fn_pattern} not found"}), flush=True)
        return
    insts, labels = [], {}
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(insts)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            labels[f"0x{int(m.group(1), 16):x}"] = len(insts)
            insts.append(m.group(2).strip())
    if dump:
        with open(dump, "w") as f:
            f.write("\n".join(insts) + "\n")
    # a branch names its target by label, `(.L_x_N), or by address
    best = (0, 0, 0)
    for i, ins in enumerate(insts):
        m = re.search(r"BRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", ins)
        key = m and (m.group(1) if m.group(1).startswith(".")
                     else f"0x{int(m.group(1), 16):x}")
        if key in labels and labels[key] <= i:
            span = i - labels[key] + 1
            if span > best[0]:
                best = (span, labels[key], i)
    ops = collections.Counter()
    for ins in insts[best[1]:best[2] + 1]:
        op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
        ops[op.split(".")[0]] += 1
    print(json.dumps({"sass": fn_pattern, "function_instructions":
                      len(insts), "loop_instructions": best[0],
                      "by_opcode": dict(ops.most_common())}), flush=True)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", action="append", default=[],
                    help="a directory holding an earlier "
                    "stencil_blocked.cu (repeatable: old, old2, ...)")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.build_all(["stencil_blocked"])
    so = kernels._target(kernels.CSRC / "stencil_blocked.cu")
    for line in (kernels.BUILD / f"{so.stem}.ptxas.txt").read_text() \
            .splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas new: {line.strip()}", flush=True)
    if args.sass:
        sass_loop(so, dump=kernels.BUILD / "k2_sass.txt")
    builds = {"new": stencil_pallas.blocked_stencil_row}
    for i, path in enumerate(args.old):
        tag = "old" if i == 0 else f"old{i + 1}"
        builds[tag] = wrap(build_old(path, "stencil_blocked.cu"), tag)
    for spec in args.variant:
        changes = [c for name in spec.split("+") for c in VARIANTS[name]]
        builds[spec] = wrap(build_variant("stencil_blocked.cu", changes,
                                          spec), spec)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(9)
    n = 1 << 20 if args.quick else SEG
    for name, seg, halo, w, tsteps in (
            ("r=1 T=17 seg=3072", 3072, 1024, (0.1, 0.2, 0.7), 17),
            ("r=8 T=64 seg=1024", 1024, 1024, W17, 64),
            ("r=2 T=1 seg=9216", 9216, 1024, W5, 1),
            ("r=8 T=300 shared route", 4096, 3072, W17, 300)):
        check(name, builds, seg, halo, w, tsteps, gen, dev)
    row = check(f"main n={n} halo={HALO} T={T} W5", builds, n, HALO, W5,
                T, gen, dev)
    if args.trace:
        trace(gen, dev, n)
    if args.quick:
        return 0
    fns = {k: (lambda f=f: f(row, n, HALO, W5, T)) for k, f in
           builds.items()}
    others = [k for k in fns if k != "new"]
    order = ["new"] + others + others[::-1] + ["new"]
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(events_ms(fns[k], 5))
    res = {"case": f"K2 n={n} halo={HALO} T={T} W5"}
    for k in fns:
        res[f"{k}_ms"] = times[k]
        res[f"{k}_device_ms"] = device_ms(fns[k], 5) or "not measured"
    print(json.dumps(res), flush=True)
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
