#!/usr/bin/env python3
"""Time K6 (``bitonic_sort``), K7 (``segred``) and K8 (``hist``, K7's
kernel) on one CUDA card at ``chip_smoke.py`` phase 8's shapes, beside
their library calls and, with ``--old DIR``, beside another build of the
same sources, in turns (new, old, old, new).

``--k7-variant NAME`` (repeatable) also times K7 built from the current
``segred.cu`` with one of :data:`K7_VARIANTS`' text changes (the steps
tried on K7's one-segment fold), on K7's cases, in turns with the
current build.  ``--only k6|k7|k8`` times one kernel's cases alone.

``DIR`` holds an earlier ``bitonic_sort.cu`` and ``segred.cu`` (e.g. the
parent commit's ``dr_tpu_torch/csrc``) with the C interfaces they had
before the batched K6 and the workspace of K7: ``dr_bitonic_sort(keys,
gid, n, M, keys_out, gid_out, stream)`` and ``dr_segred(segid, n, nseg,
ncols, vals, dtypes, ops, outs, keys, stream)``.  Every timed result of
either build is first checked bit for bit against the plain version.

Times: ``ms`` is the mean over back-to-back calls from CUDA events (what
``chip_smoke.py`` reports; a call's host work counts where it is longer
than the kernel); ``device_ms`` is the kernels' own time per call from
``torch.profiler`` (CUPTI), by kernel, or "not measured" where the
profiler shows no device time.  The card's name and power limit are
printed first.

Run from the repository root:  ``python3 tools/sort_probe.py [--old
DIR] [--k7-variant NAME ...]``.  Builds into ``dr_tpu_torch/_build/``.
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

from dr_tpu_torch.ops import (hist_pallas, kernels,  # noqa: E402
                              segred_pallas, sort_pallas)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: text changes to the current segred.cu: 32 keys a step of the
#: one-segment fold (8 vectors in flight a thread for f32, not 4), and the
#: scalar head to a 16-byte boundary in place of a 128-byte one, ...
K7_VARIANTS = {
    "vec32": [("U = 16 / W;", "U = 32 / W;")],
    "head16": [("(128 - addr % 128) % 128", "(16 - addr % 16) % 16")],
    # streaming (evict-first) vector loads, and plain (coherent) ones
    "ldcs": [("const uint4 u = __ldg(", "const uint4 u = __ldcs(")],
    "ld": [("const uint4 u = __ldg(reinterpret_cast<const uint4*>(",
            "const uint4 u = *(reinterpret_cast<const uint4*>(")],
    # two vectors in flight a thread for f32; 512-thread blocks
    "vec8": [("U = 16 / W;", "U = (8 + W - 1) / W;")],
    "t512": [("constexpr int THREADS = 256;", "constexpr int THREADS = 512;")],
    # vector loads that ask L2 to fetch 256 (128) bytes around each line
    "l2_256": [("""  const uint4 u = __ldg(reinterpret_cast<const uint4*>(
      static_cast<const char*>(p) + i * S));""", """  uint4 u;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
      : "l"(static_cast<const char*>(p) + i * S));""")],
    "l2_128": [("""  const uint4 u = __ldg(reinterpret_cast<const uint4*>(
      static_cast<const char*>(p) + i * S));""", """  uint4 u;
  asm("ld.global.nc.L1::no_allocate.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
      : "l"(static_cast<const char*>(p) + i * S));""")],
    # the column table as a plain kernel parameter (a local copy a thread)
    "nogc": [("const __grid_constant__ Cols cols", "Cols cols")],
    # each block folds one contiguous chunk of the column
    "chunked": [("""  long long q = tid;
  for (; q + (U - 1) * nthreads < nvec; q += U * nthreads) {
    int k[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u)
      vector_keys<DT>(v, head + (q + u * nthreads) * W, OP, k[u]);""",
                 """  const long long chunk = (nvec + gridDim.x - 1) / gridDim.x;
  const long long q1 = min(nvec, (blockIdx.x + 1) * chunk);
  long long q = blockIdx.x * chunk + threadIdx.x;
  for (; q + (U - 1) * THREADS < q1; q += U * THREADS) {
    int k[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u)
      vector_keys<DT>(v, head + (q + u * THREADS) * W, OP, k[u]);"""),
                ("""  for (; q < nvec; q += nthreads) {
    int k[W];""", """  for (; q < q1; q += THREADS) {
    int k[W];""")],
    # at most 32 registers: 8 blocks an SM for the one-segment fold
    "lb8": [("__global__ void __launch_bounds__(THREADS)\nfold_whole(",
             "__global__ void __launch_bounds__(THREADS, 8)\nfold_whole(")],
}
_KERNELS = ("bitonic", "fold_whole", "fold_direct", "accumulate", "finalize",
            "init_keys")


def build_old(path, name, changes=()):
    src = open(os.path.join(path, name)).read()
    for old, new in changes:
        if old not in src:
            raise ValueError(f"{name}: {old!r} not in the source")
        src = src.replace(old, new)
    digest = hashlib.sha256(src.encode()).hexdigest()[:12]
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    cu = kernels.BUILD / f"old_{name[:-3]}-{digest}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    subprocess.run([kernels._nvcc(), kernels.ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(so),
                    str(cu)], check=True)
    return ctypes.CDLL(str(so))


def old_sort(lib):
    lib.dr_bitonic_sort.argtypes = [_P, _P, _L, _I, _P, _P, _P]
    lib.dr_bitonic_sort.restype = _I

    def run(keys, gid=None):
        """One launch a row, as the earlier design sorted a batch."""
        b, n = keys.shape
        M = sort_pallas.padded(n)
        kout = torch.empty((b, M), dtype=torch.int32, device=keys.device)
        gout = torch.empty_like(kout) if gid is not None else None
        stream = torch.cuda.current_stream().cuda_stream
        for r in range(b):
            err = lib.dr_bitonic_sort(
                keys[r].data_ptr(), kernels.ptr(None if gid is None
                                                else gid[r]),
                n, M, kout[r].data_ptr(),
                kernels.ptr(None if gout is None else gout[r]), stream)
            if err:
                raise RuntimeError(f"old K6 failed: cudaError {err}")
        return kout[:, :n], (gout[:, :n] if gout is not None else None)
    return run


def old_segred(lib):
    lib.dr_segred.argtypes = [_P, _L, _I, _I, ctypes.POINTER(_L),
                              ctypes.POINTER(_I), ctypes.POINTER(_I),
                              ctypes.POINTER(_L), _P, _P]
    lib.dr_segred.restype = _I

    def run(segid, nseg, cols):
        cols = segred_pallas._columns(cols)
        k = len(cols)
        dev = cols[0][0].device
        outs = [torch.empty(nseg, dtype=v.dtype, device=dev)
                for v, _ in cols]
        keys = torch.empty((k, nseg), dtype=torch.int32, device=dev)
        err = lib.dr_segred(
            kernels.ptr(segid), cols[0][0].numel(), nseg, k,
            (_L * k)(*[v.data_ptr() for v, _ in cols]),
            (_I * k)(*[segred_pallas.KERNEL_DTYPES[v.dtype]
                       for v, _ in cols]),
            (_I * k)(*[segred_pallas._OP_CODE[op] for _, op in cols]),
            (_L * k)(*[o.data_ptr() for o in outs]), keys.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old K7 failed: cudaError {err}")
        return tuple(outs)
    return run


def variant_segred(lib):
    """The current wrapper's call on another build of the current source,
    with a workspace of its own."""
    lib.dr_segred.argtypes = kernels._SIGNATURES["dr_segred"]
    lib.dr_segred.restype = _I
    lib.dr_segred_workspace_ints.restype = _I
    ws = torch.zeros(lib.dr_segred_workspace_ints(), dtype=torch.int32,
                     device="cuda")

    def run(segid, nseg, cols):
        cols = segred_pallas._columns(cols)
        k = len(cols)
        outs = [torch.empty(nseg, dtype=v.dtype, device=ws.device)
                for v, _ in cols]
        err = lib.dr_segred(
            kernels.ptr(segid), cols[0][0].numel(), nseg, k,
            (_L * k)(*[v.data_ptr() for v, _ in cols]),
            (_I * k)(*[segred_pallas.KERNEL_DTYPES[v.dtype]
                       for v, _ in cols]),
            (_I * k)(*[segred_pallas._OP_CODE[op] for _, op in cols]),
            (_L * k)(*[o.data_ptr() for o in outs]), ws.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K7 variant failed: cudaError {err}")
        return tuple(outs)
    return run


def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps, every=False):
    """Kernel time per call from the profiler, by kernel of this repo
    (short names; ``every``: all kernels, under "library"), with the
    total; None where it shows no device time."""
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
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        short = "library" if every and ev.device_type.name == "CUDA" \
            else next((k for k in _KERNELS if k in ev.key), None)
        if t and short:
            by[short] = by.get(short, 0.0) + t / reps / 1e3
    if not by:
        return None
    by["total"] = sum(by.values())
    return by


def same(a, b):
    if isinstance(a, (tuple, list)):
        return all(same(x, y) for x, y in zip(a, b))
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        return torch.equal(na, nb) and torch.equal(
            a.masked_fill(na, 0).view(torch.int32 if a.element_size() == 4
                                      else torch.int16),
            b.masked_fill(nb, 0).view(torch.int32 if b.element_size() == 4
                                      else torch.int16))
    return torch.equal(a, b)


def case(name, fns, plain, library, reps):
    """fns: {"new": fn, other tag: fn or None, ...}; each checked against
    plain first, then timed in turns: new, each other, each other, new."""
    want = plain()
    fns = {tag: fn for tag, fn in fns.items() if fn is not None}
    for tag, fn in fns.items():
        if not same(fn(), want):
            raise AssertionError(f"{name}: {tag} build differs from plain")
    others = [tag for tag in fns if tag != "new"]
    order = ["new"] + others + others[::-1] + ["new"] if others else ["new"]
    times = {tag: [] for tag in fns}
    for tag in order:
        times[tag].append(events_ms(fns[tag], reps))
    row = {"case": name, "library_ms": events_ms(library, reps),
           "library_device_ms": device_ms(library, 20, every=True)
           or "not measured"}
    for tag in fns:
        row[f"{tag}_ms"] = times[tag]
        row[f"{tag}_device_ms"] = device_ms(fns[tag], 20) or "not measured"
    print(json.dumps(row), flush=True)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=None)
    ap.add_argument("--k7-variant", action="append", default=[],
                    choices=sorted(K7_VARIANTS))
    ap.add_argument("--only", default=None, choices=("k6", "k7", "k8"),
                    help="time one kernel's cases alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sort_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.build_all(["bitonic_sort", "segred"])
    for p in sorted(kernels.BUILD.glob("*.ptxas.txt")):
        if p.stem.startswith(("bitonic_sort", "segred")):
            for line in p.read_text().splitlines():
                if "registers" in line or "spill" in line or \
                        "Function properties" in line or "Compiling" in line:
                    print(f"ptxas {p.stem.split('-')[0]}: {line.strip()}")
    osort = oseg = None
    if args.old:
        osort = old_sort(build_old(args.old, "bitonic_sort.cu"))
        oseg = old_segred(build_old(args.old, "segred.cu"))
    variants = {v: variant_segred(build_old(
        str(kernels.CSRC), "segred.cu", K7_VARIANTS[v]))
        for v in args.k7_variant}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)

    run = {k: args.only in (None, k) for k in ("k6", "k7", "k8")}
    for b, M in ((1, 16384), (1, 1 << 15), (8, 16384)) if run["k6"] else ():
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, M), generator=gen,
                             device=dev, dtype=torch.int32)
        gid = torch.argsort(torch.rand((b, M), generator=gen, device=dev),
                            dim=1).to(torch.int32)
        packed = (keys.long() << 32) | (gid.long() + (1 << 31))
        k1 = keys[0] if b == 1 else keys
        g1 = gid[0] if b == 1 else gid
        case(f"K6 keys {b}x{M}",
             {"new": lambda: sort_pallas.sort_keys(k1),
              "old": (lambda: osort(keys)[0].reshape(k1.shape))
              if osort else None},
             lambda: sort_pallas.plain_sort_keys(k1),
             lambda: torch.sort(k1), 50)
        case(f"K6 kv {b}x{M}",
             {"new": lambda: sort_pallas.sort_kv(k1, g1),
              "old": (lambda: tuple(t.reshape(k1.shape)
                                    for t in osort(keys, gid)))
              if osort else None},
             lambda: sort_pallas.plain_sort_kv(k1, g1),
             lambda: torch.sort(packed[0] if b == 1 else packed), 50)

    if run["k7"]:
        k7_cases(gen, dev, oseg, variants)
    if run["k8"]:
        k8_cases(gen, dev, oseg)
    torch.cuda.synchronize()
    return 0


def k7_cases(gen, dev, oseg, variants):
    n = 1 << 30
    x = torch.randn(n, generator=gen, device=dev)
    cols = ((x, "min"),)
    case("K7 min 2^30 f32",
         {"new": lambda: segred_pallas.segmented(None, 1, cols),
          "old": (lambda: oseg(None, 1, cols)) if oseg else None,
          **{v: (lambda f=f: f(None, 1, cols)) for v, f in variants.items()}},
         lambda: segred_pallas.plain_segmented(None, 1, cols),
         lambda: torch.amin(x), 10)
    xs = x[1:]  # reduce's unaligned row slices
    cols = ((xs, "max"),)
    case("K7 max 2^30-1 f32, 4 bytes off a 16-byte boundary",
         {"new": lambda: segred_pallas.segmented(None, 1, cols),
          "old": (lambda: oseg(None, 1, cols)) if oseg else None,
          **{v: (lambda f=f: f(None, 1, cols)) for v, f in variants.items()}},
         lambda: segred_pallas.plain_segmented(None, 1, cols),
         lambda: torch.amax(xs), 10)
    del x, xs, cols
    m = 1 << 15
    ids = torch.randint(0, m, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    vals = torch.randint(-1000, 1000, (m,), generator=gen, device=dev,
                         dtype=torch.int32)
    cols = ((vals, "sum"),)
    case("K7 int32 sum n=nseg=2^15",
         {"new": lambda: segred_pallas.segmented(ids, m, cols),
          "old": (lambda: oseg(ids, m, cols)) if oseg else None,
          **{v: (lambda f=f: f(ids, m, cols)) for v, f in variants.items()}},
         lambda: segred_pallas.plain_segmented(ids, m, cols),
         lambda: torch.zeros(m, dtype=torch.int32, device=dev)
         .scatter_reduce_(0, ids.long(), vals, "sum"), 50)



def k8_cases(gen, dev, oseg):
    for n, bins in ((1 << 30, 1024), (1 << 26, 16)):
        bucket = torch.randint(0, bins, (n,), generator=gen, device=dev,
                               dtype=torch.int32)
        ones = torch.ones(n, dtype=torch.int32, device=dev)
        cols = ((ones, "sum"),)
        case(f"K8 {n} ids over {bins} bins",
             {"new": lambda: hist_pallas.bincount(bucket, ones, bins),
              "old": (lambda: oseg(bucket, bins, cols)[0]) if oseg
              else None},
             lambda: hist_pallas.plain_bincount(bucket, ones, bins),
             lambda: torch.bincount(bucket, minlength=bins), 10)
        del bucket, ones


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
