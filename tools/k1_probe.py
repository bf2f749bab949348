#!/usr/bin/env python3
"""Hold builds of K1 (``stencil_matmul``) against the plain version on
one CUDA card, on the same inputs, and time them in turns.

The first build is ``dr_tpu_torch/csrc/stencil_matmul.cu`` as the port
builds it.  ``--other PATH`` adds another version of that source (e.g.
an earlier commit's); ``--other-f32-taps`` says that it takes the f32
composed taps zero-padded to a multiple of 8, as the direct-FMA kernel
of PR 1 did, rather than the split bf16 tap table.

For each build, each case of ``CASES`` (the card tests' shapes) and,
for this source, each split (2 and 3 bf16 parts, the one the wrapper
picks marked): the largest |kernel - plain| and whether a second launch
gives the same bits.  Then the main path's row (2^30 cells, halo 512,
k = 256 of the 5-point stencil) for each build and split, its error
against the plain version and its ms from CUDA events in the order
first, second, second, first, with the TFLOP/s of three bf16 passes
over the 1025 taps (the bound's work, whatever the split).

Run from the repository root:  ``python3 tools/k1_probe.py [--other
PATH [--other-f32-taps]]``.  Builds into
``dr_tpu_torch/_build/``.
"""

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from dr_tpu_torch.ops import kernels  # noqa: E402
from dr_tpu_torch.ops import stencil_matmul as sm  # noqa: E402

W5 = (0.05, 0.25, 0.4, 0.25, 0.05)
W3A = (0.1, 0.2, 0.7)
W17 = tuple(k / 153.0 for k in range(1, 18))
T = 16384
CASES = [(1 << 16, 512, 256, W5), (4096, 128, 8, W5), (8192, 256, 100, W5),
         (T + 256, 128, 1, W5), (128, 512, 256, W5), (T, 256, 256, W3A),
         (4 * T + 4096, 128, 1, W3A), (4224, 512, 512, W3A),
         (1 << 16, 128, 100, W3A), (2 * T + 8192, 128, 8, W17),
         (3 * T + 128, 512, 64, W17)]


def build(path, tag, f32=False):
    text = open(path).read()
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    cu = kernels.BUILD / f"stencil_matmul_{tag}-{digest}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(text)
    out = subprocess.run([kernels._nvcc(), kernels.ARCH, "-std=c++17", "-O3",
                          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                          "-o", str(so), str(cu)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        sys.exit(f"nvcc failed on {path}:\n{out.stdout}{out.stderr}")
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "spill" in line or "wgmma" in line:
            print(f"  {tag} ptxas: {line.strip()}")
    lib = ctypes.CDLL(str(so))
    sig = kernels._SIGNATURES["dr_stencil_matmul"]
    lib.dr_stencil_matmul.argtypes = sig[:-2] + sig[-1:] if f32 else sig
    lib.dr_stencil_matmul.restype = ctypes.c_int
    return lib


def taps_for(parts, w, k, dev):
    """The taps a build takes: ``parts`` 0, the direct-FMA kernel's f32
    taps zero-padded to a multiple of 8; else the split table."""
    if parts == 0:
        c = sm.composed_taps(w, k).astype(np.float32)
        return torch.from_numpy(np.concatenate(
            [c, np.zeros((-len(c)) % 8, np.float32)])).to(dev)
    return sm._tap_table(w, k, parts).to(dev)


def apply(lib, parts, taps, row, seg, halo, w, k):
    """One launch of ``lib``'s entry point on ``row`` (ghosts copied)."""
    out = torch.empty_like(row)
    out[:, :halo] = row[:, :halo]
    out[:, halo + seg:] = row[:, halo + seg:]
    args = [row.data_ptr(), out.data_ptr(), taps.data_ptr(), halo, seg,
            row.shape[1], k * ((len(w) - 1) // 2), taps.shape[-1]]
    args += [parts] if parts else []
    err = lib.dr_stencil_matmul(*args,
                                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other")
    ap.add_argument("--other-f32-taps", action="store_true")
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    this = build(os.path.join(HERE, "dr_tpu_torch", "csrc",
                              "stencil_matmul.cu"), "this")
    builds = [("this/2", this, 2), ("this/3", this, 3)]
    if a.other:
        f32 = a.other_f32_taps
        builds.append(("other", build(a.other, "other", f32), 0 if f32
                       else 2))
    gen = torch.Generator(device="cuda").manual_seed(11)
    for seg, halo, k, w in CASES:
        row = torch.randn((1, 2 * halo + seg), generator=gen, device=dev)
        ref = sm.plain_apply(row, seg, halo, w, k)
        pick = sm.kernel_parts(w, k)
        for tag, lib, parts in builds:
            taps = taps_for(parts, w, k, dev)
            got = apply(lib, parts, taps, row, seg, halo, w, k)
            again = apply(lib, parts, taps, row, seg, halo, w, k)
            torch.cuda.synchronize()
            e = float((got.double() - ref.double()).abs().max())
            mark = "*" if tag.startswith("this") and parts == pick else ""
            print(f"{tag}{mark} seg={seg} "
                  f"halo={halo} k={k} r={(len(w) - 1) // 2} "
                  f"max_abs_err={e!r} same_bits={torch.equal(got, again)}",
                  flush=True)
    n, halo, k = 1 << 30, 512, 256
    row = torch.randn((1, n + 2 * halo), generator=gen, device=dev)
    ref = sm.plain_apply(row, n, halo, W5, k)
    taps = {parts: taps_for(parts, W5, k, dev) for _, _, parts in builds}
    for tag, lib, parts in builds:
        got = apply(lib, parts, taps[parts], row, n, halo, W5, k)
        torch.cuda.synchronize()
        print(f"{tag} n=2^30 max_abs_err="
              f"{float((got.double() - ref.double()).abs().max())!r}")
        del got
    del ref
    flops = 3 * 2.0 * (2 * k * 2 + 1) * n
    for tag, lib, parts in builds + builds[::-1]:
        t = ms(lambda: apply(lib, parts, taps[parts], row, n, halo, W5, k))
        print(f"{tag} n=2^30 ms={t!r} TFLOP/s={flops / t / 1e9!r}",
              flush=True)


if __name__ == "__main__":
    main()
