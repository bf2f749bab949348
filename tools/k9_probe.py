#!/usr/bin/env python3
"""Hold two builds of K9 (``flash_update``) against the plain version on
one CUDA card, on the same inputs, and time them in turns.

The first build is ``dr_tpu_torch/csrc/flash_attention.cu`` as the port
builds it.  The second is ``--other PATH`` (another version of that
source, e.g. an earlier commit's, launched in chunks of at most 32768
q heads) or, by default, the same source with p and corr computed by
``expf(x - safe_m)`` in place of ``exp2f((x - safe_m) * log2(e))``.
Each build is compared with :func:`plain_flash_update` over its own key
tile (``--other-block-k`` for the second).

Cases (bf16 q/k/v from one seed, zero state, offsets 0, group 4):
65536 q heads at s = skv = 128, d = 128, causal and not; 32 heads at
s = skv = 16384, d = 256, causal; 32 heads at s = skv = 32768, d = 128,
causal (``chip_smoke.py`` phase 8's).  For each: the elements of acc / l
outside rtol = atol = 2e-3, the largest |difference|, the q rows that
hold them and how many keys those rows attend, l's largest relative
error and m's largest difference.  Then the causal d = 128 case's ms for
each build, from CUDA events, in the order first, second, second, first.

Run from the repository root:  ``python3 tools/k9_probe.py [--other
PATH --other-block-k N] [--time-only]`` (``--time-only``: the timing
alone).  Builds into ``dr_tpu_torch/_build/``.
"""

import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from dr_tpu_torch.ops import flash_attention as fa  # noqa: E402
from dr_tpu_torch.ops import kernels  # noqa: E402

CHUNK = 32768  # q heads per launch of the second build


def build(src_text, tag):
    digest = hashlib.sha256(src_text.encode()).hexdigest()[:12]
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    cu = kernels.BUILD / f"flash_attention_{tag}-{digest}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src_text)
    subprocess.run([kernels._nvcc(), kernels.ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(so),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.dr_flash_update.argtypes = kernels._SIGNATURES["dr_flash_update"]
    lib.dr_flash_update.restype = ctypes.c_int
    return lib


def launch(lib, q, k, v, m, l, acc, causal, chunk):
    """The C entry point over chunks of at most ``chunk`` q heads."""
    BH, s, d = q.shape
    group = BH // k.shape[0]
    outs = tuple(torch.empty_like(x) for x in (m, l, acc))
    stream = torch.cuda.current_stream().cuda_stream
    for o in range(0, BH, chunk):
        n = min(chunk, BH - o)
        kv = slice(o // group, (o + n) // group)
        args = [x.data_ptr() for x in (q[o:o + n], k[kv], v[kv], m[o:o + n],
                                       l[o:o + n], acc[o:o + n])]
        args += [x[o:o + n].data_ptr() for x in outs]
        err = lib.dr_flash_update(*args, n, s, k.shape[1], d, group, 0, 0,
                                  int(causal), stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
    return outs


def operands(gen, BH, group, s, d):
    q = torch.randn((BH, s, d), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((BH // group, s, d), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    st = (torch.full((BH, s, 1), float("-inf"), device="cuda"),
          torch.zeros((BH, s, 1), device="cuda"),
          torch.zeros((BH, s, d), device="cuda"))
    return q, k, v, st


def census(tag, got, ref, causal):
    (gm, gl, ga), (rm, rl, ra) = got, ref
    rn = ra / torch.where(rl > 0, rl, 1.0)
    diff = (ga / torch.where(gl > 0, gl, 1.0) - rn).abs()
    out = diff > 2e-3 + 2e-3 * rn.abs()
    rows = torch.unique(out.any(-1).nonzero()[:, 1])
    keys = "all" if not causal else (
        f"{int(rows.min()) + 1}-{int(rows.max()) + 1}" if rows.numel()
        else "-")
    fin = torch.isfinite(rm)
    lrel = float(((gl - rl).abs() / rl)[rl > 0].max())
    mdiff = float((gm - rm).abs()[fin].max())
    print(f"  {tag}: acc / l outside 2e-3: {int(out.sum())} of "
          f"{out.numel()}, max |diff| {float(diff.max())!r}; rows "
          f"{rows[:12].tolist()} (attending {keys} keys); l max relative "
          f"error {lrel!r}; m max |diff| {mdiff!r}", flush=True)


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


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="another flash_attention.cu")
    ap.add_argument("--other-block-k", type=int, default=0,
                    help="its key tile for the plain version (default: "
                    "the port's)")
    ap.add_argument("--time-only", action="store_true",
                    help="only the timing case, no comparisons")
    args = ap.parse_args(argv)
    src = (kernels.CSRC / "flash_attention.cu").read_text()
    if args.other:
        other, name = open(args.other).read(), "other"
    else:
        other, n = re.subn(r"exp2f\((\(.*?\)) \* LOG2E\)", r"expf\1", src)
        if n != 5:
            raise RuntimeError(f"expected 5 exp2f calls, replaced {n}")
        name = "expf"
    builds = {"this": (kernels.library("flash_update"), None, 1 << 30),
              name: (build(other, name), args.other_block_k or None, CHUNK)}
    print(f"card: {torch.cuda.get_device_name(0)}; builds {list(builds)}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = ((65536, 128, 128, True), (65536, 128, 128, False),
             (32, 16384, 256, True), (32, 32768, 128, True))
    for BH, s, d, causal in cases[-1:] if args.time_only else cases:
        print(f"BH {BH} s=skv={s} d {d} group 4 causal={causal}", flush=True)
        q, k, v, st = operands(gen, BH, 4, s, d)
        for tag, (lib, bk, chunk) in builds.items():
            if args.time_only:
                break
            ref = fa.plain_flash_update(q, k, v, *st, 0, 0, causal=causal,
                                        block_k=bk)
            got = launch(lib, q, k, v, *st, causal, chunk)
            census(tag, got, ref, causal)
            del ref, got
        if (BH, d) == (32, 128):
            times = {t: [] for t in builds}
            order = list(builds) + list(builds)[::-1]
            for tag in order:
                lib, _, chunk = builds[tag]
                times[tag].append(events_ms(lambda: launch(
                    lib, q, k, v, *st, causal, chunk), 5))
            print(f"  ms: {times}", flush=True)
        del q, k, v, st
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
